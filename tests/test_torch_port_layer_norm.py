"""The view-fusion transformer's LayerNorm: the hand-written kernel
(``ops/layer_norm.py``, ``csrc/layer_norm.cu``) against ``nn.LayerNorm``
on the card, its plain version against torch's on the CPU, and the rule
by which ``PreNorm`` takes it (fp32 CUDA rows up to ``MAX_WIDTH`` wide
that autograd does not record) or ``nn.LayerNorm`` (everything else)."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from mpsnerf_torch.models import transformer
from mpsnerf_torch.models.transformer import PreNorm, autograd_records
from mpsnerf_torch.ops.layer_norm import (
    MAX_WIDTH,
    layer_norm_cuda,
    layer_norm_plain,
)
# by the test directory's own path: a machine with the card may have an
# installed package named ``tests`` that hides this one
from kernel_launches import launches  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _norm(d, seed, device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    n = nn.LayerNorm(d, eps=1e-5)
    with torch.no_grad():
        n.weight.copy_(1.0 + 0.5 * torch.randn(d, generator=g))
        n.bias.copy_(0.5 * torch.randn(d, generator=g))
    return n.to(device=device, dtype=dtype)


def _rows(shape, seed, device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    # an offset and a spread per row, as a residual stream has
    x = 3.0 * torch.randn(shape, generator=g) + torch.randn(
        shape[:-1] + (1,), generator=g)
    return x.to(device=device, dtype=dtype)


@pytest.mark.parametrize("d", [155, 128, 37, 301])
def test_the_plain_version_is_torchs_layer_norm(d):
    n = _norm(d, 1, dtype=torch.float64)
    x = _rows((4, 33, d), 2, dtype=torch.float64)
    ref = F.layer_norm(x, (d,), n.weight, n.bias, n.eps)
    out = layer_norm_plain(x, n.weight, n.bias, n.eps)
    assert torch.allclose(out, ref, rtol=1e-12, atol=1e-12)


def test_cpu_rows_take_nn_layer_norm(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel was called for CPU rows")

    monkeypatch.setattr(transformer, "layer_norm_cuda", refuse)
    pre = PreNorm(155, nn.Identity())
    with torch.no_grad():
        pre.norm.load_state_dict(_norm(155, 3).state_dict())
    x = _rows((3, 20, 155), 4)
    for ctx in (torch.no_grad, torch.inference_mode, torch.enable_grad):
        with ctx():
            assert torch.equal(pre(x), pre.norm(x))


def test_the_kernel_engages_only_where_autograd_records_nothing():
    n = _norm(155, 5)
    x = _rows((2, 155), 6)
    # a train step: the parameters require gradients
    assert autograd_records(x, n)
    with torch.no_grad():
        assert not autograd_records(x, n)
    with torch.inference_mode():
        assert not autograd_records(x, n)
    # grad mode on, but nothing to differentiate ...
    n.requires_grad_(False)
    assert not autograd_records(x, n)
    # ... until the input needs a gradient
    assert autograd_records(x.requires_grad_(True), n)


@pytest.mark.parametrize("d", [0, MAX_WIDTH + 1])
def test_the_kernel_refuses_rows_it_does_not_hold(d):
    """Before it looks at a device: the transformer takes
    ``nn.LayerNorm`` for such rows instead."""
    with pytest.raises(ValueError, match="wide"):
        layer_norm_cuda(torch.zeros(2, d), torch.ones(d), torch.zeros(d))


@pytest.mark.card
@pytest.mark.parametrize("rows", [0, 1, 3, 49152])
@pytest.mark.parametrize("d", [155, 128, 37, MAX_WIDTH])
def test_the_kernel_against_nn_layer_norm(card, d, rows, launches):
    n = _norm(d, 7, card)
    x = _rows((rows, d), 8, card)
    with torch.no_grad():
        out = layer_norm_cuda(x, n.weight, n.bias, n.eps)
        ref = n(x)
        plain = layer_norm_plain(x, n.weight, n.bias, n.eps)
    torch.cuda.synchronize()
    assert launches == ({"mpsnerf_layer_norm": 1} if rows else {})
    assert out.shape == x.shape and out.dtype == torch.float32
    if rows:
        scale = ref.abs().max()
        assert (out - ref).abs().max() <= 1e-6 * scale
        assert (out - plain).abs().max() <= 1e-6 * scale


@pytest.mark.card
def test_pre_norm_takes_the_kernel_on_the_served_path(card, monkeypatch):
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return layer_norm_cuda(*a, **k)

    monkeypatch.setattr(transformer, "layer_norm_cuda", counted)
    pre = PreNorm(155, nn.Identity()).to(card)
    x = _rows((3, 1000, 155), 9, card)
    with torch.inference_mode():
        served = pre(x)
    assert len(calls) == 1
    y = pre(x)  # grad mode on, parameters that train: nn.LayerNorm
    assert len(calls) == 1 and y.requires_grad
    assert (served - y.detach()).abs().max() <= 1e-6 * y.abs().max()


@pytest.mark.card
def test_rows_wider_than_the_kernel_take_nn_layer_norm(card, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel was called for rows it does not "
                             "hold")

    monkeypatch.setattr(transformer, "layer_norm_cuda", refuse)
    pre = PreNorm(MAX_WIDTH + 1, nn.Identity()).to(card)
    x = _rows((3, 100, MAX_WIDTH + 1), 10, card)
    with torch.inference_mode():
        assert torch.equal(pre(x), pre.norm(x))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel runs only there)")
    return torch.device("cuda")
