"""The yardstick's counters against hand counts at tiny shapes."""

import pytest
import torch

from benchmark.harness import work


def test_k1_work_by_hand():
    # 2 queries x 12 B + 3 vertices x 12 B + 2 ids x 8 B + 2 distances x 4 B
    assert work.k1_work(2, 3) == (24 + 36 + 16 + 8, 2 * work.K1_PAIR_OPS)


def test_touched_pixels_by_hand():
    # a 5x5 image (coordinates exact in binary); view 0: a sample at
    # pixel (1, 1) touches its 2x2 patch (1..2, 1..2), a second at
    # (1.5, 1) the same four; view 1: the corner (-1, -1) touches (0..1,
    # 0..1)
    h = w = 5
    def c(px, py):
        return [2 * px / (w - 1) - 1, 2 * py / (h - 1) - 1]
    coords = torch.tensor([[c(1, 1), c(1.5, 1)], [c(0, 0), c(0, 0)]])
    assert work.touched_pixels(coords, h, w) == 8
    # the last column's sample clamps its patch inside: (3..4, 0..1)
    assert work.touched_pixels(torch.tensor([[c(4, 0)]]), h, w) == 4


def test_k2_work_by_hand():
    v, c, n, px = 2, 3, 5, 7
    assert work.k2_fwd_work(v, c, n, px) == (4 * (7 * 3 + 2 * 5 * 2
                                                  + 2 * 3 * 5), 8 * 30)
    # image gradient only: g read (V C N), coords read, touched pixels
    # written
    assert work.k2_bwd_work(v, c, n, px, (True, False)) == (
        4 * (30 + 20 + 21), 30 * 8)
    # coords gradient only: g, coords, touched pixels read, coords written
    assert work.k2_bwd_work(v, c, n, px, (False, True)) == (
        4 * (30 + 20 + 21 + 20), 30 * 20)
    # double backward with a gg image only, for d g: coords, the gg image
    # at the touched pixels read, d g written
    assert work.k2_bwd2_work(v, c, n, px, True, False,
                             (True, False, False)) == (
        4 * (20 + 21 + 30), 30 * 7)


def test_bound_picks_the_larger():
    assert work.bound_s(work.HBM_BYTES_S, 0) == pytest.approx(1.0)
    assert work.bound_s(0, work.FLOPS_FP32 * 2) == pytest.approx(2.0)


def test_encoder_flops_by_hand():
    # an 8x8 image: the stem and the blocks at 2x2; stem 2*4*147*64, one
    # block two 3x3 64->64 convolutions 2 * 2*4*576*64
    assert work.encoder_flops(1, 8, 8, blocks=1) == \
        2 * 4 * 147 * 64 + 2 * (2 * 4 * 576 * 64)


TINY = {"views": 2, "latent": 2, "rgb_freqs": 1, "heads": 1, "dim_head": 2,
        "ff": 3, "depth": 1, "out_views": 1, "width": 4, "nerf_depth": 2,
        "skips": [0], "pts_freqs": 1, "views_width": 2}


def test_point_flops_by_hand():
    # dim = 2 + 3 + 6 = 11, inner 2; the one layer gives 1 row:
    # k, v of 2 views 2*2*11*4 = 176, q 2*11*2 = 44, logits and mix
    # 2 * 2*1*2*2 = 16, out 2*2*11 = 44, ff 2*11*3 + 2*3*11 = 132
    transformer = 176 + 44 + 16 + 44 + 132
    # MLP input 3 + 6 + 11 = 20; layer 0: 20 -> 4, then the skip 24 -> 4;
    # alpha 4 -> 1, feature 4 -> 4, views 4 + 11 -> 2, rgb 2 -> 3
    mlp = 2 * (20 * 4 + 24 * 4 + 4 + 16 + 15 * 2 + 2 * 3)
    assert work.point_flops(TINY) == transformer + mlp


def test_point_flops_mlp_against_the_counter():
    """The MLP's share of ``point_flops`` equals what PyTorch's FLOP
    counter reads on the reference's MLP at the flagship widths."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import plain

    w = {"views": 3, "latent": 128, "rgb_freqs": 4, "heads": 4,
         "dim_head": 64, "ff": 128, "depth": 2, "out_views": 2,
         "width": 256, "nerf_depth": 8, "skips": [4], "pts_freqs": 6,
         "views_width": 128}
    dim = 155
    shapes = {f"pts_linears.{i}": (256, 194 if i == 0 else
                                   (450 if i == 5 else 256))
              for i in range(8)}
    shapes.update({"alpha_linear": (1, 256), "feature_linear": (256, 256),
                   "views_linear": (128, 256 + dim), "rgb_linear": (3, 128)})
    P = {}
    for k, (o, i) in shapes.items():
        P[k + ".weight"], P[k + ".bias"] = torch.zeros(o, i), torch.zeros(o)
    n = 10
    with FlopCounterMode(display=False) as fc:
        plain.nerf_mlp(P, torch.zeros(n, 3), torch.zeros(n, dim),
                       torch.zeros(n, dim))
    no_transformer = dict(w, depth=0)
    assert fc.get_total_flops() == n * work.point_flops(no_transformer)


def test_train_step_flops():
    assert work.train_step_flops(10, 2, [(5, False), (7, True)]) == \
        3 * 10 + 3 * 2 * 5 + 6 * 2 * 7
