"""The weight bridge: the JAX package's variables -> the port's state dict.

Input is the JAX package's ``{"params": ..., "batch_stats": ...}`` tree as
nested dicts of numpy arrays; output is a ``state_dict`` that
``MPSNeRF.load_state_dict(strict=True)`` accepts, for every option of
the model: the encoders, the transformer, the MLP, ``latent_codes``, the
sparse 3D encoder and the deform fields (``forward_deform``,
``backward_correction``, ``backward_deform``); and for the legacy
``CorrectionF3D``, ``CorrectionUvhAgg`` and ``VanillaNeRF``, whose
variables use the same names.  It is the inverse of
``mpsnerf_tpu/compat/torch_import.py:convert_reference_state_dict``: conv
kernels HWIO -> OIHW, sparse-conv kernels (27, Cin, Cout) -> spconv's
(Cout, 3, 3, 3, Cin), Dense kernels transposed, BatchNorm scale/bias/mean/
var -> weight/bias/running_mean/running_var (``backward_correction``,
which the reference converter does not read, is carried here only).  This
module reads plain arrays only and imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _conv(k) -> torch.Tensor:  # HWIO -> OIHW
    return _tensor(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _dense(k) -> torch.Tensor:  # (in, out) -> (out, in)
    return _tensor(np.asarray(k).T)


def _linear(sd: Dict, dst: str, p: Dict):
    sd[dst + ".weight"] = _dense(p["Dense_0"]["kernel"])
    if "bias" in p["Dense_0"]:
        sd[dst + ".bias"] = _tensor(p["Dense_0"]["bias"])


def _bn(sd: Dict, dst: str, p: Dict, s: Dict):
    sd[dst + ".weight"] = _tensor(p["scale"])
    sd[dst + ".bias"] = _tensor(p["bias"])
    sd[dst + ".running_mean"] = _tensor(s["mean"])
    sd[dst + ".running_var"] = _tensor(s["var"])
    sd[dst + ".num_batches_tracked"] = torch.tensor(0)


def encoder_state_dict(params: Dict, stats: Dict, prefix: str = ""):
    """``SpatialEncoder`` variables -> state dict keys ``{prefix}model.*``."""
    sd: Dict[str, torch.Tensor] = {}
    base = prefix + "model"
    sd[base + ".conv1.weight"] = _conv(params["conv1"]["kernel"])
    _bn(sd, base + ".bn1", params["bn1"], stats["bn1"])
    for name in sorted(k for k in params if k.startswith("layer")):
        stage, block = name[len("layer"):].split("_block")
        blk = f"{base}.layer{stage}.{block}"
        bp, bs = params[name], stats[name]
        sd[blk + ".conv1.weight"] = _conv(bp["conv1"]["kernel"])
        sd[blk + ".conv2.weight"] = _conv(bp["conv2"]["kernel"])
        _bn(sd, blk + ".bn1", bp["bn1"], bs["bn1"])
        _bn(sd, blk + ".bn2", bp["bn2"], bs["bn2"])
        if "downsample_conv" in bp:
            sd[blk + ".downsample.0.weight"] = _conv(
                bp["downsample_conv"]["kernel"])
            _bn(sd, blk + ".downsample.1", bp["downsample_bn"],
                bs["downsample_bn"])
    return sd


def transformer_state_dict(params: Dict, prefix: str = ""):
    """``ViewFusionTransformer`` params -> keys ``{prefix}layers.*``."""
    sd: Dict[str, torch.Tensor] = {}
    depth = 1 + max(int(k.rsplit("_", 1)[1]) for k in params
                    if k.startswith("attn_"))
    for i in range(depth):
        base = f"{prefix}layers.{i}"
        for which, norm in (("0", f"norm_attn_{i}"), ("1", f"norm_ff_{i}")):
            sd[f"{base}.{which}.fn.norm.weight"] = _tensor(params[norm]["scale"])
            sd[f"{base}.{which}.fn.norm.bias"] = _tensor(params[norm]["bias"])
        attn = params[f"attn_{i}"]
        _linear(sd, f"{base}.0.fn.fn.to_qkv", attn["to_qkv"])
        if "to_out" in attn:
            _linear(sd, f"{base}.0.fn.fn.to_out.0", attn["to_out"])
        ff = params[f"ff_{i}"]
        _linear(sd, f"{base}.1.fn.fn.net.0", ff["fc1"])
        _linear(sd, f"{base}.1.fn.fn.net.3", ff["fc2"])
    return sd


# the JAX 3D encoder's layer names -> the reference's Sequential indices
_ENCODER_3D = (("conv0_0", "conv0.0"), ("conv0_bn0", "conv0.1"),
               ("conv0_1", "conv0.3"), ("conv0_bn1", "conv0.4"),
               ("down0", "down0.0"), ("down0_bn", "down0.1"),
               ("conv1_0", "conv1.0"), ("conv1_bn0", "conv1.1"),
               ("conv1_1", "conv1.3"), ("conv1_bn1", "conv1.4"))


def encoder_3d_state_dict(params: Dict, stats: Dict, prefix: str = ""):
    """``SparseConvNet3D`` variables -> keys ``{prefix}conv0.*`` etc."""
    sd: Dict[str, torch.Tensor] = {}
    for src, dst in _ENCODER_3D:
        if "kernel" in params[src]:
            k = np.asarray(params[src]["kernel"])          # (27, Cin, Cout)
            ci, co = k.shape[1:]
            sd[prefix + dst + ".weight"] = _tensor(np.transpose(
                k.reshape(3, 3, 3, ci, co), (4, 0, 1, 2, 3)))
        else:
            _bn(sd, prefix + dst, params[src]["BatchNorm_0"],
                stats[src]["BatchNorm_0"])
    return sd


def deform_state_dict(params: Dict, prefix: str = ""):
    """``DeformField`` params -> keys ``{prefix}pts_time_linears.{j}``,
    ``{prefix}output_linear``."""
    sd: Dict[str, torch.Tensor] = {}
    j = 0
    while f"fc{j}" in params:
        _linear(sd, f"{prefix}pts_time_linears.{j}", params[f"fc{j}"])
        j += 1
    _linear(sd, prefix + "output_linear", params["out"])
    return sd


def from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX variables -> the port's state dict, for ``MPSNeRF``,
    ``CorrectionF3D``, ``CorrectionUvhAgg`` and ``VanillaNeRF`` (which has
    no encoder, no ``batch_stats`` and, without view directions, one
    ``output_linear``)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    if "encoder_2d" in params:
        sd.update(encoder_state_dict(params["encoder_2d"],
                                     stats["encoder_2d"], "encoder_2d."))
    if "transformer" in params:
        sd.update(transformer_state_dict(params["transformer"],
                                         "transformer."))
    i = 0
    while f"pts_linear_{i}" in params:
        _linear(sd, f"pts_linears.{i}", params[f"pts_linear_{i}"])
        i += 1
    for name in ("alpha_linear", "feature_linear", "views_linear",
                 "rgb_linear", "output_linear"):
        if name in params:
            _linear(sd, name, params[name])
    if "latent_codes" in params:
        sd["latent_codes.weight"] = _tensor(params["latent_codes"]["embedding"])
    if "encoder_3d" in params:
        sd.update(encoder_3d_state_dict(params["encoder_3d"],
                                        stats["encoder_3d"], "encoder_3d."))
    for field in ("forward_deform", "backward_correction", "backward_deform"):
        if field in params:
            sd.update(deform_state_dict(params[field], field + "."))
    return sd
