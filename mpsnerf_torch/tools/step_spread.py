"""How far apart one training step's gradients come out when the same
single-process step runs in different processes on one card.

    python -m mpsnerf_torch.tools.step_spread

The scene of ``chip_smoke.py``'s phase 13 (a): phase 5's 512^2 synthetic
item, the 6890-vertex rig, 1000 rays x 128 samples, the flagship widths
from seed 0 with the density bias at +4, TF32 off.  Every process runs,
under each backend setting in turn, the plain step on the item's rays and
the smooth step on its first strided half (ray 0, 2, ...), with injected
``u`` and ``delta``, from the same weights, and keeps the loss terms and
the gradients.  The processes: this one (twice: its repeat), one rank
spawned alone, and four ranks spawned together sharing the card (phase
13's placement; no collective runs).  Printed per setting and step: the
largest |diff| over every parameter over the largest |grad| (phase 13's
measure) of each process against this one, of the four ranks against
each other, and the tensor that moves most against its own max.

Settings: ``default`` (as phase 13 runs), ``channels_last`` (the input
images in channels-last strides, as a loader's transposed arrays reached
the card before ``to_device_input`` made them C order),
``cudnn_deterministic`` (``torch.backends.cudnn.deterministic`` on,
``benchmark`` off),
``no_cudnn`` (``torch.backends.cudnn.enabled`` off: the native
convolutions), ``deterministic`` (``torch.use_deterministic_algorithms
(True, warn_only=True)``).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import copy

import numpy as np

SETTINGS = ("default", "channels_last", "cudnn_deterministic", "no_cudnn",
            "deterministic")


def apply_setting(name: str) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = name != "no_cudnn"
    torch.backends.cudnn.deterministic = name == "cudnn_deterministic"
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(name == "deterministic",
                                       warn_only=True)


def scene(size: int, n_verts: int, n_rays: int, n_samples: int):
    """The item (host arrays), ``u`` for the whole item and the smooth
    step's ``delta`` for its first strided half."""
    from mpsnerf_torch.data import HOST_ONLY_KEYS, RAY_KEYS
    from mpsnerf_torch.data.synthetic import SyntheticHumanDataset

    ds = SyntheticHumanDataset(n_poses=1, n_cameras=4, image_size=size,
                               n_verts=n_verts, split="train", n_rays=n_rays)
    item = ds.get_item(0, instance_idx=0)
    item = {k: v for k, v in item.items()
            if k not in HOST_ONLY_KEYS or k in RAY_KEYS}
    rng = np.random.default_rng(13)
    u = rng.uniform(size=(n_rays, n_samples)).astype(np.float32)
    delta = (0.01 * rng.normal(size=(n_rays // 2 * n_samples, 3))
             ).astype(np.float32)
    return item, u, delta, n_verts


def steps(item, u, delta, n_verts, device="cuda"):
    """This process's ``{setting: {"plain"|"smooth": (terms, grads)}}``,
    gradients on the host."""
    import torch

    from mpsnerf_torch.data import to_device_input
    from mpsnerf_torch.models.mps_nerf import MPSNeRF
    from mpsnerf_torch.smpl.model import synthetic_smpl
    from mpsnerf_torch.train.trainer import (
        TrainConfig, make_loss_fn, train_rays,
    )

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device(device))
    torch.manual_seed(0)
    model = MPSNeRF()
    with torch.no_grad():
        model.alpha_linear.bias.fill_(4.0)
    model = model.to(dev)
    init = copy.deepcopy(model.state_dict())
    cfg = TrainConfig(n_samples=u.shape[1])
    smpl = synthetic_smpl(n_verts=n_verts, seed=0, device=dev)
    inp = to_device_input(item, dev, rays=True)
    rays = train_rays(inp, 0, dev)
    out = {}
    images = {k: v for k, v in inp.items() if k.startswith("img")}
    for name in SETTINGS:
        apply_setting(name)
        inp.update({k: v.contiguous(memory_format=torch.channels_last)
                    if name == "channels_last" else v
                    for k, v in images.items()})
        out[name] = {}
        for step, sl, uu, dd in (("plain", slice(None), u, None),
                                 ("smooth", slice(0, None, 2), u[::2],
                                  delta)):
            model.load_state_dict(init)
            model.zero_grad(set_to_none=True)
            total, (terms, _) = make_loss_fn(model, cfg, dd is not None)(
                smpl, inp, inp, *(r[sl] for r in rays),
                u=torch.from_numpy(np.ascontiguousarray(uu)).to(dev),
                delta=None if dd is None else torch.from_numpy(dd).to(dev))
            total.backward(inputs=list(model.parameters()))
            out[name][step] = (
                [float(t.detach()) for t in terms],
                {n: p.grad.detach().cpu() for n, p in
                 model.named_parameters()})
    apply_setting("default")
    return out


def gap(got, want):
    """``(max|got - want| / max|want| over every parameter, the largest
    tensor's own ratio, its name, max|term diff|)``."""
    (gt, gg), (wt, wg) = got, want
    diff = {n: float((gg[n] - wg[n]).abs().max()) for n in wg}
    top = {n: max(float(wg[n].abs().max()), 1e-30) for n in wg}
    worst = max(wg, key=lambda n: diff[n] / top[n])
    return (max(diff.values()) / max(top.values()), diff[worst] / top[worst],
            worst, float(np.max(np.abs(np.subtract(gt, wt)))))


def main(argv=None):
    import subprocess

    from mpsnerf_torch import cuda_build
    from mpsnerf_torch.parallel.launch import spawn

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--n_verts", type=int, default=6890)
    ap.add_argument("--n_rays", type=int, default=1000)
    ap.add_argument("--n_samples", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        cuda_build.build_kernels(("nearest_vertex", "grid_sample_patch"))
    case = scene(args.size, args.n_verts, args.n_rays, args.n_samples) + (
        args.device,)
    here = [steps(*case), steps(*case)]
    alone = spawn(steps, 1, case, device=args.device, timeout_s=600,
                  deadline_s=900)
    four = spawn(steps, 4, case, device=args.device, timeout_s=600,
                 deadline_s=900)
    procs = {"repeat": here[1], "alone": alone[0],
             **{f"rank{i}": r for i, r in enumerate(four)}}

    def fmt(g):
        return f"{g[0]:.3g} (worst {g[2]} {g[1]:.3g}; terms {g[3]:.3g})"

    for name in SETTINGS:
        for step in ("plain", "smooth"):
            want = here[0][name][step]
            parts = [f"{k} {fmt(gap(p[name][step], want))}"
                     for k, p in procs.items()]
            among = max(gap(four[i][name][step], four[0][name][step])[0]
                        for i in range(1, 4))
            own = gap(here[0][name][step], here[0]["default"][step])
            print(f"[spread] {name} {step}: against this process: "
                  + "; ".join(parts) + f"; the 4 ranks among themselves "
                  f"{among:.3g}; this process against its default "
                  f"{fmt(own)}", flush=True)


if __name__ == "__main__":
    main()
