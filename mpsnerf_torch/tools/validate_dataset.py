"""First-contact validator for real THuman / H36M capture roots, through
the port (port of ``tools/validate_dataset.py``; no jax, no cv2).

It walks a dataset root and checks every layout and schema assumption
that the port's loaders (``mpsnerf_torch/data/thuman.py``, ``h36m.py``)
make, with the JAX tool's checks, names, order, PASS/FAIL lines, CLI and
exit codes, so that a first run on real data fails here with an
actionable message instead of deep inside training:

  python -m mpsnerf_torch.tools.validate_dataset --type thuman <root>
  python -m mpsnerf_torch.tools.validate_dataset --type h36m   <root>

Checks (each prints PASS/FAIL + detail):
  * annots.npy loads as a dict with cams {K, D, R, T} and ims
  * camera array shapes; per-pose image lists long enough for the 24-view
    (THuman) / 4-camera (H36M) windows
  * image + mask files exist for the first pose, at the loaders' mask
    path (``mask_cihp/<image path>`` with a ``.png`` suffix; the JAX tool
    also accepts the image's own suffix, which no loader reads), and the
    first image decodes (``data/imageio.py``: PNG, or JPEG through PIL)
  * the first mask binarizes to a plausible foreground fraction, read as
    the loaders read it (``imageio.imread``, channel 0)
  * new_vertices/<i>.npy are (6890, 3) float; new_params/<i>.npy carry
    poses(72) shapes(10) R/Rh Th
  * canonical template (X_vertices.npy / 45_big_pose_tvertices.npy)
  * SMPL pickle loading (``smpl/assets.py``) incl. the scipy-sparse
    J_regressor
  * ray invariants on one real view (``rays/rays.py``): get_near_far hits
    the body, near < far where the box is hit

Host work only (no device).  ``--poses`` is accepted, as the JAX tool's
usage line gives it, and checks the first N poses' image lists.  Exit
code: 0 all pass, 1 otherwise.  ``VALIDATE_TRACE=1`` prints a failing
check's traceback.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback
from typing import List, Optional

import numpy as np

# the layout of each data set: output views, mask directory, the params'
# rotation key, the divisor of the cameras' T, the canonical template
LAYOUTS = {
    "thuman": (24, "mask_cihp", "R", 1.0, "X_vertices.npy"),
    "h36m": (4, "mask_cihp", "Rh", 1000.0, "45_big_pose_tvertices.npy"),
}


class Checks:
    """Runs named checks, printing one PASS/FAIL line each, and keeps the
    names of those that failed."""

    def __init__(self):
        self.failures: List[str] = []

    def run(self, name: str, fn, *args) -> bool:
        try:
            detail = fn(*args)
            print(f"  PASS {name}" + (f" — {detail}" if detail else ""))
            return True
        except Exception as e:
            self.failures.append(name)
            print(f"  FAIL {name}: {type(e).__name__}: {e}")
            if os.environ.get("VALIDATE_TRACE"):
                traceback.print_exc()
            return False


def _pose_ims(annots, pose: int = 0):
    d = annots["ims"][pose]
    return d["ims"] if isinstance(d, dict) else d


def mask_path(root: str, mask_dir: str, rel: str) -> str:
    """The mask the loaders read for image ``rel`` (its suffix replaced
    by ``.png``)."""
    rel = str(rel).replace("\\", "/")
    return os.path.join(root, mask_dir, os.path.splitext(rel)[0] + ".png")


def check_annots(root):
    path = os.path.join(root, "annots.npy")
    assert os.path.isfile(path), f"missing {path}"
    annots = np.load(path, allow_pickle=True).item()
    assert isinstance(annots, dict), f"annots is {type(annots)}, not dict"
    assert "cams" in annots and "ims" in annots, sorted(annots.keys())
    return f"{len(annots['ims'])} poses"


def check_cams(annots, n_views):
    cams = annots["cams"]
    for key in ("K", "D", "R", "T"):
        assert key in cams, f"cams missing {key!r}: has {sorted(cams)}"
        arr = np.asarray(cams[key][0], np.float64)
        if key in ("K", "R"):
            assert arr.shape == (3, 3), f"cams[{key}][0].shape={arr.shape}"
        if key == "T":
            assert arr.reshape(-1).shape[0] == 3, (
                f"cams[T][0] has {arr.size} elements, expected 3")
    n = len(cams["K"])
    assert n >= n_views, f"{n} cameras < required {n_views} output views"
    return f"{n} cameras"


def check_ims(annots, n_views, n_poses):
    for pi in range(min(n_poses, len(annots["ims"]))):
        ims = _pose_ims(annots, pi)
        assert len(ims) >= n_views, (
            f"pose {pi} lists {len(ims)} images < {n_views} views")
    return None


def check_files(root, annots, mask_dir, n_views):
    from mpsnerf_torch.data import imageio

    ims = _pose_ims(annots)
    missing = []
    for rel in list(ims)[:n_views]:
        rel = str(rel).replace("\\", "/")
        img = os.path.join(root, rel)
        if not os.path.isfile(img):
            missing.append(img)
        if not os.path.isfile(mask_path(root, mask_dir, rel)):
            missing.append(mask_path(root, mask_dir, rel))
    assert not missing, f"{len(missing)} missing, first: {missing[0]}"
    first = imageio.imread(os.path.join(root, str(ims[0]).replace("\\", "/")))
    return (f"checked {min(len(ims), n_views)} views; the first image "
            f"decodes as {first.shape} {first.dtype}")


def check_mask_content(root, annots, mask_dir):
    from mpsnerf_torch.data import imageio

    msk = imageio.imread(mask_path(root, mask_dir, _pose_ims(annots)[0]))
    if msk.ndim == 3:
        msk = msk[..., 0]
    frac = float((msk != 0).mean())
    assert 0.001 < frac < 0.9, (
        f"foreground fraction {frac:.4f} implausible (mask level "
        f"conventions drifted? H36M uses values 1/100/200)")
    return (f"foreground {frac:.1%}, levels "
            f"{[int(v) for v in np.unique(msk)[:5]]}")


def check_vertices(root, frame_idx):
    path = os.path.join(root, "new_vertices", f"{frame_idx}.npy")
    assert os.path.isfile(path), f"missing {path}"
    xyz = np.load(path)
    assert xyz.shape == (6890, 3), f"shape {xyz.shape}"
    ext = xyz.max(0) - xyz.min(0)
    assert 0.3 < float(ext.max()) < 3.0, (
        f"bbox extent {ext} not human-scale metres — unit convention "
        f"drift? (H36M torch code divides T by 1000)")
    return f"extent {np.round(ext, 2)} m"


def check_params(root, frame_idx, rot_key):
    path = os.path.join(root, "new_params", f"{frame_idx}.npy")
    assert os.path.isfile(path), f"missing {path}"
    params = np.load(path, allow_pickle=True).item()
    assert isinstance(params, dict), type(params)
    for key, size in (("poses", 72), ("shapes", 10), ("Th", 3)):
        assert key in params, f"params missing {key!r}: {sorted(params)}"
        assert np.asarray(params[key]).size == size, (
            f"params[{key}] has {np.asarray(params[key]).size} elements, "
            f"expected {size}")
    assert rot_key in params, (
        f"params missing rotation {rot_key!r}: {sorted(params)}")
    rsize = np.asarray(params[rot_key]).size
    expect = 9 if rot_key == "R" else 3
    assert rsize == expect, f"params[{rot_key}] size {rsize} != {expect}"
    return f"keys {sorted(params)}"


def check_template(path):
    assert os.path.isfile(path), f"missing {path}"
    t = np.load(path)
    assert t.shape == (6890, 3), f"shape {t.shape}"
    return path


def check_smpl():
    from mpsnerf_torch.smpl.assets import load_smpl_models

    smpl = load_smpl_models(device="cpu")[2]  # neutral
    J = smpl.J_regressor.numpy()
    assert J.shape == (24, 6890), J.shape
    s = J.sum(axis=1)
    assert np.allclose(s, 1.0, atol=1e-3), (
        f"J_regressor rows sum to {s.min():.3f}..{s.max():.3f}, not 1 — "
        f"sparse-matrix densification bug?")
    return "J_regressor rows normalized"


def check_rays(root, annots, frame_idx, t_divisor):
    from mpsnerf_torch.rays.rays import get_near_far, get_rays

    xyz = np.load(os.path.join(root, "new_vertices", f"{frame_idx}.npy"))
    bounds = np.stack([xyz.min(0) - 0.05, xyz.max(0) + 0.05]).astype(
        np.float32)
    cams = annots["cams"]
    K = np.asarray(cams["K"][0], np.float32)
    R = np.asarray(cams["R"][0], np.float32)
    T = np.asarray(cams["T"][0], np.float32).reshape(3, 1) / t_divisor
    H = W = int(2 * K[1, 2])  # principal point ~ image centre
    ray_o, ray_d = get_rays(H, W, K, R, T)
    near, far, hit = get_near_far(bounds, ray_o.reshape(-1, 3).copy(),
                                  ray_d.reshape(-1, 3).copy())
    frac = hit.mean() if hit.dtype == bool else (hit > 0).mean()
    # convention drift (world-to-cam vs cam-to-world, T units) puts the
    # body behind or far outside the frustum -> hit fraction ~ 0
    assert float(frac) > 0.001, (
        f"AABB hit fraction {float(frac):.4f} implausible — camera "
        f"convention (world-to-cam vs cam-to-world, T units) drift?")
    assert np.all(near < far), "near >= far on hit rays"
    return f"hit fraction {float(frac):.1%}"


def first_frame_index(annots) -> int:
    """The loaders derive the SMPL frame from the image basename; mirror
    that."""
    base = os.path.basename(str(_pose_ims(annots)[0]).replace("\\", "/"))
    try:
        return int(os.path.splitext(base)[0])
    except ValueError:
        return 0


def main(argv: Optional[List[str]] = None) -> int:
    """Validate a root; prints the checks and returns the exit code (the
    command line exits with it)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data_root")
    ap.add_argument("--type", choices=sorted(LAYOUTS), required=True)
    ap.add_argument("--poses", type=int, default=3,
                    help="poses whose image lists are checked")
    args = ap.parse_args(argv)
    root = args.data_root
    checks = Checks()

    print(f"validating {args.type} root: {root}")
    if not checks.run("annots.npy loads and has cams/ims", check_annots,
                      root):
        return 1
    annots = np.load(os.path.join(root, "annots.npy"),
                     allow_pickle=True).item()
    n_views, mask_dir, rot_key, t_div, template = LAYOUTS[args.type]
    fi = first_frame_index(annots)
    for name, fn, *a in (
        ("camera arrays K/D/R/T shaped (V,3,3)/(V,5|4,..)/(V,3,3)/(V,3,1)",
         check_cams, annots, n_views),
        ("per-pose image lists cover the output views", check_ims, annots,
         n_views, args.poses),
        ("first-pose images + masks exist on disk", check_files, root,
         annots, mask_dir, n_views),
        ("mask binarizes to a plausible foreground fraction",
         check_mask_content, root, annots, mask_dir),
        ("new_vertices/<i>.npy is (6890, 3) float", check_vertices, root,
         fi),
        ("new_params/<i>.npy carries poses/shapes/R|Rh/Th", check_params,
         root, fi, rot_key),
        ("canonical template verts load as (6890, 3)", check_template,
         os.path.join(root, template)),
        ("SMPL pickle loads (scipy-sparse J_regressor handled)",
         check_smpl),
        ("ray invariants on one real view (get_near_far)", check_rays,
         root, annots, fi, t_div),
    ):
        checks.run(name, fn, *a)

    if checks.failures:
        print(f"\n{len(checks.failures)} check(s) FAILED: {checks.failures}")
        return 1
    print("\nall checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
