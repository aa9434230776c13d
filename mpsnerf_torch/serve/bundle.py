"""Serving bundles of the port (port of ``mpsnerf_tpu/serve/bundle.py``).

The JAX bundle ships ``jax.export`` graphs so that a server skips XLA's
compiles.  The port compiles nothing per shape, so its bundle directory
holds the model as weights and the factory config that builds it:

    manifest.json   the factory config (``--model`` and the flags
                    ``factory.return_model`` reads), the request schemas,
                    the attachments the server builds, the render
                    settings, ``has_global``/``has_mesh``/``has_anim``
    weights.npz     the model's state dict
    smpl.npz        the SMPL rig arrays per gender
    warmup.npz      the export's sample items (view 0's rays only) in the
                    wire format, which :meth:`ServedRenderer.warmup` renders

Loading builds the model through ``mpsnerf_torch.factory`` and loads the
weights; no config file or checkpoint is read.  :class:`ServedRenderer`
keeps the JAX renderer's methods and behaviour: the schema validation, the
single-flight lock around device work, the bounded content-keyed item
cache (``MPSNERF_SERVE_ITEM_CACHE`` entries, default 4), ``render_view``
through ``ViewRenderer`` (the global path by default, the chunked path
with ``use_global=False``), ``render_rays``, ``render_camera``,
``render_spiral``, ``extract_mesh`` (the model without compaction, as the
JAX bundle's mesh graph) and ``animate``.  A bundle exported with
``shard_devices`` renders ``sharded=True`` requests on that many ranks in
blocks of ``shard_rays`` rays (:mod:`mpsnerf_torch.serve.sharded`); one
exported without refuses them, as the JAX renderer does.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import types
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mpsnerf_torch.data import HOST_ONLY_KEYS

__all__ = ["export_serving_bundle", "load_serving_bundle", "ServedRenderer"]

FORMAT = "mpsnerf_torch"
_MANIFEST = "manifest.json"
_WEIGHTS = "weights.npz"
_SMPL = "smpl.npz"
_WARMUP = "warmup.npz"

# the flags factory.return_model reads
FACTORY_KEYS = ("model", "num_instance", "use_trans", "append_rgb",
                "with_viewdirs", "human_sample", "mean_shape",
                "correction_field", "skinning_field", "data_set_type",
                "view_num", "compute_dtype", "compact_fraction", "use_f2d")
# items the server derives from a request's arrays (never sent)
ATTACHMENTS = ("body_grid", "spconv_plan", "t_spconv_plan")
SMPL_FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor",
               "weights", "faces")
_RAY_KEYS = ("ray_o_all", "ray_d_all", "near_all", "far_all",
             "mask_at_box_all")


def _device_keys(item: Dict) -> List[str]:
    """The request keys the device reads (not host-only, not a cache, not
    an attachment)."""
    return sorted(k for k in item if k not in HOST_ONLY_KEYS
                  and k not in ATTACHMENTS and not k.startswith("_"))


def _schema(item: Dict) -> Dict:
    out = {}
    for k in _device_keys(item):
        v = item[k]
        if isinstance(v, dict):
            out[k] = {kk: [str(np.asarray(vv).dtype), list(np.shape(vv))]
                      for kk, vv in v.items()}
        else:
            out[k] = [str(np.asarray(v).dtype), list(np.shape(v))]
    return out


def _attachments(model) -> Dict[str, List[str]]:
    """The attachments ``ViewRenderer`` builds on each side."""
    from mpsnerf_torch.models.mps_nerf import MPSNeRF

    tp = ["body_grid"] if isinstance(model, MPSNeRF) else []
    sp = []
    if getattr(model, "correction_field", False):
        plans = ["spconv_plan"] + (
            ["t_spconv_plan"] if getattr(model, "canonical_grid", False)
            else [])
        tp, sp = tp + plans, plans
    return {"tp": tp, "sp": sp}


def export_serving_bundle(
    out_dir: str,
    args,
    model,
    smpl_by_gender: Dict,   # gender int -> SMPLModel
    sp_item: Dict,
    tp_item: Dict,
    *,
    chunk: int = 4096,
    n_samples: int = 128,
    white_bkgd: bool = False,
    global_compact: bool = True,
    tile: int = 16384,
    mesh_chunk: int = 262144,
    shard_devices: int = 0,
    shard_rays_per_device: int = 4096,
) -> str:
    """Write ``model`` (built by ``factory.return_model(args)``, with
    trained weights) as a bundle.  ``sp_item``/``tp_item`` are sample items
    of the data set: they fix the request schema (keys and shapes) that
    serving validates, and their view 0 is the warm-up render.
    ``mesh_chunk`` 0 exports no mesh extraction (and no animation).
    ``shard_devices`` > 0 lets the bundle render sharded requests on that
    many ranks, in blocks of ``shard_devices * shard_rays_per_device``
    rays (the ranks start when it is served: the export needs no
    devices).  Raises when the factory config does not build a model that
    takes these weights."""
    from mpsnerf_torch import factory
    from mpsnerf_torch.models.mps_nerf import MPSNeRF
    from mpsnerf_torch.serve.server import items_to_npz_bytes

    if shard_devices < 0 or (shard_devices and (
            shard_rays_per_device <= 0 or (shard_rays_per_device > chunk
                                           and shard_rays_per_device % chunk))):
        raise ValueError(
            f"shard_devices {shard_devices}, shard_rays_per_device "
            f"{shard_rays_per_device}: a rank's shard must be at most one "
            f"chunk ({chunk}) or whole chunks")
    factory_args = {k: getattr(args, k) for k in FACTORY_KEYS}
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    factory.return_model(types.SimpleNamespace(**factory_args)
                         ).load_state_dict(state, strict=True)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, _WEIGHTS),
             **{k: v.numpy() for k, v in state.items()})

    genders = sorted(int(g) for g in smpl_by_gender)
    parents = tuple(smpl_by_gender[genders[0]].parents)
    if any(tuple(smpl_by_gender[g].parents) != parents for g in genders):
        raise ValueError("all genders must share one kinematic tree")
    np.savez(os.path.join(out_dir, _SMPL), **{
        f"{g}/{f}": getattr(smpl_by_gender[g], f).cpu().numpy()
        for g in genders for f in SMPL_FIELDS})

    mpsnerf = isinstance(model, MPSNeRF)
    has_mesh = bool(mesh_chunk and mpsnerf and "vertices" in tp_item)
    manifest = {
        "format": FORMAT,
        "format_version": 1,
        "factory_args": factory_args,
        "model_class": type(model).__name__,
        "chunk": chunk,
        "n_samples": n_samples,
        "white_bkgd": bool(white_bkgd),
        "tile": tile,
        # the global path rests on MPSNeRF's 5 cm mask (ViewRenderer)
        "has_global": bool(global_compact and mpsnerf
                           and model.human_sample),
        "has_mesh": has_mesh,
        "mesh_chunk": mesh_chunk if has_mesh else 0,
        "has_anim": bool(has_mesh and "t_vertices" in tp_item),
        "mean_shape": bool(getattr(model, "mean_shape", False)),
        "shard_devices": int(shard_devices),
        "shard_rays": int(shard_devices * shard_rays_per_device),
        "ray_axis": "ray",
        "genders": genders,
        "smpl_fields": list(SMPL_FIELDS),
        "smpl_parents": list(parents),
        "sp_schema": _schema(sp_item),
        "tp_schema": _schema(tp_item),
        "attachments": _attachments(model),
        "image_shape": list(np.shape(sp_item["img_all"])),
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)

    tp_warm = {k: tp_item[k] for k in _device_keys(tp_item)}
    tp_warm.update({k: np.asarray(tp_item[k])[:1] for k in _RAY_KEYS
                    if k in tp_item})
    with open(os.path.join(out_dir, _WARMUP), "wb") as f:
        f.write(items_to_npz_bytes(
            {k: sp_item[k] for k in _device_keys(sp_item)}, tp_warm))
    return out_dir


class ServedRenderer:
    """A loaded bundle on ``device``: validates requests, encodes sources,
    renders views, cameras and spirals, meshes and animates.  Device work
    is single-flighted under one lock (one card renders one request at a
    time; queueing is the HTTP layer's job), each call in inference mode:
    ``ThreadingHTTPServer`` runs each request on a new thread, and grad
    mode is per thread.  Sharded requests go to the bundle's ranks, one
    at a time under a lock of their own: the ranks start on the first one
    without the device lock, and render under it as well where a rank
    shares this renderer's device (:meth:`close` stops them)."""

    def __init__(self, bundle_dir: str, device="cuda"):
        from mpsnerf_torch import factory
        from mpsnerf_torch.eval.runner import ViewRenderer
        from mpsnerf_torch.smpl.model import SMPLModel

        self.dir = bundle_dir
        self.device = torch.device(device)
        with open(os.path.join(bundle_dir, _MANIFEST)) as f:
            self.manifest = m = json.load(f)
        if m.get("format") != FORMAT:
            raise ValueError(f"{bundle_dir}: not a bundle of the port "
                             f"(format {m.get('format')!r})")
        if self.device.type == "cuda":
            # fp32 products throughout, set once here (the flags are global)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.chunk = int(m["chunk"])
        self.white_bkgd = bool(m["white_bkgd"])
        self.model = factory.return_model(
            types.SimpleNamespace(**m["factory_args"]))
        with np.load(os.path.join(bundle_dir, _WEIGHTS)) as z:
            self.model.load_state_dict(
                {k: torch.from_numpy(z[k]) for k in z.files}, strict=True)
        self.model = self.model.to(self.device).eval()
        self._model_mesh = (
            self.model.with_compact_fraction(None)
            if getattr(self.model, "compact_fraction", None) is not None
            else self.model)
        with np.load(os.path.join(bundle_dir, _SMPL)) as z:
            self._smpl = {
                int(g): SMPLModel(
                    parents=tuple(m["smpl_parents"]),
                    **{f: torch.from_numpy(z[f"{g}/{f}"]).to(self.device)
                       for f in m["smpl_fields"]})
                for g in m["genders"]}
        # the global path, and the chunked path at the model's own
        # compact_fraction (a chunk that overflows it renders again
        # uncompacted), as the JAX bundle's render graphs
        self._views = {
            use_global: ViewRenderer(
                self.model, self._smpl_for, chunk=self.chunk,
                n_samples=int(m["n_samples"]), white_bkgd=self.white_bkgd,
                eval_compact_fraction=None, shuffle_rays=False,
                global_compact=use_global, tile=int(m["tile"]),
                device=self.device)
            for use_global in ((True, False) if m["has_global"]
                               else (False,))}
        self._lock = threading.Lock()
        self._cache: Dict[str, Dict] = {}
        self._cache_order: List[str] = []
        self._cache_max = int(os.environ.get("MPSNERF_SERVE_ITEM_CACHE", "4"))
        self.n_cache_hits = 0
        self.shard_devices = int(m.get("shard_devices", 0))
        self._shard_lock = threading.Lock()
        self._ranks = None  # ShardedRanks, started by the first request
        self._shard_overflows = 0

    @property
    def n_overflow_chunks(self) -> int:
        """Chunks (sharded: blocks) that overflowed their compaction and
        rendered again uncompacted."""
        return self._views[False].n_overflow_chunks + self._shard_overflows

    @property
    def shard_ranks(self):
        """The running :class:`~mpsnerf_torch.serve.sharded.ShardedRanks`,
        or None."""
        ranks = self._ranks
        return ranks if ranks is not None and ranks.alive() else None

    def on_ranks(self, fn, *args) -> List:
        """``fn(*args)`` on every rank of the sharded render (started if
        there are none; ``fn`` importable by the ranks), between requests;
        the results in rank order."""
        if self.shard_devices <= 0:
            raise ValueError("bundle was exported without shard_devices")
        with self._shard_lock:
            return self._ranks_for_request().call(fn, *args)

    def close(self) -> None:
        """Stop the sharded render's ranks (the next sharded request starts
        new ones)."""
        with self._shard_lock:
            if self._ranks is not None:
                self._ranks.close()

    def _smpl_for(self, gender: int):
        if gender not in self._smpl:
            raise ValueError(f"item gender {gender} not in bundle (has "
                             f"{sorted(self._smpl)})")
        return self._smpl[gender]

    # -- request-side schema handling and the item cache ------------------

    def _item_key(self, item: Dict, side: str) -> str:
        """Content hash of the request's device arrays (shape and dtype
        included: the same bytes in another layout must miss)."""
        h = hashlib.sha1(side.encode())
        for k in _device_keys(item):
            v = item[k]
            pairs = sorted(v.items()) if isinstance(v, dict) else [(k, v)]
            for kk, vv in pairs:
                vv = np.ascontiguousarray(vv)
                h.update(f"{k}.{kk}|{vv.dtype}|{vv.shape}".encode())
                h.update(vv.tobytes())
        return h.hexdigest()

    def _validate(self, item: Dict, side: str) -> None:
        schema = self.manifest[f"{side}_schema"]
        missing = sorted(set(schema) - set(item))
        if missing:
            raise ValueError(
                f"{side} item is missing keys {missing} required by the "
                f"bundle schema (have {sorted(item)})")
        for k, spec in schema.items():
            have = item[k]
            if isinstance(spec, dict) != isinstance(have, dict):
                raise ValueError(f"{side}[{k!r}]: wrong structure")
            pairs = ([(f"{k}.{kk}", have.get(kk), spec[kk]) for kk in spec]
                     if isinstance(spec, dict) else [(k, have, spec)])
            for name, v, (_, shape) in pairs:
                if v is None or list(np.shape(v)) != shape:
                    raise ValueError(
                        f"{side}[{name!r}]: shape "
                        f"{None if v is None else list(np.shape(v))} != "
                        f"bundle schema {shape}")

    def _prep(self, item: Dict, side: str) -> str:
        """Validate a request item and put the cached derived state of the
        same content on it (device tensors, attachments, the source's
        latent), so that a repeated actor skips the upload, the body grid
        and the encoder.  Returns its cache key (lock held)."""
        key = self._item_key(item, side)
        entry = self._cache.get(key)
        if entry is None:
            self._validate(item, side)
        else:
            self.n_cache_hits += 1
            self._cache_order.remove(key)
            self._cache_order.append(key)
            item.update(entry)
        return key

    def _keep(self, item: Dict, key: str, side: str) -> None:
        """Store the state a render left on ``item`` under ``key``: the
        side's attachments, its device tensors and latent (bounded LRU:
        each entry pins device memory; lock held)."""
        if key not in self._cache:
            self._cache_order.append(key)
        keep = self.manifest["attachments"][side] + list(
            self._views[False].DERIVED_KEYS)
        self._cache[key] = {k: item[k] for k in keep if k in item}
        while len(self._cache_order) > self._cache_max:
            self._cache.pop(self._cache_order.pop(0), None)

    @contextlib.contextmanager
    def _request(self, sp_item: Dict, tp_item: Dict):
        """One device call on a (source, target) pair: the single-flight
        lock, inference mode, the validation and the item cache."""
        with self._lock, torch.inference_mode():
            keys = [self._prep(it, side)
                    for it, side in ((sp_item, "sp"), (tp_item, "tp"))]
            yield
            for it, key, side in zip((sp_item, tp_item), keys, ("sp", "tp")):
                self._keep(it, key, side)

    def _renderer(self, use_global: Optional[bool]):
        """The global path unless ``use_global`` is False or the bundle
        has none."""
        return self._views[use_global is not False and True in self._views]

    def _ranks_for_request(self):
        """The ranks, started anew when there are none or they were closed
        (by :meth:`close`, or by a failed request) (shard lock held).  A
        rank found dead fails the request that finds it."""
        from mpsnerf_torch.serve.sharded import ShardedRanks

        if self._ranks is None or self._ranks.closed:
            self._ranks = ShardedRanks(
                self.dir, self.shard_devices, int(self.manifest["shard_rays"]),
                device="cuda" if self.device.type == "cuda" else "cpu",
                cache_max=self._cache_max)
        self._ranks.ready()
        return self._ranks

    def _ranks_share_device(self) -> bool:
        """A rank runs on this renderer's device: rank r takes
        ``cuda:{r % device_count}``, and CPU ranks share this host."""
        if self.device.type != "cuda":
            return True
        index = (self.device.index if self.device.index is not None
                 else torch.cuda.current_device())
        count = torch.cuda.device_count()
        return any(r % count == index for r in range(self.shard_devices))

    def _render_sharded(self, sp_item: Dict, tp_item: Dict, ro, rd, nr, fr
                        ) -> np.ndarray:
        """Rays (N, 3)/(N,) -> (N, 3) f32 on the bundle's ranks, in blocks
        of ``shard_rays`` rays (the rest padded with far rays).  A failed
        rank raises :class:`~mpsnerf_torch.parallel.launch.RankFailed`."""
        from mpsnerf_torch.serve.sharded import pad_rays_far

        if self.shard_devices <= 0:
            raise ValueError("bundle was exported without shard_devices")
        items, keys = {}, {}
        for item, side in ((sp_item, "sp"), (tp_item, "tp")):
            self._validate(item, side)
            keys[side] = self._item_key(item, side)
            items[side] = {k: item[k] for k in item if k in ATTACHMENTS
                           or k in _device_keys(item)}
        rays = np.concatenate(
            [np.asarray(x, np.float32).reshape(-1, w)
             for x, w in zip((ro, rd, nr, fr), (3, 3, 1, 1))], axis=1)
        n = rays.shape[0]
        if n == 0:
            return np.zeros((0, 3), np.float32)
        block = int(self.manifest["shard_rays"])
        rays = pad_rays_far(rays, -(-n // block) * block)
        with self._shard_lock:
            # the ranks start without the device lock: unsharded requests
            # go on meanwhile
            ranks = self._ranks_for_request()
            shared = self._ranks_share_device()
            with self._lock if shared else contextlib.nullcontext():
                if shared and self.device.type == "cuda":
                    # a rank renders on this card: the blocks this
                    # process's allocator keeps go back to it first
                    torch.cuda.empty_cache()
                rgb = ranks.render(keys, items, rays)
            self._shard_overflows += ranks.last["overflow_blocks"]
        return rgb[:n]

    # -- rendering --------------------------------------------------------

    def warmup(self) -> List[str]:
        """Render the bundle's sample view before serving, so that the
        kernels' build and load, the cuBLAS/cuDNN handles, the allocator's
        pools and the host mesh library are ready for the first request
        (``ViewRenderer.prewarm`` on the global path).  Returns what it
        warmed."""
        from mpsnerf_torch.serve.server import npz_bytes_to_items

        with open(os.path.join(self.dir, _WARMUP), "rb") as f:
            sp, tp, _, _, _ = npz_bytes_to_items(f.read())
        warmed = []
        with self._request(sp, tp):
            if True in self._views:
                self._views[True].prewarm(sp, tp, 0)
                warmed.append("render_global")
            # one chunk of the view on the chunked path
            first = np.zeros(np.shape(tp["ray_o_all"])[1], bool)
            first[:self.chunk] = True
            self._views[False].render_view(sp, tp, 0, first)
            warmed.append("render_chunk")
            if self.manifest["has_mesh"]:
                from mpsnerf_torch.native import extract_isosurface

                extract_isosurface(np.zeros((2, 2, 2), np.float32), 1.0)
                warmed.append("mesh_library")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return warmed

    def render_rays(self, sp_item: Dict, tp_item: Dict, ro, rd, nr, fr,
                    sharded: bool = False,
                    use_global: Optional[bool] = None) -> np.ndarray:
        """Render arbitrary rays (N, 3)/(N,) -> (N, 3) f32 (every ray runs);
        ``use_global`` False takes the chunked path; ``sharded`` the
        bundle's ranks."""
        if sharded:
            return self._render_sharded(sp_item, tp_item, ro, rd, nr, fr)
        renderer = self._renderer(use_global)
        with self._request(sp_item, tp_item):
            return renderer.render_rays(sp_item, tp_item, ro, rd, nr, fr)

    def render_view(self, sp_item: Dict, tp_item: Dict, k: int,
                    ray_mask: Optional[np.ndarray] = None,
                    sharded: bool = False,
                    use_global: Optional[bool] = None) -> np.ndarray:
        """Target view ``k`` of ``tp_item``: (H*W, 3), as
        ``ViewRenderer.render_view`` renders it (an explicit ``ray_mask``
        renders only its rays and fills the rest with 0).  ``sharded``
        renders the same rays (the body box's, or the mask's) on the
        bundle's ranks."""
        if sharded:
            from mpsnerf_torch.eval.runner import _scatter, view_rays

            views = self._views[False]
            fill = 1.0 if self.white_bkgd and ray_mask is None else 0.0
            rays, sel, n_total = view_rays(
                tp_item, k, "cpu", views._view_ray_mask(tp_item, k, ray_mask))
            rgb = self._render_sharded(sp_item, tp_item,
                                       *[x.numpy() for x in rays])
            return _scatter(rgb, sel, n_total, fill)
        renderer = self._renderer(use_global)
        with self._request(sp_item, tp_item):
            return renderer.render_view(sp_item, tp_item, k, ray_mask)

    def render_camera(self, sp_item: Dict, tp_item: Dict, K, R, T, H: int,
                      W: int, sharded: bool = False,
                      use_global: Optional[bool] = None) -> np.ndarray:
        """Render an arbitrary pinhole camera: (H*W, 3).  Rays and near/far
        as the data sets build a full image (the box of the posed vertices
        +- 5 cm, near 0 / far 1 where it is missed), in the camera's own
        precision (the JAX renderer rounds it to float32 first; the data
        sets do not), so an item's own camera gives its view bit for
        bit."""
        from mpsnerf_torch.rays.rays import get_near_far, get_rays

        ro, rd = get_rays(H, W, np.asarray(K), np.asarray(R), np.asarray(T))
        ro = ro.reshape(-1, 3).astype(np.float32)
        rd = rd.reshape(-1, 3).astype(np.float32)
        verts = np.asarray(tp_item["vertices"], np.float32)
        bounds = np.stack([verts.min(0) - 0.05, verts.max(0) + 0.05],
                          axis=0).astype(np.float32)
        near, far, hit = get_near_far(bounds, ro, rd)
        nr = np.zeros(ro.shape[0], np.float32)
        fr = np.ones(ro.shape[0], np.float32)
        nr[hit] = near
        fr[hit] = far
        return self.render_rays(sp_item, tp_item, ro, rd, nr, fr,
                                sharded=sharded, use_global=use_global)

    def render_spiral(self, sp_item: Dict, tp_item: Dict, n_frames: int = 40,
                      hw: Optional[Tuple[int, int]] = None, K=None,
                      sharded: bool = False,
                      use_global: Optional[bool] = None) -> np.ndarray:
        """Free-viewpoint video: ``n_frames`` cameras on a spiral around
        the subject (``geometry/spiral.py:gen_path`` of the item's camera
        ring).  Returns (n_frames, H, W, 3)."""
        from mpsnerf_torch.geometry.spiral import gen_path

        R_all = np.asarray(tp_item["R_all"], np.float32)
        T_all = np.asarray(tp_item["T_all"], np.float32).reshape(-1, 3, 1)
        if K is None:
            K = np.asarray(tp_item["K_all"], np.float32)[0]
        if hw is None:
            hw = tuple(self.manifest["image_shape"][-2:])
        H, W = int(hw[0]), int(hw[1])
        lower = np.array([[0.0, 0.0, 0.0, 1.0]], np.float32)
        RT = [np.concatenate([np.concatenate([R_all[i], T_all[i]], 1),
                              lower], 0) for i in range(len(R_all))]
        frames = [self.render_camera(sp_item, tp_item, K, w2c[:3, :3],
                                     w2c[:3, 3:4], H, W, sharded=sharded,
                                     use_global=use_global).reshape(H, W, 3)
                  for w2c in gen_path(RT, num_views=n_frames)]
        return np.stack(frames, axis=0)

    def extract_mesh(self, sp_item: Dict, tp_item: Dict, n: int = 256,
                     threshold: float = 30.0, pad: float = 0.1,
                     canonical: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Mesh the served subject (``geometry/extract.py``): the density
        grid of the model without compaction, the SMPL carve and marching
        cubes at ``threshold``; in the target pose's world frame, or the
        canonical big pose's (``canonical``).  Returns ``(verts (V, 3)
        f32, tris (T, 3) int32)``."""
        from mpsnerf_torch.geometry.extract import (
            GridSpec, extract_density_mesh,
        )
        from mpsnerf_torch.ops.knn import kernel_buckets

        if not self.manifest["has_mesh"]:
            raise ValueError("bundle was exported without mesh extraction")
        if canonical and not self.manifest["has_anim"]:
            raise ValueError("bundle was exported without the canonical "
                             "mesh extraction")
        verts_src = np.asarray(
            tp_item["t_vertices" if canonical else "vertices"], np.float32)
        grid = GridSpec.from_vertices(verts_src, n=n, pad=pad)
        mode = "extract_mesh" if canonical else "full"
        with self._request(sp_item, tp_item):
            smpl, sp, tp, latent = self._views[False].device_items(
                sp_item, tp_item)
            buckets = kernel_buckets(sp["t_vertices"])  # once for every chunk

            def density_fn(pts):
                return self._model_mesh.query(
                    smpl, sp, tp, latent, pts, torch.zeros_like(pts),
                    t_buckets=buckets, mode=mode).sigma

            verts, tris = extract_density_mesh(
                density_fn, grid, verts_src, smpl.faces,
                threshold=float(threshold),
                chunk=int(self.manifest["mesh_chunk"]), device=self.device)
        return verts.astype(np.float32), tris

    def animate(self, sp_item: Dict, tp_item: Dict, view_index: int = 0,
                height: int = 512, width: int = 512,
                can_verts: Optional[np.ndarray] = None,
                tris: Optional[np.ndarray] = None, mesh_n: int = 128,
                fast: bool = False, m_samples: int = 11,
                interval: float = 0.01) -> np.ndarray:
        """Mesh-anchored animation of the ``tp_item`` pose from its camera
        ``view_index`` (``geometry/animation.py``): bake at the canonical
        mesh (``can_verts``/``tris``, or one extracted here at ``mesh_n``),
        LBS, rasterize, composite ``m_samples`` samples around each hit.
        Returns (height, width, 3) f32."""
        from mpsnerf_torch.geometry.animation import MeshAnimationRenderer
        from mpsnerf_torch.ops.knn import kernel_buckets

        if not self.manifest["has_anim"]:
            raise ValueError("bundle was exported without the animation")
        if can_verts is None or tris is None:
            can_verts, tris = self.extract_mesh(sp_item, tp_item, n=mesh_n,
                                                canonical=True)
        with self._request(sp_item, tp_item):
            smpl, sp, _, latent = self._views[False].device_items(
                sp_item, tp_item)
            buckets = kernel_buckets(sp["t_vertices"])

            def query_fn(smpl_, sp_, latent_, pts):
                raw = self._model_mesh.query(
                    smpl, sp, sp, latent, pts, torch.zeros_like(pts),
                    t_buckets=buckets, mode="mesh_animation")
                return raw.bweights, raw.rgb, raw.sigma

            renderer = MeshAnimationRenderer(
                None, smpl, can_verts, tris, m_samples=m_samples,
                interval=interval, chunk=int(self.manifest["mesh_chunk"]),
                query_fn=query_fn, encode_fn=lambda images: latent,
                mean_shape=self.manifest["mean_shape"], device=self.device)
            renderer.bake({"img_all": sp_item["img_all"]})
            return renderer.render_pose(tp_item, view_index, height, width,
                                        fast=fast)


def load_serving_bundle(bundle_dir: str, device="cuda") -> ServedRenderer:
    return ServedRenderer(bundle_dir, device=device)
