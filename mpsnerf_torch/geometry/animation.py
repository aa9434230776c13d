"""Mesh-anchored fast animation rendering (port of
``mpsnerf_tpu/geometry/animation.py``, the reference's
``lib/mesh_animation_renderer.py``):

  1. bake (blend weights, rgb, sigma) at the canonical mesh vertices once,
     through the model's ``"mesh_animation"`` query;
  2. per target pose: forward-LBS the mesh to world space with the baked
     weights and rasterize it from the target camera (the port's host
     rasteriser: face ids and barycentrics);
  3. at hit pixels: the interpolated surface point and weights, and
     ``m_samples`` (11) samples along the camera ray, ``interval`` (1 cm)
     apart around the hit;
  4. inverse-LBS the samples to canonical space with the interpolated
     weights, query the canonical field and composite them
     occupancy-style (an exclusive cumprod of ``1 - alpha + 1e-10``).

The warps and the queries run on the device; projection, interpolation and
compositing on the host in numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mpsnerf_torch.data import to_device_input
from mpsnerf_torch.native import rasterize_mesh
from mpsnerf_torch.ops.composite import wide_sigmoid
from mpsnerf_torch.ops.knn import kernel_buckets
from mpsnerf_torch.smpl.lbs import (
    PoseTransforms,
    _apply,
    _blend_A,
    deform_target_to_canonical_with_weights,
    inv3x3,
    smpl_to_world,
    world_to_smpl,
)
from mpsnerf_torch.smpl.model import SMPLModel


class MeshAnimationRenderer:
    """Bake once with :meth:`bake`, then :meth:`render_pose` per pose and
    camera.  The compute is injectable (the served renderer drives it
    through these hooks): ``query_fn(smpl, sp, latent, pts) -> (bweights
    (N, 24), rgb (N, 3), sigma (N,))`` raw, ``encode_fn(images) ->
    latent``; with both given ``model`` may be None and ``mean_shape``
    must be passed.  ``last_pose`` holds the last render's face ids (-1 =
    miss), hit pixels and sample points."""

    def __init__(
        self,
        model,
        smpl: SMPLModel,
        can_verts: np.ndarray,   # (V, 3) canonical mesh vertices
        tris: np.ndarray,        # (T, 3)
        m_samples: int = 11,
        interval: float = 0.01,
        chunk: int = 200_000,
        query_fn=None,
        encode_fn=None,
        mean_shape: Optional[bool] = None,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.smpl = smpl.to(self.device)
        self.can_verts = np.asarray(can_verts, np.float32)
        self.tris = np.asarray(tris, np.int32)
        self.m = m_samples
        self.interval = interval
        self.chunk = chunk
        self._baked = None
        self.last_pose: Optional[Dict] = None
        self.mean_shape = (bool(model.mean_shape) if mean_shape is None
                           else bool(mean_shape))
        if query_fn is None or encode_fn is None:
            model = model.to(self.device).eval()
        self._model = None
        if query_fn is None:
            self._model = model
            query_fn = self._model_query
        if encode_fn is None:
            encode_fn = model.encode
        self._query = query_fn
        self._encode = encode_fn

    def _model_query(self, smpl, sp, latent, pts):
        """The default ``query_fn``: the model's geometry-only query, with
        the source's 1-NN buckets built once a bake."""
        raw = self._model.query(smpl, sp, sp, latent, pts,
                                torch.zeros_like(pts),
                                t_buckets=self._t_buckets,
                                mode="mesh_animation")
        return raw.bweights, raw.rgb, raw.sigma

    def _query_host(self, pts: torch.Tensor, with_weights: bool):
        """The query over ``pts`` in chunks: host (bweights or None,
        wide_sigmoid(rgb), wide_sigmoid(sigma))."""
        bw, rgb, sig = [], [], []
        for i in range(0, pts.shape[0], self.chunk):
            b, r, s = self._query(self.smpl, self._sp, self._latent,
                                  pts[i:i + self.chunk])
            if with_weights:
                bw.append(b.cpu().numpy())
            rgb.append(wide_sigmoid(r).cpu().numpy())
            sig.append(wide_sigmoid(s).cpu().numpy())
        return (np.concatenate(bw) if with_weights else None,
                np.concatenate(rgb), np.concatenate(sig))

    def bake(self, sp_item: Dict) -> None:
        """Query blend weights, rgb and sigma at the canonical vertices."""
        with torch.no_grad():
            self._sp = to_device_input(sp_item, self.device)
            self._latent = self._encode(self._sp["img_all"])
            self._t_buckets = (kernel_buckets(self._sp["t_vertices"])
                               if self._model is not None else None)
            bw, rgb, sig = self._query_host(
                torch.from_numpy(self.can_verts).to(self.device), True)
        self._baked = {"bweights": bw, "rgb": rgb, "sigma": sig}

    def render_pose(self, tp_item: Dict, view_index: int, height: int = 512,
                    width: int = 512, fast: bool = False) -> np.ndarray:
        """The animated mesh under ``tp_item``'s pose from its camera
        ``view_index``: (height, width, 3) f32.  ``fast`` interpolates the
        baked rgb; otherwise the ``m_samples`` ray samples are
        composited."""
        assert self._baked is not None, "call bake() first"
        baked = self._baked
        with torch.no_grad():
            params = to_device_input({"params": tp_item["params"]},
                                     self.device)["params"]
            tf_t = PoseTransforms.create(self.smpl, params)
            world_verts = self._deform_with_weights(
                tf_t, baked["bweights"]).cpu().numpy()

        K = np.asarray(tp_item["K_all"][view_index])
        R = np.asarray(tp_item["R_all"][view_index])
        T = np.asarray(tp_item["T_all"][view_index]).reshape(3)
        cam = world_verts @ R.T + T
        z = cam[:, 2]
        sx = K[0, 0] * cam[:, 0] / np.maximum(z, 1e-6) + K[0, 2]
        sy = K[1, 1] * cam[:, 1] / np.maximum(z, 1e-6) + K[1, 2]
        screen = np.stack([sx, sy, z], 1).astype(np.float32)

        p2f, bary, _ = rasterize_mesh(screen, self.tris, height, width)
        hit = p2f >= 0
        img = np.zeros((height, width, 3), np.float32)
        self.last_pose = {"pix_to_face": p2f, "n_hit": int(hit.sum()),
                          "n_samples": 0}
        if not hit.any():
            return img
        face_ids = p2f[hit]
        b = bary[hit]  # (P, 3)

        def interp(attr):
            return np.einsum("mk,mkc->mc", b, attr[self.tris[face_ids]])

        if fast:
            img[hit] = interp(baked["rgb"])
            return img

        # the surface points and their blend weights
        hit_pts = interp(world_verts)
        hit_w = interp(baked["bweights"])
        origin = (-R.T @ T).reshape(3)
        ray_d = hit_pts - origin
        ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True) + 1e-12
        offs = (np.arange(self.m) - self.m // 2) * self.interval
        samples = hit_pts[None] + ray_d[None] * offs[:, None, None]  # (M,P,3)
        m, p = samples.shape[:2]
        flat = samples.reshape(-1, 3).astype(np.float32)
        w_flat = np.repeat(hit_w[None], m, axis=0).reshape(-1, 24)
        self.last_pose["n_samples"] = m * p

        with torch.no_grad():
            # world -> target SMPL space, then inverse LBS with the weights
            smpl_pts = world_to_smpl(torch.from_numpy(flat).to(self.device),
                                     tf_t.R, tf_t.Th)
            can_pts = deform_target_to_canonical_with_weights(
                self.smpl, tf_t, smpl_pts,
                torch.from_numpy(w_flat).to(self.device), self.mean_shape)
            _, rgb, alpha = self._query_host(can_pts.contiguous(), False)
        rgb = rgb.reshape(m, p, 3).transpose(1, 0, 2)
        alpha = alpha.reshape(m, p).T  # (P, M)

        # occupancy-style compositing
        trans = np.cumprod(
            np.concatenate([np.ones((p, 1)), 1 - alpha + 1e-10], 1), 1
        )[:, :-1]
        w = alpha * trans
        img[hit] = (w[..., None] * rgb).sum(1)
        return img

    def _deform_with_weights(self, tf_t: PoseTransforms, bweights):
        """Canonical mesh -> world with the per-vertex weights.  The blend
        offsets are per SMPL vertex and an extracted mesh has its own
        topology, so they are skipped (the shipped configs train with
        mean_shape 0, where the reference skips them too)."""
        bw = torch.as_tensor(bweights, device=self.device)
        pts = torch.from_numpy(self.can_verts).to(self.device)
        A_b = _blend_A(bw, tf_t.A_big)
        pts = _apply(inv3x3(A_b[:, :3, :3]), pts - A_b[:, :3, 3])
        A_s = _blend_A(bw, tf_t.A)
        smpl_pts = _apply(A_s[:, :3, :3], pts) + A_s[:, :3, 3]
        return smpl_to_world(smpl_pts, tf_t.R, tf_t.Th)
