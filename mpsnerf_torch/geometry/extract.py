"""Density-grid mesh extraction (port of
``mpsnerf_tpu/geometry/extract.py``, the ``extract_thuman_mesh.py``
pipeline):

  1. a dense query grid over the subject (the target pose's world box, or
     the canonical big pose's for the canonical variant, which skips the
     warps), made on the device;
  2. chunked density queries on the device -> occupancy =
     shifted_softplus(sigma);
  3. the SMPL-distance carve on the device: occupancy beyond 5 cm of the
     body (K1, the exact 1-NN) is zeroed, and those points that lie behind
     the surface (the K=5 mean position and mean vertex normal,
     ``knn_points``) are filled solid (100), so that marching cubes closes
     the surface;
  4. the occupancy grid to the host, the iso-surface at 30 (the port's
     host mesh library), grid -> world, the triangle flip, the OBJ file.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mpsnerf_torch.native import export_obj, extract_isosurface
from mpsnerf_torch.ops.composite import shifted_softplus
from mpsnerf_torch.ops.knn import knn_points, nearest_vertex
from mpsnerf_torch.smpl.mesh import vertex_normals
from mpsnerf_torch.utils import spans

DIST_THRESHOLD_SQ = 0.05 ** 2   # the 5 cm carve
INTERIOR_FILL = 100.0           # occupancy of carved points inside the body
DEFAULT_THRESHOLD = 30.0        # the iso level


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Axis-aligned query grid: ``n[d]`` points per dim from ``start`` to
    ``start + size`` (inclusive, ``np.linspace``)."""

    start: np.ndarray  # (3,)
    size: np.ndarray   # (3,)
    n: Tuple[int, int, int]

    @staticmethod
    def from_vertices(verts: np.ndarray, n: int = 256, pad: float = 0.1):
        lo = verts.min(0) - pad
        hi = verts.max(0) + pad
        return GridSpec(start=lo, size=hi - lo, n=(n, n, n))

    @staticmethod
    def reference_target() -> "GridSpec":
        """The fixed THuman target-pose box of the reference."""
        return GridSpec(start=np.array([0.6, 0.0, 0.0]),
                        size=np.array([2.0, 2.0, 2.0]), n=(256, 256, 256))

    @staticmethod
    def reference_canonical(n: int = 256) -> "GridSpec":
        """The canonical big-pose box of the reference."""
        return GridSpec(start=np.array([-1.0, -1.0, -0.25]),
                        size=np.array([2.0, 2.0, 0.5]), n=(n, n, n // 4))

    def _axes(self):
        return [np.linspace(self.start[d], self.start[d] + self.size[d],
                            self.n[d]) for d in range(3)]

    def points(self) -> np.ndarray:
        """(N, 3) f32 grid points, x slowest (``meshgrid(indexing="ij")``)."""
        g = np.stack(np.meshgrid(*self._axes(), indexing="ij"), -1)
        return g.reshape(-1, 3).astype(np.float32)

    def points_on(self, device) -> torch.Tensor:
        """:meth:`points` made on ``device`` (the same f32 values: each
        axis is rounded from the same float64 ``linspace``)."""
        axes = [torch.from_numpy(a.astype(np.float32)).to(device)
                for a in self._axes()]
        return torch.stack(torch.meshgrid(*axes, indexing="ij"),
                           -1).reshape(-1, 3)

    def to_world(self, grid_verts: np.ndarray) -> np.ndarray:
        scale = self.size / np.asarray(self.n)
        return self.start + grid_verts * scale


@contextlib.contextmanager
def _stage(name: str, device: torch.device, stats: Optional[Dict]):
    """The span ``mesh.<name>`` over one stage; with ``stats``, recorded
    between synchronisations of the device and added to
    ``stats["<name>_ms"]``."""
    if stats is None:
        with spans.span(f"mesh.{name}"):
            yield
        return
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    with spans.recording(), spans.span(f"mesh.{name}") as s:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    stats[f"{name}_ms"] = stats.get(f"{name}_ms", 0.0) + s.ms


def carve_masks(pts: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor,
                stats: Optional[Dict] = None):
    """The carve's two masks at ``pts`` (N, 3): ``near`` (within 5 cm of
    ``verts``, by K1) and ``outside`` (in front of the mean normal of the 5
    nearest vertices).  ``stats`` gets ``mask_ms`` and ``carve_ms``."""
    with _stage("mask", pts.device, stats):
        d2, _ = nearest_vertex(pts, verts)
        near = d2 < DIST_THRESHOLD_SQ
    with _stage("carve", pts.device, stats):
        normals = vertex_normals(verts, faces)
        _, ids5 = knn_points(pts, verts, k=5)
        mean_pos = verts[ids5].mean(dim=1)
        mean_nrm = normals[ids5].mean(dim=1)
        pts_dir = pts - mean_pos
        pts_dir = pts_dir / (torch.linalg.norm(pts_dir, dim=-1, keepdim=True)
                             + 1e-12)
        outside = torch.sum(pts_dir * mean_nrm, dim=-1) > 0
    return near, outside


def occupancy_grid(
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    grid: GridSpec,
    t_vertices,
    faces,
    carve: bool = True,
    chunk: int = 1_000_000,
    device="cuda",
    stats: Optional[Dict] = None,
) -> torch.Tensor:
    """Steps 1-3: the carved occupancy at every grid point, (N,) f32 on
    ``device`` in :meth:`GridSpec.points` order.  ``density_fn``: (n, 3)
    points on ``device`` -> (n,) raw sigma.  ``stats`` gets ``density_ms``,
    ``mask_ms`` and ``carve_ms`` (the stages' spans, between
    synchronisations of the device)."""
    device = torch.device(device)
    pts = grid.points_on(device)
    with _stage("density", device, stats):
        occ = torch.empty(pts.shape[0], dtype=torch.float32, device=device)
        for i in range(0, pts.shape[0], chunk):
            occ[i:i + chunk] = shifted_softplus(density_fn(pts[i:i + chunk]))
    if carve:
        verts = torch.as_tensor(t_vertices, dtype=torch.float32,
                                device=device)
        faces = torch.as_tensor(faces, dtype=torch.int64, device=device)
        near, outside = carve_masks(pts, verts, faces, stats)
        occ = torch.where(near, occ, torch.where(
            outside, torch.zeros_like(occ), torch.full_like(occ,
                                                            INTERIOR_FILL)))
    return occ


def extract_density_mesh(
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    grid: GridSpec,
    t_vertices,
    faces,
    threshold: float = DEFAULT_THRESHOLD,
    carve: bool = True,
    chunk: int = 1_000_000,
    obj_path: Optional[str] = None,
    device="cuda",
    stats: Optional[Dict] = None,
):
    """Extract the density iso-surface.

    Args:
      density_fn: (n, 3) world or canonical points on ``device`` -> (n,)
        raw sigma (the caller picks the query mode that matches the grid).
      grid: the query grid (the world frame, or the canonical frame).
      t_vertices: the SMPL vertices in the grid's frame (posed for the
        target extraction, the canonical template for the canonical one).
      faces: the SMPL faces, for the normal sidedness test.
      stats: if given, gets each stage's ms (``density_ms``, ``mask_ms``,
        ``carve_ms``, ``mc_ms``) and ``n_points``.

    Returns ``(verts_world (V, 3), tris (T, 3))`` as numpy.
    """
    device = torch.device(device)
    occ = occupancy_grid(density_fn, grid, t_vertices, faces, carve=carve,
                         chunk=chunk, device=device, stats=stats)
    occ = occ.cpu().numpy().reshape(grid.n)
    with _stage("mc", device, stats):
        grid_verts, tris = extract_isosurface(occ, float(threshold))
        verts = grid.to_world(grid_verts)
        tris = tris[:, ::-1].copy()  # the reference's orientation flip
    if stats is not None:
        stats["n_points"] = occ.size
    if obj_path is not None:
        export_obj(obj_path, verts, tris)
    return verts, tris
