"""Geometry of the port: density-grid mesh extraction, normal maps of a
mesh, mesh-anchored animation and spiral camera paths (port of
``mpsnerf_tpu/geometry``)."""

from mpsnerf_torch.geometry.animation import MeshAnimationRenderer
from mpsnerf_torch.geometry.extract import GridSpec, extract_density_mesh
from mpsnerf_torch.geometry.normal_render import render_normal_map
from mpsnerf_torch.geometry.spiral import gen_path, load_cam, viewmatrix

__all__ = [
    "extract_density_mesh", "GridSpec", "render_normal_map",
    "MeshAnimationRenderer", "gen_path", "load_cam", "viewmatrix",
]
