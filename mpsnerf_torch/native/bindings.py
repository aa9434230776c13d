"""ctypes bindings of the port's host mesh library
(``mpsnerf_torch/csrc/mesh_native.cpp``, its own copy of the JAX package's
``native/mesh_native.cpp``; port of ``mpsnerf_tpu/native/bindings.py``):
marching cubes (``"mc"``) and marching tetrahedra (``"tet"``), the z-buffer
rasteriser with perspective-correct barycentrics, and an OBJ writer.

The library is host code: it runs on the CPU on every machine, as in the
JAX package.  It is compiled with ``g++`` at first use into
``build/mpsnerf_torch/libmesh_native-<hash>.so`` at the root of the
checkout, the way :mod:`mpsnerf_torch.cuda_build` builds the CUDA
libraries (the hash covers the source and the flags); nothing is built
when a module is imported.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

from mpsnerf_torch.cuda_build import BUILD_DIR, CSRC

GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None


def library_path():
    """The built library's path for the current source and flags."""
    src = (CSRC / "mesh_native.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmesh_native-{digest[:12]}.so"


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                ["g++", *GXX_FLAGS, str(CSRC / "mesh_native.cpp"), "-o",
                 str(tmp)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("g++ failed for mesh_native.cpp:\n"
                                   + proc.stdout + proc.stderr)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))

        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        iso_argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            f32p, ctypes.c_int, i32p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        for fn in (lib.extract_isosurface, lib.extract_isosurface_mc):
            fn.restype = ctypes.c_int
            fn.argtypes = iso_argtypes
        lib.rasterize_mesh.restype = None
        lib.rasterize_mesh.argtypes = [
            f32p, ctypes.c_int, i32p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, i32p, f32p, f32p,
        ]
        _lib = lib
        return lib


def extract_isosurface(
    grid: np.ndarray, iso: float, max_verts: int = 4_000_000,
    max_tris: int = 8_000_000, method: str = "mc",
) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface of ``grid`` (nx, ny, nz) at threshold ``iso``:
    ``method="mc"`` is marching-cubes topology (PyMCubes' vertex set: one
    linearly interpolated vertex per sign-crossing cell edge), ``"tet"``
    marching tetrahedra (the same surface, denser).  Returns ``(verts
    (V, 3) f32 in grid-index coordinates, tris (T, 3) int32)``."""
    if method not in ("mc", "tet"):
        raise ValueError(f"extract_isosurface: method {method!r}, not "
                         "'mc' or 'tet'")
    grid = np.ascontiguousarray(grid, np.float32)
    if grid.ndim != 3:
        raise ValueError(f"extract_isosurface: grid has shape {grid.shape}, "
                         "not (nx, ny, nz)")
    lib = _load()
    fn = lib.extract_isosurface_mc if method == "mc" else \
        lib.extract_isosurface
    nx, ny, nz = grid.shape
    verts = np.empty((max_verts, 3), np.float32)
    tris = np.empty((max_tris, 3), np.int32)
    nv, nt = ctypes.c_int(0), ctypes.c_int(0)
    rc = fn(grid, nx, ny, nz, iso, verts, max_verts, tris, max_tris,
            ctypes.byref(nv), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError("isosurface extraction overflowed its buffers "
                           f"({max_verts} vertices, {max_tris} triangles)")
    return verts[: nv.value].copy(), tris[: nt.value].copy()


def rasterize_mesh(
    verts_screen: np.ndarray, tris: np.ndarray, height: int, width: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Z-buffer rasterisation of ``verts_screen`` (V, 3) = (x_pix, y_pix,
    depth > 0) and ``tris`` (T, 3).  Returns ``(pix_to_face (H, W) int32,
    -1 = miss; barycentric (H, W, 3) f32, perspective-correct; zbuf (H,
    W) f32)``."""
    verts_screen = np.ascontiguousarray(verts_screen, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    if verts_screen.ndim != 2 or verts_screen.shape[1] != 3 \
            or tris.ndim != 2 or tris.shape[1] != 3:
        raise ValueError("rasterize_mesh: verts_screen and tris must be "
                         f"(V, 3) and (T, 3), not {verts_screen.shape} and "
                         f"{tris.shape}")
    if len(tris) and (tris.min() < 0 or tris.max() >= len(verts_screen)):
        raise ValueError("rasterize_mesh: a triangle indexes outside the "
                         f"{len(verts_screen)} vertices")
    lib = _load()
    p2f = np.empty(height * width, np.int32)
    bary = np.empty(height * width * 3, np.float32)
    zbuf = np.empty(height * width, np.float32)
    lib.rasterize_mesh(verts_screen, len(verts_screen), tris, len(tris),
                       height, width, p2f, bary, zbuf)
    return (p2f.reshape(height, width), bary.reshape(height, width, 3),
            zbuf.reshape(height, width))


def export_obj(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    """Minimal OBJ writer (PyMCubes' ``export_obj``): ``v x y z`` lines,
    then 1-based ``f a b c`` lines; the JAX package's bytes (each number as
    numpy prints it; float64 rows go through Python floats, which print
    the same and faster)."""
    verts = np.asarray(verts)
    with open(path, "w") as f:
        if verts.dtype == np.float64:
            f.writelines(f"v {a} {b} {c}\n" for a, b, c in verts.tolist())
        else:
            for v in verts:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n"
                     for a, b, c in np.asarray(tris).tolist())


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The ``v`` and ``f`` lines of an OBJ file (the mesh CLIs' reader):
    ``(verts (V, 3) f32, tris (T, 3) int32)``, 0-based; the first three
    numbers of each line (a face's vertex index before any ``/``), read
    as float64 and rounded to float32 like the JAX CLI's reader."""
    with open(path) as f:
        lines = f.read().splitlines()
    rows = {kind: [line[2:] for line in lines if line.startswith(kind)]
            for kind in ("v ", "f ")}
    out = []
    for kind, dtype in (("v ", np.float64), ("f ", np.int64)):
        tokens = " ".join(rows[kind]).split()
        if len(tokens) == 3 * len(rows[kind]) and "/" not in "".join(tokens):
            arr = np.array(tokens, dtype).reshape(-1, 3)
        else:  # longer rows, or v/vt/vn face indices
            arr = np.array([[t.split("/")[0] for t in r.split()[:3]]
                            for r in rows[kind]], dtype).reshape(-1, 3)
        out.append(arr)
    return out[0].astype(np.float32), (out[1] - 1).astype(np.int32)
