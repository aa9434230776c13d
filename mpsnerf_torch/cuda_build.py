"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``mpsnerf_torch/csrc/<name>.cu`` compiles for ``sm_90a`` into
``build/mpsnerf_torch/lib<name>-<hash>.so`` at the root of the checkout
(``build/`` is git-ignored).  The hash covers the source and the flags,
extra ones (a ``-D`` define) included, so an edited source rebuilds and
a variant gets a library of its own.  Nothing is built when a module is
imported: :func:`load_kernel_library` runs from the wrapper that launches
the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Dict, Iterable, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "mpsnerf_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}  # name -> nvcc/ptxas output of the build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _target(name: str, extra: Tuple[str, ...] = ()) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(NVCC_FLAGS + tuple(extra))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_kernels(names: Iterable[str], extra: Tuple[str, ...] = ()) -> None:
    """Compile every named source that has no current library, with one
    ``nvcc`` per source, all started together, adding ``extra`` to the
    flags.  Raises on a failed build with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name, extra)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)


def load_kernel_library(name: str,
                        extra: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``extra``
    flags, built first if needed."""
    key = " ".join((name,) + tuple(extra))
    lib = _LIBS.get(key)
    if lib is None:
        build_kernels([name], extra)
        lib = ctypes.CDLL(str(_target(name, extra)))
        _LIBS[key] = lib
    return lib
