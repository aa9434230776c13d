"""Build the port's CUDA kernels with ``nvcc`` at first use, load them
with ``ctypes`` and launch them.

Each ``mpsnerf_torch/csrc/<name>.cu`` compiles for ``sm_90a`` into
``build/mpsnerf_torch/lib<name>-<hash>.so`` at the root of the checkout
(``build/`` is git-ignored).  The hash covers the source and the flags,
so an edited source rebuilds.  Nothing is built when a module is
imported: :func:`launch`, the one call through which the ops modules put
a hand-written kernel on the stream, loads the library at the kernel's
first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Dict, Iterable, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "mpsnerf_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRY_POINTS: Dict[str, ctypes._CFuncPtr] = {}  # symbol -> bound function
BUILD_LOGS: Dict[str, str] = {}  # name -> nvcc/ptxas output of the build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(NVCC_FLAGS)
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_kernels(names: Iterable[str]) -> None:
    """Compile every named source that has no current library, with one
    ``nvcc`` per source, all started together.  Raises on a failed build
    with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)


def load_kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_kernels([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib


def launch(name: str, symbol: str, argtypes: Sequence, device: torch.device,
           *args) -> None:
    """Call the C entry point ``symbol`` of ``csrc/<name>.cu`` with
    ``args`` (of ``argtypes``: pointers as ints, then sizes and strides)
    and the current stream of ``device`` last; it returns a CUDA error
    code.  The symbol is bound at its first launch.  Raises RuntimeError
    naming the symbol on a non-zero return."""
    fn = _ENTRY_POINTS.get(symbol)
    if fn is None:
        fn = getattr(load_kernel_library(name), symbol)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY_POINTS[symbol] = fn
    # the raw current stream and device, without Stream objects or lazy
    # init checks: the small RGB calls are bound by this host path
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch._C._cuda_getDevice():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
