"""Build and load the port's CUDA kernels.

Both kernels live in ``csrc/*.cu`` behind a plain C interface.  At first
use they are compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library under ``build/smart_crossover_tpu_torch/`` beside the package,
named by a hash of the sources and flags so that a stale library is never
loaded, and bound with ``ctypes``.  Nothing here runs at import time: the
CPU tests import every module on machines without ``nvcc``.

Each kernel wrapper counts its launches in ``LAUNCHES``; a run can read
the counts to show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("sinkhorn.cu", "transport_simplex_mega.cu")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "smart_crossover_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"sinkhorn_fused": 0, "transport_simplex_mega": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # s, d, M, plan, f, g, log_s, log_d, B, S, D, reg, num_iters, stream
    "scx_sinkhorn_fused": [_P] * 8 + [_I, _I, _I, _F, _I, _P],
    # M, N_in, mask_in, parent_in, dep_in, w_in, Xv_in,
    # N_work, mask_out, parent_out, Xv_out, w_out, pot_out, stats,
    # B, S, D, tol, max_pivots, refresh, stream
    "scx_transport_simplex_mega": [_P] * 14 + [_I, _I, _I, _F, _I, _I, _P],
}

_lib = None
build_seconds = None


def _nvcc() -> str:
    """nvcc from PATH, else under $CUDA_HOME, else the toolkit's default
    install prefix."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME to "
                       "build the smart_crossover_tpu_torch kernels")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libscx_torch_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if no library for the current sources exists;
    return its path.  The library is written under a temporary name and
    renamed, so a concurrent or interrupted build never leaves a partial
    file under the final name."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, *[str(CSRC / n) for n in SOURCES]]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def kernel_launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return dict(LAUNCHES)


def reset_kernel_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
