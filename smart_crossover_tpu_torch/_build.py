"""Build and load the port's CUDA kernels.

The kernels live in ``csrc/*.cu`` behind a plain C interface.  At first
use they are compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library under ``BUILD_DIR``, named by a hash of the sources and flags so
that a stale library is never loaded, and bound with ``ctypes``.
``BUILD_DIR`` is ``build/smart_crossover_tpu_torch/`` beside the package in
a checkout, and the user's cache directory where that cannot be written
(an installed package); the native network simplex builds there too.
Nothing is built at import time: the CPU tests import every module on
machines without ``nvcc``.

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

PACKAGE = Path(__file__).resolve().parent
CSRC = PACKAGE / "csrc"
SOURCES = ("sinkhorn.cu", "transport_simplex_mega.cu", "pdhg_cluster.cu",
           "tree_push.cu", "certify.cu", "tree_walk.cu")


def _writable(path: Path) -> bool:
    """Whether ``path`` is, or can be made, a directory this process may
    write: the test is on its nearest existing ancestor."""
    while not path.exists():
        path = path.parent
    return path.is_dir() and os.access(path, os.W_OK | os.X_OK)


def default_build_dir(package: Path = PACKAGE) -> Path:
    """``build/smart_crossover_tpu_torch/`` beside the package in a
    checkout (the package's parent holds ``pyproject.toml``) whose build
    directory can be written; else ``$XDG_CACHE_HOME/
    smart_crossover_tpu_torch`` (``~/.cache/...`` where that is unset), as
    for an install into site-packages, which may be read-only."""
    local = package.parent / "build" / package.name
    if (package.parent / "pyproject.toml").is_file() and _writable(local):
        return local
    cache = os.environ.get("XDG_CACHE_HOME") or \
        os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / package.name


BUILD_DIR = default_build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

LAUNCHES = {"sinkhorn_fused": 0, "transport_simplex_mega": 0,
            "pdhg_chunk": 0, "halpern_chunk": 0, "pdhg_batched": 0,
            "tree_push": 0, "certify": 0, "tree_walk": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    # s, d, M, plan, f, g, B, S, D, reg, num_iters, C, n_res, stream
    "scx_sinkhorn_fused": [_P] * 6 + [_I, _I, _I, _F, _I, _I, _I, _P],
    # S, D, C, n_res -> bytes of dynamic shared memory
    "scx_sinkhorn_smem_bytes": [_I] * 4,
    # B, S, D, C, n_res -> resident clusters (or -error)
    "scx_sinkhorn_max_clusters": [_I] * 5,
    # M, N_in, mask_in, parent_in, dep_in, w_in, Xv_in, N_glob, mask_glob,
    # mask_out, parent_out, Xv_out, w_out, pot_out, stats,
    # B, S, D, C, n_smem, mask_smem, tol, max_pivots, refresh, stream
    "scx_transport_simplex_mega": [_P] * 15 + [_I] * 6 + [_F, _I, _I, _P],
    # S, D, C, n_smem, mask_smem -> bytes of dynamic shared memory
    "scx_transport_simplex_mega_smem_bytes": [_I] * 5,
    # B, S, D, C, n_smem, mask_smem -> resident clusters (or -error)
    "scx_transport_simplex_mega_max_clusters": [_I] * 6,
    # A, b, c, l, u, eq, x, y, ax, xs, ys, scal_in, scal_out, x_out, y_out,
    # ax_out, m, n, chunk, C, n_res, scatter, stream
    "scx_pdhg_chunk": [_P] * 16 + [_I] * 6 + [_P],
    # A, b, c, l, u, eq, x, y, ax, xa, ya, axa, scal_in, scal_out, x_out,
    # y_out, ax_out, m, n, chunk, C, n_res, stream
    "scx_halpern_chunk": [_P] * 17 + [_I] * 5 + [_P],
    # A, b, c, l, u, opnorms, x, y, x_avg, y_avg, B, m, n, iters, C, n_res,
    # scatter, stream
    "scx_pdhg_batched": [_P] * 10 + [_I] * 7 + [_P],
    # m, n, C, n_res -> bytes of dynamic shared memory
    "scx_pdhg_cluster_smem_bytes": [_I] * 4,
    # B, m, n, C, n_res -> resident clusters (or -error)
    "scx_pdhg_cluster_max_clusters": [_I] * 5,
    # m, n, C, n_res -> bytes of dynamic shared memory
    "scx_halpern_cluster_smem_bytes": [_I] * 4,
    # B, m, n, C, n_res -> resident clusters (or -error)
    "scx_halpern_cluster_max_clusters": [_I] * 5,
    # X, iters, scratch, B, S, D, tol, max_iter, f64, stream
    "scx_tree_push": [_P] * 3 + [_I] * 3 + [_D, _I, _I, _P],
    # S, f64 -> bytes of global scratch a block needs (0: shared memory
    # holds its cache; or -error)
    "scx_tree_push_scratch_bytes": [_I] * 2,
    # mask, M, s, d, scratch, B, S, D, f64, status, n_arcs, nums, arcs,
    # flows, stream
    "scx_certify": [_P] * 5 + [_I] * 4 + [_P] * 6,
    # S, D, f64 -> bytes of global scratch a block needs (0: shared memory
    # holds its arrays; or -error)
    "scx_certify_scratch_bytes": [_I] * 3,
    # mask, stride, s, d, scratch, B, S, D, f64, parent, X, info, stream
    "scx_tree_walk": [_P, ctypes.c_longlong] + [_P] * 3 + [_I] * 4 + [_P] * 4,
    # S, D, f64 -> bytes of global scratch a block needs (0: shared memory
    # holds its arrays; or -error)
    "scx_tree_walk_scratch_bytes": [_I] * 3,
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


def _run_all(cmds) -> str:
    """Run the commands at once; raise with the output of the first that
    fails, else return all their output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{o}")
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile the kernels if no library for the current sources exists;
    return its path.  Each source compiles in its own nvcc process, all at
    once, then one link.  The library is written under a temporary name
    and renamed, so a concurrent or interrupted build never leaves a
    partial file under the final name."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, n + ".o") for n in SOURCES]
        ptxas = ["-Xptxas", "-v"] if verbose else []
        log = _run_all([nvcc, *NVCC_FLAGS, *ptxas, "-c", str(CSRC / n),
                        "-o", o] for n, o in zip(SOURCES, objs))
        tmp = os.path.join(tmpdir, "lib.so")
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        if verbose:
            print(log)
        os.replace(tmp, out)
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
