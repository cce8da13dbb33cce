"""Native (C++) network-simplex core, built with g++ at first use.

Port of ``smart_crossover_tpu/native/__init__.py`` (``build.py`` is the
command-line entry).  The source
``netsimplex.cpp`` (a byte-for-byte copy of the JAX package's, so that the
parity tests can run both packages on one library) is compiled with the JAX
package's flags into ``build/smart_crossover_tpu_torch/`` beside the
package, under a name hashed from the source, the flags and the CPU that
``-march=native`` resolves to (so a library built on another machine is
never loaded), and bound with ``ctypes``.  The library is written under a
temporary name and renamed into place, so concurrent builds (test workers)
never load a partial file.  Nothing is built at import time.

Unlike the JAX package's loader, this one never falls back silently: where
the build or the load fails, ``library()`` raises.  Only
``network_simplex(..., use_native=False)`` selects the numpy version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from smart_crossover_tpu_torch._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "netsimplex.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
BUILD_TIMEOUT_S = 300

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int32)
# m, n, tails, heads, cost, cap, b, warm_vbasis, root, max_iter, tol,
# x_out, y_out, vbasis_out, iters_out
_ARGTYPES = [ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _f64p, _f64p,
             _f64p, _i32p, ctypes.c_int32, ctypes.c_int64, ctypes.c_double,
             _f64p, _f64p, _i32p, _i64p]

_lib = None
_lock = threading.Lock()


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: it builds the native network "
                           "simplex (or pass use_native=False)")
    return gxx


def _native_arch(gxx: str) -> str:
    """The CPU that ``-march=native`` resolves to on this machine."""
    out = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    for line in out.splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[0] == "-march=":
            return parts[1]
    return "unknown"


def library_path(gxx: str | None = None) -> Path:
    gxx = gxx or _gxx()
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_native_arch(gxx).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libscx_netsimplex_{h.hexdigest()[:16]}.so"


def build_library(timeout: float = BUILD_TIMEOUT_S) -> Path:
    """Compile the core unless a library for this source, these flags and
    this CPU exists; return its path.  Raises on a failed build."""
    gxx = _gxx()
    out = library_path(gxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        r = subprocess.run([gxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                           capture_output=True, text=True, timeout=timeout)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed ({r.returncode}) building the "
                               f"native network simplex:\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def library() -> ctypes.CDLL:
    """The loaded core (built on first use); raises where it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.scx_network_simplex.argtypes = _ARGTYPES
            lib.scx_network_simplex.restype = ctypes.c_int
            _lib = lib
    return _lib
