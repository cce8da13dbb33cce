"""Helpers of the kernel A/B scripts (scripts/torch_k1_ab.py,
scripts/torch_k2_ab.py): build one CUDA source into its own shared library
with the package's nvcc flags, and time a call as the median of synced
runs.  Needs a CUDA card and nvcc."""
from __future__ import annotations

import ctypes
import subprocess
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def build_shared(src: Path, out: Path, defines=()) -> ctypes.CDLL:
    """`src` compiled and linked alone into `out` (a path under the repo's
    build/), loaded."""
    from smart_crossover_tpu_torch import _build

    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-shared",
                    "-o", str(out), str(src)], check=True)
    return ctypes.CDLL(str(out))


def median_ms(fn, reps):
    """(last result, median ms, all ms) of fn() over reps, each synced."""
    import torch

    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times)), times
