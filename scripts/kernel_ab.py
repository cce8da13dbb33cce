"""Helpers of the kernel A/B scripts (scripts/torch_k1_ab.py,
scripts/torch_k2_ab.py, scripts/torch_pdhg_ab.py): build one CUDA source
into its own shared library with the package's nvcc flags, report its
kernels' registers and spills and a digest of their machine code, and time
a call as the median of synced runs.  Needs a CUDA card and nvcc."""
from __future__ import annotations

import ctypes
import hashlib
import re
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


def ptxas_report(src: Path, out: Path, defines=()) -> dict:
    """Registers, stack frame and spill bytes of each kernel template
    instance in `src` (``ptxas -v``), by name, e.g.
    ``pdhg_cluster_kernel<true>``; `out` (under build/) takes the object
    file."""
    from smart_crossover_tpu_torch import _build

    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *defines,
                        "-Xptxas", "-v", "-c", "-o", str(out), str(src)],
                       capture_output=True, text=True, check=True)
    report, name = {}, None
    for line in (r.stdout + r.stderr).splitlines():
        m = re.search(r"Function properties for \S*?([a-z_]+_kernel)ILb([01])",
                      line)
        if m:
            name = f"{m.group(1)}<{'true' if m.group(2) == '1' else 'false'}>"
            report[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            report[name].update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["registers"] = int(m.group(1))
            name = None
    return report


def sass_digest(obj: Path) -> dict:
    """A digest of each kernel template instance's machine code in the
    object file `obj` (``cuobjdump -sass``, addresses and encodings left
    out), by name as in ``ptxas_report``: equal digests, equal code."""
    from smart_crossover_tpu_torch import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    r = subprocess.run([str(tool), "-sass", str(obj)], capture_output=True,
                       text=True, check=True)
    code, name = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : \S*?([a-z_]+_kernel)ILb([01])", line)
        if m:
            name = f"{m.group(1)}<{'true' if m.group(2) == '1' else 'false'}>"
            code[name] = []
            continue
        ins = re.sub(r"/\*\s*[0-9a-fx]+\s*\*/", "", line).strip()
        if name and ins:
            code[name].append(ins)
    return {k: hashlib.sha256("\n".join(v).encode()).hexdigest()[:16]
            for k, v in code.items()}


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
