#!/usr/bin/env python3
"""Time two designs of the port's Sinkhorn kernel (K1) in one process.

    git show <commit>:smart_crossover_tpu_torch/csrc/sinkhorn.cu \\
        > build/k1_old/sinkhorn.cu
    python3 scripts/torch_k1_ab.py --old build/k1_old/sinkhorn.cu [--stamps]

`--old` is a source of the streamed design (one grid per half-iteration,
M read from L2; C entry point scx_sinkhorn_fused with the argument list
below).  It is built with the package's nvcc flags into build/k1_ab/ and
run beside the package's current kernel (one thread-block cluster per
instance, M in shared memory) on chip_smoke.py's inputs: bench.py's
batches with eps = 0.005 max(M) folded into M, 1000 iterations, at
64 x 256^2 (seed 0) and 16 x 784^2 (seed 1).  Each shape: both kernels
against the plain version, then turns old, new, new, old, each the median
of --reps synced runs.  Then cluster sizes forced through the plan: C = 2
and 1 at 256^2, C in {4, 6, 7, 8, 16} at 784^2, in turns forward and back.
`--stamps` also builds the current source with -DSCX_K1_STAMPS and prints,
for each forced layout, clock64 totals per phase of rank 0 of instance 0.
One JSON line per measurement, then the card's nvidia-smi line.  Needs a
CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

from kernel_ab import REPO, build_shared, median_ms

sys.path.insert(0, str(REPO))

REG, ITERS = 0.005, 1000
PHASES = ("load", "row_half", "col_max", "barrier_a", "combine_max",
          "col_sum", "barrier_b", "combine_sum", "plan")


OUT = REPO / "build" / "k1_ab"


def build_old(src: Path) -> ctypes.CDLL:
    lib = build_shared(src, OUT / "libk1_old.so")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # s, d, M, plan, f, g, log_s, log_d, B, S, D, reg, num_iters, stream
    lib.scx_sinkhorn_fused.argtypes = [P] * 8 + [I, I, I, F, I, P]
    lib.scx_sinkhorn_fused.restype = I
    return lib


def build_stamped() -> ctypes.CDLL:
    """The current source with clock64 stamps."""
    from smart_crossover_tpu_torch import _build

    lib = build_shared(_build.CSRC / "sinkhorn.cu", OUT / "libk1_stamps.so",
                       ["-DSCX_K1_STAMPS"])
    for name, argtypes in _build._SIGNATURES.items():
        if name.startswith("scx_sinkhorn"):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.scx_sinkhorn_stamps.argtypes = [ctypes.c_void_p]
    lib.scx_sinkhorn_stamps.restype = ctypes.c_int
    return lib


def run_old(lib, s, d, Mn):
    import torch

    B, S, D = Mn.shape
    plan = torch.empty_like(Mn)
    f, log_s = torch.empty_like(s), torch.empty_like(s)
    g, log_d = torch.empty_like(d), torch.empty_like(d)
    err = lib.scx_sinkhorn_fused(
        s.data_ptr(), d.data_ptr(), Mn.data_ptr(), plan.data_ptr(),
        f.data_ptr(), g.data_ptr(), log_s.data_ptr(), log_d.data_ptr(),
        B, S, D, 1.0, ITERS, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old K1: CUDA error {err}")
    return plan, f, g


def run_stamped(lib, s, d, Mn, plan):
    """One launch of the stamped build on the plan's layout; the phase
    totals in clock cycles."""
    import torch

    B, S, D = Mn.shape
    out = torch.empty_like(Mn)
    f, g = torch.empty_like(s), torch.empty_like(d)
    err = lib.scx_sinkhorn_fused(
        s.data_ptr(), d.data_ptr(), Mn.data_ptr(), out.data_ptr(),
        f.data_ptr(), g.data_ptr(), B, S, D, 1.0, ITERS,
        plan["cluster_size"], plan["n_res"],
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"stamped K1: CUDA error {err}")
    st = (ctypes.c_longlong * len(PHASES))()
    if lib.scx_sinkhorn_stamps(ctypes.addressof(st)):
        raise RuntimeError("stamped K1: reading the stamps failed")
    return dict(zip(PHASES, list(st)))


def diff(a, p):
    """(max |df|, max |dg|, max |dplan| / max plan) of a against p."""
    return ((a[1] - p[1]).abs().max().item(),
            (a[2] - p[2]).abs().max().item(),
            (a[0] - p[0]).abs().max().item() / p[0].abs().max().item())


def main() -> int:
    import torch

    import bench
    from smart_crossover_tpu_torch.ops import sinkhorn_fused as sf

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--stamps", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_ab: no CUDA device", file=sys.stderr)
        return 2
    old = build_old(args.old)
    stamped = build_stamped() if args.stamps else None
    clock_khz = torch.cuda.get_device_properties(0).clock_rate \
        if hasattr(torch.cuda.get_device_properties(0), "clock_rate") else None

    def emit(obj):
        print(json.dumps(obj), flush=True)

    for B, S, D, seed, forced in ((64, 256, 256, 0, (2, 1)),
                                  (16, 784, 784, 1, (4, 6, 7, 8, 16))):
        s, d, M = (torch.tensor(a, dtype=torch.float32, device="cuda")
                   for a in bench.make_batch(B, S, D, seed=seed))
        Mn = (M / (REG * M.amax((1, 2)))[:, None, None]).contiguous()

        def new(C=None):
            return sf.sinkhorn_plan_fused(s, d, Mn, 1.0, ITERS,
                                          cluster_size=C)

        k, o = new(), run_old(old, s, d, Mn)
        plan = dict(sf.LAST_LAUNCH)
        p = sf.sinkhorn_plan_fused_plain(s, d, Mn, 1.0, ITERS)
        again = new()
        emit({"shape": [B, S, D], "seed": seed, "check": "vs plain",
              "new": diff(k, p), "old": diff(o, p),
              "new_repeat_bit_identical": all(
                  torch.equal(a, q) for a, q in zip(k, again)),
              "plan": {n: v for n, v in plan.items() if n != "row_ranges"}})
        turns = [("old", lambda: run_old(old, s, d, Mn)), ("new", new),
                 ("new", new), ("old", lambda: run_old(old, s, d, Mn))]
        for name, fn in turns:
            _, ms, times = median_ms(fn, args.reps)
            emit({"shape": [B, S, D], "design": name, "ms": ms,
                  "all_ms": times,
                  "cluster_size": plan["cluster_size"] if name == "new"
                  else None})
        for C in forced + forced[::-1]:
            try:
                out, ms, times = median_ms(lambda: new(C), args.reps)
            except (RuntimeError, ValueError) as e:
                emit({"shape": [B, S, D], "cluster_size": C,
                      "error": str(e)})
                continue
            lp = dict(sf.LAST_LAUNCH)
            rec = {"shape": [B, S, D], "cluster_size": C, "ms": ms, "all_ms": times, "vs_plain": diff(out, p),
                   "bit_identical_to_default": all(
                       torch.equal(a, q) for a, q in zip(out, k)),
                   **{n: lp[n] for n in ("n_res", "m_in_smem", "smem_bytes",
                                         "max_active_clusters", "waves")}}
            if stamped is not None:
                rec["stamp_cycles"] = run_stamped(stamped, s, d, Mn, lp)
                rec["sm_clock_khz"] = clock_khz
            emit(rec)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
