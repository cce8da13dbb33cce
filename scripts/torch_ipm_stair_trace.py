#!/usr/bin/env python3
"""Trace one ipm_big solve of the staircase LP on a card, call by call.

    python3 scripts/torch_ipm_stair_trace.py [periods] [--seed N]

Builds ``staircase_lp(periods, seed)`` (20 periods: the
``ipm_stair_10000x36975`` row's instance), densifies it and solves it once
with ``ipm_big`` on the card, printing a timestamped line for each
``DeviceNE`` factor and solve of the endgame (with the failure record of
a solve that misses its tolerance) and for each formation of A D A' on the
host (the exact path), then the solve's status, stage split, stragglers,
peak device memory, host peak RSS, NE counts and the host f64 certificate
on the true bounds.  The row (``bench --cell ipm_stair_10000x36975``)
measures; this script shows where an endgame's time goes.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import resource
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_ipm_stair_trace: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from smart_crossover_tpu_torch.bench_ipm_stair import (
        lp_certificate,
        ne_summary,
    )
    from smart_crossover_tpu_torch.data.lp_gen import staircase_lp
    from smart_crossover_tpu_torch.solvers import ipm_fleet, ne_device

    ap = argparse.ArgumentParser()
    ap.add_argument("periods", nargs="?", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t_start = time.perf_counter()

    def log(*parts):
        print(f"[{time.perf_counter() - t_start:8.2f}]", *parts, flush=True)

    lp = staircase_lp(periods=a.periods, seed=a.seed)
    A_sp = lp.get_standard_A()
    b, c = lp.b, lp.get_standard_c()
    l, u = lp.get_standard_bounds()
    A = A_sp.toarray()
    log("instance", lp.name, A.shape, "nnz", A_sp.nnz)

    real_bmm = ipm_fleet._bmm

    def bmm(X, Y):
        t0 = time.perf_counter()
        out = real_bmm(X, Y)
        log("host A D A' formed", f"{time.perf_counter() - t0:.2f} s")
        return out

    class TracedNE(ne_device.DeviceNE):
        def factor(self, d, *args, **kw):
            t0 = time.perf_counter()
            out = super().factor(d, *args, **kw)
            log("ne factor", f"{time.perf_counter() - t0:.3f} s")
            return out

        def solve(self, rhs, matvec, *args, **kw):
            t0 = time.perf_counter()
            dy, ok = super().solve(rhs, matvec, *args, **kw)
            log("ne solve", "ok" if ok else "missed",
                f"{time.perf_counter() - t0:.3f} s",
                "" if ok else self.stats["fails"][-1])
            return dy, ok

    real_ne = ne_device.DeviceNE
    ipm_fleet._bmm = bmm
    ne_device.DeviceNE = TracedNE
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = ipm_fleet.ipm_big(A, b, c, l, u, tol=1e-8)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        ipm_fleet._bmm = real_bmm
        ne_device.DeviceNE = real_ne
    log("ipm_big", res.status, f"obj {res.obj_val!r}", f"{seconds:.2f} s",
        f"device {res.device_s:.2f} s / {res.device_iters} it",
        f"endgame {res.endgame_s:.2f} s / {res.endgame_iters} it",
        "stragglers", ipm_fleet.last_stragglers,
        "host forms", ipm_fleet.last_host_forms,
        "peak device bytes", torch.cuda.max_memory_allocated(),
        "host peak RSS bytes",
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    log("ne", ne_summary(ipm_fleet.last_ne_stats))
    log("certificate", lp_certificate(A_sp, b, c, l, u, res.x, res.y))
    return 0 if res.status == "OPTIMAL" and np.isfinite(res.obj_val) else 1


if __name__ == "__main__":
    sys.exit(main())
