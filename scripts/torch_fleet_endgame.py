#!/usr/bin/env python3
"""Time ipm_fleet's host endgame three ways on one machine.

    python3 scripts/torch_fleet_endgame.py [B m n]    (default 64 256 512)

On chip_smoke.py's ipm_fleet instances (scripts/bench_fleet_ipm.py's
generator, seed 0) the device stage runs once on the card (CUDA, else the
CPU), then ``ipm_endgame_batched`` from its iterate: as shipped (the batch
split over min(cpu_count, 8) threads, each asking threadpoolctl for one
BLAS thread), on one thread with the batch in one numpy call, and on two
threads.  Prints whether threadpoolctl is installed (without it the
one-BLAS-thread limit is a no-op), the seconds, converged instances and
iterations of each, one JSON line each.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    import chip_smoke as cs
    from smart_crossover_tpu_torch.solvers import ipm_fleet as fm

    B, m, n = (int(a) for a in sys.argv[1:4]) if len(sys.argv) == 4 \
        else (64, 256, 512)
    try:
        import threadpoolctl
        tpc = threadpoolctl.__version__
    except ImportError:
        tpc = None
    device = "cuda" if torch.cuda.is_available() else "cpu"
    A, b, c, l, u = cs.ipm_fleet_lps(B, m, n, seed=0)
    dev = fm.ipm_dense_batched(A, b, c, l, u, tol=1e-5, max_iters=60,
                               mu_exit=1e-4 if device == "cuda" else 0.0,
                               device=device)
    start = [dev[k].double().cpu().numpy() for k in ("x", "y", "zl", "zu")]
    print(json.dumps({"cpu_count": os.cpu_count(), "threadpoolctl": tpc,
                      "device": device, "shape": [B, m, n]}), flush=True)
    real = fm._thread_map
    for name, threads in (("as_shipped", None), ("one_thread", 1),
                          ("two_threads", 2)):
        if threads is not None:
            fm._thread_map = lambda work, B_, _t=None, k=threads: real(
                work, B_, k)
        try:
            t0 = time.perf_counter()
            out = fm.ipm_endgame_batched(A, b, c, l, u, *start, tol=1e-8)
            dt = time.perf_counter() - t0
        finally:
            fm._thread_map = real
        print(json.dumps({"endgame": name, "s": dt,
                          "converged": int(out[4].sum()),
                          "iters_max": int(out[5].max())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
