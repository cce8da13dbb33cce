#!/usr/bin/env python3
"""Rehearse ipm_big's card path on the CPU, on a staircase LP.

    python3 scripts/torch_ipm_card_path_cpu.py [periods rows cols] [--seed N]
        [--baseline]

On a card, ``ipm_big`` runs its device stage in float32
(``ipm_dense_batched`` with ``ipm_fleet``'s arguments: tol 1e-5, at most
60 iterations, mu_exit 1e-4) and its float64 endgame with the normal
equations on the card (``DeviceNE``, whose f64 route the card takes).  On
the CPU ``ipm_big`` runs the stage in float64; this script runs the same
two stages as the card does instead: the stage on float32 tensors on the
CPU, then ``ipm_endgame_batched`` with a ``DeviceNE`` on the CPU.  It
prints one JSON line per stage (iterations, residuals, the endgame's NE
counts and host formations of A D A') and the host f64 certificate on
the true bounds (``bench_ipm_stair.lp_certificate``); ``--baseline`` adds
the host sparse barrier's objective.  Defaults: 4 periods of 500 rows and
1700 columns (2,000 x 7,408 in standard form; about a minute on 4
threads).  A rehearsal of control flow and float32 numerics, not a
measurement of the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    import numpy as np
    import torch

    from smart_crossover_tpu_torch.bench_ipm_stair import lp_certificate
    from smart_crossover_tpu_torch.data.lp_gen import staircase_lp
    from smart_crossover_tpu_torch.solvers import ipm_fleet, ne_device
    from smart_crossover_tpu_torch.solvers.ipm import ipm_solve
    from smart_crossover_tpu_torch.solvers.ipm_batched import (
        ipm_dense_batched,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("shape", nargs="*", type=int, default=[4, 500, 1700],
                    help="periods, rows and columns per period")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", action="store_true",
                    help="also solve with the host sparse barrier")
    a = ap.parse_args(argv)
    periods, rows, cols = a.shape
    lp = staircase_lp(periods=periods, rows_per_period=rows,
                      vars_per_period=cols, seed=a.seed)
    A_sp = lp.get_standard_A()
    b, c = lp.b, lp.get_standard_c()
    l, u = lp.get_standard_bounds()
    A = A_sp.toarray()

    def f32(v):
        return torch.as_tensor(np.asarray(v)[None], dtype=torch.float32)

    t0 = time.perf_counter()
    out = ipm_dense_batched(f32(A), f32(b), f32(c), f32(l), f32(u),
                            tol=1e-5, max_iters=60, mu_exit=1e-4,
                            device="cpu")
    dev = {k: out[k].double().numpy() for k in ("x", "y", "zl", "zu")}
    x = dev["x"][0]
    print(json.dumps({
        "stage": "device, float32 on the CPU", "instance": lp.name,
        "m": A.shape[0], "n": A.shape[1], "iters": int(out["iters"][0]),
        "converged": bool(out["converged"][0]), "obj": float(c @ x),
        "primal_residual": float(np.linalg.norm(A @ x - b)
                                 / (1 + np.linalg.norm(b))),
        "s": time.perf_counter() - t0}), flush=True)

    t0 = time.perf_counter()
    ne = ne_device.DeviceNE(A, device="cpu")
    xr, yr, _, _, conv, iters = ipm_fleet.ipm_endgame_batched(
        A[None], b[None], c[None], l[None], u[None], dev["x"], dev["y"],
        dev["zl"], dev["zu"], tol=1e-8, max_iters=30, ne_device=ne)
    print(json.dumps({
        "stage": "endgame, float64", "converged": bool(conv[0]),
        "iters": int(iters[0]), "obj": float(c @ xr[0]),
        "host_ne_forms": ipm_fleet.last_host_forms,
        "ne_stats": {k: (len(v) if k == "fails" else v)
                     for k, v in ne.stats.items()},
        "certificate": lp_certificate(A_sp, b, c, l, u, xr[0], yr[0]),
        "s": time.perf_counter() - t0}), flush=True)
    if a.baseline:
        t0 = time.perf_counter()
        base = ipm_solve(A_sp, b, c, l, u, tol=1e-8)
        print(json.dumps({"stage": "host sparse barrier",
                          "status": base.status, "obj": base.obj_val,
                          "iters": base.iter_count,
                          "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
