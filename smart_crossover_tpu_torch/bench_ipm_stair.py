"""The sparse staircase LP through the single-LP device barrier on the card.

    python -m smart_crossover_tpu_torch bench --cell ipm_stair_10000x36975
        [--seed N] [--device cpu] [--oracle]

Port of ``scripts/bench_ipm_sparse_big.py``: the dominant structure of the
reference's optLP set, a multiperiod (staircase) LP,
``staircase_lp(periods=20, seed=N)``, put in standard form (10,000 rows,
36,975 columns, 168,633 nonzeros at seed 0, with free columns and
infinite upper bounds) and densified on the host, then barrier-solved by
``ipm_big``: the float32 Mehrotra stage on the card (``A D A'`` one
matmul, one Cholesky an iteration) and the float64 endgame with its
normal equations on the card (``solvers/ne_device.py``).  Steps:

1. the instance: generation and the standard form (``generate_s``), the
   dense copy of A (``densify_s``);
2. ``ipm_big(A, b, c, l, u, tol=1e-8)`` twice, each synced: ``first_s``
   then ``warm_s``;
3. the baseline, once: the host sparse barrier ``solvers/ipm.py::
   ipm_solve`` on the sparse standard form at tol 1e-8 (the IPM that
   ``solve_lp(method="barrier")`` runs).  The script has no baseline; this
   is a measurement added here, not a feature of the script;
4. with ``--oracle`` only, the oracle: scipy HiGHS on the sparse form.
   Two cuts of the script's protocol: it is off by default (minutes at
   full size), and it runs HiGHS's interior point with crossover
   (``ORACLE_METHOD``) where the script lets HiGHS choose
   (``method="highs"``), which did not finish at full size in 2300 s.

Headline: ``ipm_sparse_big_onchip`` = ``warm_s`` (the script's metric),
vs_baseline = host sparse barrier seconds / ``warm_s``.  Correct when both
solves are OPTIMAL, the device stage ran (``device_iters`` > 0) on the
row's device, the device endgame engaged (``ipm_fleet.last_ne_stats``),
the host f64 certificate on the true bounds (``lp_certificate``) is within
``CERT_TOL``, and the objective is within ``OBJ_RTOL`` (1 + |obj|) of the
host barrier's and, when the oracle runs, of HiGHS's.  ``--device cpu``
runs 2 periods of 20 rows and 60 columns on the CPU in float64, with the
device endgame asked for (``SCX_DEVICE_ENDGAME=1``; on the card the
policy's ``auto`` takes it at this size): a check of the command, not a
measurement.
"""
from __future__ import annotations

import contextlib
import os
import resource
import time

import numpy as np
import torch

from smart_crossover_tpu_torch import bench

CELL = "ipm_stair_10000x36975"
TOL = 1e-8
CERT_TOL = 1e-8         # each relative term of the host f64 certificate
OBJ_RTOL = 1e-7         # |obj - reference| <= OBJ_RTOL * (1 + |reference|)
# (periods, rows per period, columns per period, seed offset, solves,
# baseline runs)
SHAPE = (20, 500, 1700, 0, 2, 1)
CPU_SHAPE = (2, 20, 60, 0, 2, 1)
# the row's own option (``bench --oracle``)
OPTIONS = ("oracle",)
# HiGHS's interior point with crossover: a vertex in about 7 minutes at
# full size, where the script's method="highs" takes the simplex
ORACLE_METHOD = "highs-ipm"


def wide_box(b) -> float:
    """The half-width of the box the IPMs put on the infinite bound of a
    one-sided column (``solvers/ipm_batched.py``, ``ipm_fleet.py``):
    1e6 (1 + max(|b|, 1))."""
    return 1e6 * (1.0 + max(float(np.abs(b).max(initial=0.0)), 1.0))


def lp_certificate(A, b, c, l, u, x, y) -> dict:
    """Host f64 certificate of a primal-dual pair of min c'x, A x = b,
    l <= x <= u, with infinite and free bounds allowed; A dense or sparse.

    The reduced costs rc = c - A'y split into bound duals on the finite
    bounds, zl = max(rc, 0) where l is finite and zu = max(-rc, 0) where u
    is; the part of rc facing an infinite bound (rc > 0 with l = -inf,
    rc < 0 with u = +inf) is dual infeasibility.  Returns the relative
    primal residual ||A x - b|| / (1 + ||b||), the bound violation
    max(l - x, x - u, 0), the relative dual infeasibility ||rc_bad|| /
    (1 + ||c||), the relative gap |c'x - (b'y + l'zl - u'zu)| / (1 + |.| +
    |.|) and ``on_wide_box``: the columns with one infinite bound whose
    |x| reaches half the IPMs' internal box on it (``wide_box``), an
    answer of that box and not of the LP."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    b, c = np.asarray(b, np.float64), np.asarray(c, np.float64)
    l, u = np.asarray(l, np.float64), np.asarray(u, np.float64)
    lfin, ufin = np.isfinite(l), np.isfinite(u)
    pres = float(np.linalg.norm(A @ x - b) / (1.0 + np.linalg.norm(b)))
    viol = float(max(np.max(l[lfin] - x[lfin], initial=0.0),
                     np.max(x[ufin] - u[ufin], initial=0.0)))
    rc = c - A.T @ y
    zl = np.where(lfin, np.maximum(rc, 0.0), 0.0)
    zu = np.where(ufin, np.maximum(-rc, 0.0), 0.0)
    bad = np.where(~lfin & (rc > 0), rc, 0.0) \
        + np.where(~ufin & (rc < 0), rc, 0.0)
    dinf = float(np.linalg.norm(bad) / (1.0 + np.linalg.norm(c)))
    pobj = float(c @ x)
    dobj = float(b @ y + l[lfin] @ zl[lfin] - u[ufin] @ zu[ufin])
    gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
    on_box = int(np.sum((lfin != ufin) & (np.abs(x) >= 0.5 * wide_box(b))))
    return {"primal_residual": pres, "bound_violation": viol,
            "dual_infeasibility": dinf, "gap": gap, "on_wide_box": on_box,
            "primal_obj": pobj, "dual_obj": dobj}


def certificate_ok(cert: dict, tol: float = CERT_TOL) -> bool:
    return (cert["primal_residual"] <= tol and cert["bound_violation"] <= tol
            and cert["dual_infeasibility"] <= tol and cert["gap"] <= tol
            and cert["on_wide_box"] == 0)


def highs(A_sp, b, c, l, u) -> dict:
    """The oracle: scipy HiGHS (``ORACLE_METHOD``) on the sparse standard
    form."""
    from scipy.optimize import linprog

    t0 = time.perf_counter()
    ref = linprog(c, A_eq=A_sp, b_eq=b,
                  bounds=[(li if np.isfinite(li) else None,
                           ui if np.isfinite(ui) else None)
                          for li, ui in zip(l, u)],
                  method=ORACLE_METHOD)
    return {"status": int(ref.status),
            "obj": float(ref.fun) if ref.status == 0 else None,
            "s": time.perf_counter() - t0}


def close(a, ref) -> bool:
    return ref is not None and abs(a - ref) <= OBJ_RTOL * (1.0 + abs(ref))


@contextlib.contextmanager
def endgame_policy(value: str | None):
    """``SCX_DEVICE_ENDGAME`` set to ``value`` (None: left as it is) for
    the block, restored afterwards."""
    if value is None:
        yield
        return
    old = os.environ.get("SCX_DEVICE_ENDGAME")
    os.environ["SCX_DEVICE_ENDGAME"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["SCX_DEVICE_ENDGAME"]
        else:
            os.environ["SCX_DEVICE_ENDGAME"] = old


def ne_summary(stats: dict | None):
    """The device endgame's counts, with the route it took."""
    if stats is None:
        return None
    out = {k: (len(v) if k == "fails" else v) for k, v in stats.items()}
    out["route"] = "f64_direct" if stats["f64_direct"] else "f32_cg"
    return out


def run_row(cell: str, periods: int, rows: int, cols: int, seed: int,
            solves: int, n_base: int, dev: torch.device,
            oracle: bool = False) -> dict:
    """The staircase row; returns its record."""
    from smart_crossover_tpu_torch._build import (
        kernel_launch_counts,
        reset_kernel_launch_counts,
    )
    from smart_crossover_tpu_torch.data.lp_gen import staircase_lp
    from smart_crossover_tpu_torch.solvers import ipm_fleet
    from smart_crossover_tpu_torch.solvers.ipm import ipm_solve

    t0 = time.perf_counter()
    lp = staircase_lp(periods=periods, rows_per_period=rows,
                      vars_per_period=cols, seed=seed)
    A_sp = lp.get_standard_A()
    b, c = lp.b, lp.get_standard_c()
    l, u = lp.get_standard_bounds()
    generate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = A_sp.toarray()
    densify_s = time.perf_counter() - t0
    m, n = A.shape

    def solve():
        return ipm_fleet.ipm_big(A, b, c, l, u, tol=TOL, device=dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_kernel_launch_counts()
    runs = []
    with endgame_policy("1" if dev.type == "cpu" else None):
        for _ in range(solves):
            res, s = bench.synced(solve, dev)
            runs.append({"status": res.status, "obj": res.obj_val, "s": s,
                         "device_s": res.device_s,
                         "endgame_s": res.endgame_s,
                         "device_iters": res.device_iters,
                         "endgame_iters": res.endgame_iters,
                         "stragglers": ipm_fleet.last_stragglers,
                         "host_ne_forms": ipm_fleet.last_host_forms,
                         "ne_stats": ne_summary(ipm_fleet.last_ne_stats),
                         "certificate": lp_certificate(A_sp, b, c, l, u,
                                                       res.x, res.y)})
    if dev.type == "cuda":
        peak_dev = torch.cuda.max_memory_allocated(dev)

    launches = kernel_launch_counts()      # none: cuBLAS / cuSOLVER only
    t0 = time.perf_counter()
    base = ipm_solve(A_sp, b, c, l, u, tol=TOL)
    base_s = time.perf_counter() - t0
    ref = highs(A_sp, b, c, l, u) if oracle else None

    warm = runs[-1]
    row = {
        "cell": cell, "seed": seed, "instance": lp.name,
        "periods": periods, "rows_per_period": rows,
        "cols_per_period": cols, "m": m, "n": n, "nnz": int(A_sp.nnz),
        "free_columns": int(np.sum(~np.isfinite(l) & ~np.isfinite(u))),
        "infinite_lower": int(np.sum(~np.isfinite(l))),
        "infinite_upper": int(np.sum(~np.isfinite(u))),
        "generate_s": generate_s, "densify_s": densify_s,
        "first_s": runs[0]["s"], "warm_s": warm["s"], "solves": runs,
        "status": warm["status"], "obj": warm["obj"],
        "device_s": warm["device_s"], "endgame_s": warm["endgame_s"],
        "device_iters": warm["device_iters"],
        "endgame_iters": warm["endgame_iters"],
        "stragglers": warm["stragglers"], "ne_stats": warm["ne_stats"],
        "host_ne_forms": warm["host_ne_forms"],
        "device_stage_on": dev.type,
        "certificate": warm["certificate"], "certificate_tol": CERT_TOL,
        "baseline": {"method": "ipm_solve (host sparse barrier)",
                     "status": base.status, "obj": base.obj_val,
                     "iters": base.iter_count, "s": base_s},
        "obj_rel_to_baseline": abs(warm["obj"] - base.obj_val)
        / (1.0 + abs(base.obj_val)),
        "highs": ref,
        "launches": launches,
        "vs_baseline": base_s / warm["s"],
        "host_peak_rss_bytes": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
    }
    row["correct"] = bool(
        all(r["status"] == "OPTIMAL" and r["device_iters"] > 0
            and r["ne_stats"] is not None and certificate_ok(r["certificate"])
            for r in runs)
        and close(warm["obj"], base.obj_val)
        and (ref is None or close(warm["obj"], ref["obj"])))
    if dev.type == "cuda":
        row["peak_device_memory_bytes"] = peak_dev
    return row


def records(row: dict) -> list:
    """One line per step, printed before the result."""
    out = [{"ipm_stair": "instance",
            **{k: row[k] for k in ("instance", "m", "n", "nnz",
                                   "free_columns", "infinite_upper",
                                   "generate_s", "densify_s")}}]
    for i, r in enumerate(row["solves"]):
        out.append({"ipm_stair": "first" if i == 0 else "warm", **r})
    out.append({"ipm_stair": "baseline", **row["baseline"]})
    if row["highs"] is not None:
        out.append({"ipm_stair": "highs", **row["highs"]})
    return out


def result(row: dict, detail: dict) -> dict:
    return {"metric": "ipm_sparse_big_onchip", "value": row["warm_s"],
            "unit": "s", "vs_baseline": row["vs_baseline"],
            "detail": {**detail, **row}}
