"""Batched general-LP crossover: a fleet of small dense LPs.

Port of ``smart_crossover_tpu/parallel/batched_lp.py``.  The device runs
the warm start for the whole fleet: the batched Mehrotra IPM
(``solvers/ipm_batched.py``, batched normal equations and Cholesky), the
same followed by the host f64 endgame (``solvers/ipm_fleet.py``), or the
batched first-order engine (``solvers/pdhg_batched.py``, one launch of the
hand-written kernel on a CUDA card).  The host then crosses each instance
over to an exact vertex with the warm-started revised simplex, threaded
across cores.

Note on precision: in float64 (the CPU) the default tol=1e-8 converges in
8-15 IPM iterations.  In float32 (a card) the raw IPM iterate floors near
1e-5, so ``'ipm'`` reports few instances converged at tol=1e-8 and their
crossovers start cold; loosen tol to ~1e-5 or take ``'ipm_refined'``.  The
host simplex restores exactness either way.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import time

import numpy as np

from smart_crossover_tpu_torch.solvers.pdhg import _host
from smart_crossover_tpu_torch.solvers.simplex import primal_simplex
from smart_crossover_tpu_torch.solvers.solving import _crossover_statuses


def batched_lp_crossover(A, b, c, l, u, tol: float = 1e-8,
                         max_ipm_iters: int = 60,
                         warm_engine: str = "ipm",
                         pdhg_iters: int = 4000, *, device=None):
    """Solve a batch of dense equality-form LPs to exact optimal vertices.

    Args:
        A: (B, m, n) dense equality constraints; b: (B, m);
            c, l, u: (B, n) (finite/infinite bounds allowed); numpy arrays
            or tensors.
        tol, max_ipm_iters: the IPM engines' tolerance and device
            iteration cap.
        warm_engine: 'ipm' (batched Mehrotra on the device), 'ipm_refined'
            (the same device stage, then the host f64 endgame of
            ``ipm_fleet``: the sharpest warm start in float32), or 'pdhg'
            (batched first-order, two matvecs per iteration: the cheaper
            engine for wide fleets).
        pdhg_iters: fixed PDHG iterations for the whole fleet ('pdhg').
        device: where the warm start runs (default: A's device if A is a
            tensor, else the CUDA card; without one that default raises);
            the crossover always runs on the host in f64.

    Returns:
        dict with x (B, n) vertex solutions, obj (B,), pivots (B,),
        optimal (B,) bool, x_bar (B, n) warm starts, ipm_converged (B,)
        (the engine's own test; always True for 'pdhg'), device_iters (B,)
        (the warm start's device iterations), and warm_seconds /
        crossover_seconds: host clock of the synced warm start and of the
        host crossover.
    """
    t0 = time.perf_counter()
    if warm_engine == "pdhg":
        from smart_crossover_tpu_torch.solvers.pdhg_batched import (
            pdhg_dense_batched)

        dev = pdhg_dense_batched(A, b, c, l, u, iters=pdhg_iters,
                                 device=device)
        x_bar = dev["x_avg"].double().cpu().numpy()
        # a first-order point is always a usable crossover seed
        converged = np.ones(x_bar.shape[0], dtype=bool)
        device_iters = np.full(x_bar.shape[0], pdhg_iters, dtype=np.int64)
    elif warm_engine == "ipm_refined":
        from smart_crossover_tpu_torch.solvers.ipm_fleet import ipm_fleet

        fleet = ipm_fleet(A, b, c, l, u, tol=tol,
                          max_device_iters=max_ipm_iters, device=device)
        x_bar = fleet.x
        converged = np.array([s == "OPTIMAL" for s in fleet.status])
        device_iters = fleet.device_iters
    elif warm_engine == "ipm":
        from smart_crossover_tpu_torch.solvers.ipm_batched import (
            ipm_dense_batched)

        dev = ipm_dense_batched(A, b, c, l, u, tol=tol,
                                max_iters=max_ipm_iters, device=device)
        x_bar = dev["x"].double().cpu().numpy()
        converged = dev["converged"].cpu().numpy()
        device_iters = dev["iters"].cpu().numpy()
    else:
        raise ValueError(f"unknown warm_engine {warm_engine!r}: expected "
                         "'ipm', 'ipm_refined' or 'pdhg'")
    t1 = time.perf_counter()
    A, b, c, l, u = (np.asarray(_host(v), dtype=np.float64)
                     for v in (A, b, c, l, u))
    B, m, n = A.shape

    x_out = np.empty((B, n))
    obj = np.empty(B)
    pivots = np.zeros(B, dtype=np.int64)
    optimal = np.zeros(B, dtype=bool)

    def one(i: int) -> None:
        vst = None
        if converged[i]:
            vst = _crossover_statuses(x_bar[i], l[i], u[i])
        res = primal_simplex(A[i], b[i], c[i], l[i], u[i], vstatus=vst)
        x_out[i] = res.x
        obj[i] = res.obj_val
        pivots[i] = res.iter_count
        optimal[i] = res.status == "OPTIMAL"

    workers = min(max(os.cpu_count() or 1, 1), 8)
    if workers > 1 and B > 1:
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(one, range(B)))
    else:
        for i in range(B):
            one(i)
    return {"x": x_out, "obj": obj, "pivots": pivots, "optimal": optimal,
            "x_bar": x_bar, "ipm_converged": converged,
            "device_iters": device_iters, "warm_seconds": t1 - t0,
            "crossover_seconds": time.perf_counter() - t1}
