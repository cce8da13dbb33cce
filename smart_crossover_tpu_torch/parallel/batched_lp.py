"""Batched general-LP crossover: a fleet of small dense LPs.

Port of ``smart_crossover_tpu/parallel/batched_lp.py``.  The device runs
the batched first-order warm start (``solvers/pdhg_batched.py``, one launch
of the hand-written kernel on a CUDA card); the host then crosses each
instance over to an exact vertex with the warm-started revised simplex,
threaded across cores.  The IPM warm engines are not ported yet (ROADMAP
1.12).
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import time

import numpy as np

from smart_crossover_tpu_torch.solvers.pdhg import _host
from smart_crossover_tpu_torch.solvers.pdhg_batched import pdhg_dense_batched
from smart_crossover_tpu_torch.solvers.simplex import primal_simplex
from smart_crossover_tpu_torch.solvers.solving import _crossover_statuses


def batched_lp_crossover(A, b, c, l, u, warm_engine: str = "pdhg",
                         pdhg_iters: int = 4000, device=None):
    """Solve a batch of dense equality-form LPs to exact optimal vertices.

    Args:
        A: (B, m, n) dense equality constraints; b: (B, m);
        c, l, u: (B, n) (finite/infinite bounds allowed); numpy arrays or
            tensors.
        warm_engine: 'pdhg', the default here (batched first-order, two
            matvecs per iteration).  The JAX package's default 'ipm' and
            its 'ipm_refined' raise NotImplementedError (ROADMAP 1.12).
        pdhg_iters: fixed PDHG iterations for the whole fleet.
        device: where the warm start runs (default: A's device if A is a
            tensor, else the CUDA card; without one that default raises);
            the crossover always runs on the host in f64.

    Returns:
        dict with x (B, n) vertex solutions, obj (B,), pivots (B,),
        optimal (B,) bool, x_bar (B, n) warm starts, ipm_converged (B,)
        (always True for the first-order engine), and warm_seconds /
        crossover_seconds: host clock of the synced device stage and of
        the host crossover.
    """
    if warm_engine != "pdhg":
        raise NotImplementedError(
            f"warm_engine={warm_engine!r} is not ported yet (ROADMAP 1.12: "
            "the IPM device stages); use warm_engine='pdhg'")
    t0 = time.perf_counter()
    dev = pdhg_dense_batched(A, b, c, l, u, iters=pdhg_iters, device=device)
    x_bar = dev["x_avg"].double().cpu().numpy()
    t1 = time.perf_counter()
    A, b, c, l, u = (np.asarray(_host(v), dtype=np.float64)
                     for v in (A, b, c, l, u))
    B, m, n = A.shape
    # a first-order point is always a usable crossover seed
    converged = np.ones(B, dtype=bool)

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
            "warm_seconds": t1 - t0,
            "crossover_seconds": time.perf_counter() - t1}
