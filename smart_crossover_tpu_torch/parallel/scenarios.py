"""Scenario sweeps: one network or LP, many demand/cost scenarios.

Port of ``smart_crossover_tpu/parallel/scenarios.py``.  ``mcf_scenario_sweep``
re-solves one min-cost-flow network across a batch of scenarios with the
native network simplex on the host, each warm-started from the previous
optimal basis.  ``lp_scenario_sweep`` runs one dense LP's scenarios as a
fleet barrier solve (``solvers/ipm_fleet.py``), optionally sharded over a
mesh, or crossed over to exact vertices (``batched_lp_crossover``).
"""
from __future__ import annotations

import datetime
import time

import numpy as np

from smart_crossover_tpu_torch.models import MinCostFlow
from smart_crossover_tpu_torch.solvers.network_simplex import network_simplex


def mcf_scenario_sweep(mcf: MinCostFlow,
                       b_scenarios: np.ndarray | None = None,
                       c_scenarios: np.ndarray | None = None,
                       warm_chain: bool = True):
    """Solve a family of MCFs sharing the arc structure.

    Args:
        mcf: the base instance (its b/c are scenario 0 defaults).
        b_scenarios: optional (K, m) demand vectors (each summing to 0).
        c_scenarios: optional (K, n) cost vectors.
        warm_chain: warm-start each scenario from the previous basis.

    Returns:
        dict with x (K, n), obj (K,), pivots (K,), status (list), runtime.
    """
    t0 = time.perf_counter()
    K = None
    if b_scenarios is not None:
        b_scenarios = np.asarray(b_scenarios, dtype=np.float64)
        K = b_scenarios.shape[0]
    if c_scenarios is not None:
        c_scenarios = np.asarray(c_scenarios, dtype=np.float64)
        K = c_scenarios.shape[0] if K is None else K
        if b_scenarios is not None and c_scenarios.shape[0] != K:
            raise ValueError("b_scenarios and c_scenarios disagree on K")
    if K is None:
        raise ValueError("provide b_scenarios and/or c_scenarios")

    x = np.empty((K, mcf.n))
    obj = np.empty(K)
    pivots = np.empty(K, dtype=np.int64)
    statuses = []
    basis = None
    for k in range(K):
        inst = MinCostFlow(
            tails=mcf.tails, heads=mcf.heads,
            c=c_scenarios[k] if c_scenarios is not None else mcf.c,
            u=mcf.u,
            b=b_scenarios[k] if b_scenarios is not None else mcf.b,
            name=f"{mcf.name}_scen{k}")
        res = network_simplex(inst, warm_basis=basis if warm_chain else None)
        x[k] = res.x
        obj[k] = res.obj_val
        pivots[k] = res.iter_count
        statuses.append(res.status)
        if warm_chain and res.status == "OPTIMAL":
            basis = res.basis
    return {"x": x, "obj": obj, "pivots": pivots, "status": statuses,
            "runtime": datetime.timedelta(seconds=time.perf_counter() - t0)}


def lp_scenario_sweep(A, b, c, l, u,
                      b_scenarios: np.ndarray | None = None,
                      c_scenarios: np.ndarray | None = None,
                      tol: float = 1e-8, exact_vertices: bool = False,
                      mesh=None, *, device=None):
    """Solve one LP under a batch of RHS and/or cost scenarios.

    Every scenario shares A, so the sweep runs as ONE fleet barrier solve
    (device batched IPM + f64 host endgame, ``solvers/ipm_fleet.py``);
    with ``exact_vertices=True`` each scenario is instead crossed over to
    an exact optimal vertex (``batched_lp_crossover(warm_engine=
    "ipm_refined")``, unsharded, as in the JAX package).

    Args:
        A: (m, n) dense; b: (m,); c, l, u: (n,) base data.
        b_scenarios: optional (K, m) RHS scenarios.
        c_scenarios: optional (K, n) cost scenarios.
        mesh: optional ``parallel.make_mesh`` mesh: the fleet's device
            stage is sharded over it (``ipm_fleet(mesh=)``; K divisible by
            its 'batch' width); every rank calls with the same data.
        device: as in ``ipm_fleet`` (default: the mesh's device, else the
            CUDA card).

    Returns:
        dict with x (K, n), obj (K,), status (list), runtime; plus
        pivots/optimal when ``exact_vertices``.
    """
    t0 = time.perf_counter()
    A = np.asarray(A, dtype=np.float64)
    m, n = A.shape
    K = None
    if b_scenarios is not None:
        b_scenarios = np.asarray(b_scenarios, dtype=np.float64)
        K = b_scenarios.shape[0]
    if c_scenarios is not None:
        c_scenarios = np.asarray(c_scenarios, dtype=np.float64)
        K = c_scenarios.shape[0] if K is None else K
        if b_scenarios is not None and c_scenarios.shape[0] != K:
            raise ValueError("scenario batch sizes disagree")
    if K is None:
        raise ValueError("provide b_scenarios and/or c_scenarios")

    Ab = np.broadcast_to(A, (K, m, n))
    bb = (b_scenarios if b_scenarios is not None
          else np.broadcast_to(np.asarray(b, np.float64), (K, m)))
    cb = (c_scenarios if c_scenarios is not None
          else np.broadcast_to(np.asarray(c, np.float64), (K, n)))
    lb = np.broadcast_to(np.asarray(l, np.float64), (K, n))
    ub = np.broadcast_to(np.asarray(u, np.float64), (K, n))

    if exact_vertices:
        from smart_crossover_tpu_torch.parallel.batched_lp import (
            batched_lp_crossover,
        )

        if device is None and mesh is not None:
            device = mesh.device
        res = batched_lp_crossover(Ab, bb, cb, lb, ub, tol=tol,
                                   warm_engine="ipm_refined", device=device)
        return {"x": res["x"], "obj": res["obj"],
                "pivots": res["pivots"], "optimal": res["optimal"],
                "status": ["OPTIMAL" if o else "NOT_OPTIMAL"
                           for o in res["optimal"]],
                "runtime": datetime.timedelta(
                    seconds=time.perf_counter() - t0)}

    from smart_crossover_tpu_torch.solvers.ipm_fleet import ipm_fleet

    fleet = ipm_fleet(Ab, bb, cb, lb, ub, tol=tol, mesh=mesh, device=device)
    return {"x": fleet.x, "obj": fleet.obj, "status": fleet.status,
            "runtime": datetime.timedelta(seconds=time.perf_counter() - t0)}
