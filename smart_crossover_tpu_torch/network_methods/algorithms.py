"""Network crossover algorithms: TNET, CNET_OT, CNET_MCF.

Port of ``smart_crossover_tpu/network_methods/algorithms.py``.  The flow
ranking and TNET's tree identification run on the device (the CUDA card
unless the caller passes ``device=``); column generation and its network
simplex run on the host in float64, as in the JAX package.

Entry points and control flow mirror the reference
(reference network_methods/algorithms.py:14-144): rank flows from an
interior-point (or Sinkhorn/PDHG) solution, identify a starting basis (tree
identification for TNET, all-artificial big-M basis for CNET), then grow a
column-generation subproblem — solved by the in-house warm-started network
simplex — doubling its size each round until the optimality certificate for
the FULL problem holds.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from smart_crossover_tpu_torch.models import MinCostFlow, OptTransport, Output
from smart_crossover_tpu_torch.network_methods.managers import (
    MCFManager,
    NetworkManager,
    OTManager,
)
from smart_crossover_tpu_torch.network_methods.tree_bi import tree_basis_identify
from smart_crossover_tpu_torch.parameters import COLUMN_GENERATION_RATIO
from smart_crossover_tpu_torch.solvers.network_simplex import (
    network_simplex_output,
)
from smart_crossover_tpu_torch.solvers.settings import SolverSettings
from smart_crossover_tpu_torch.utils import trace
from smart_crossover_tpu_torch.utils.timer import Timer

logger = logging.getLogger(__name__)


def network_crossover(x: np.ndarray,
                      ot: Optional[OptTransport] = None,
                      mcf: Optional[MinCostFlow] = None,
                      method: str = "tnet",
                      solver: str = "JAX",
                      solver_settings: SolverSettings | None = None, *,
                      device=None, stats: dict | None = None) -> Output:
    """Crossover from an inaccurate flow solution to an optimal vertex.

    Args:
        x: interior-point / first-order flow solution (len n).
        ot: the OT instance (for 'tnet' and 'cnet_ot').
        mcf: the MCF instance (for 'cnet_mcf').
        method: 'tnet' | 'cnet_ot' | 'cnet_mcf'.
        solver: subproblem solver backend; 'JAX' (in-house) is the default
            and only built-in backend.
        solver_settings: solver knobs.
        device: where the ranking and TNET's tree identification run (the
            CUDA card by default; without one that default raises).
        stats: a dict to fill with the run's counts and host seconds:
            ``ranking_s``, ``tree_basis_s``, ``push_iters``, ``cg_rounds``,
            ``subproblem_s`` (the network simplex's seconds inside the
            column generation), ``cg_pivots``, ``cg_s`` and
            ``direct_solve`` (the fallback ran).

    The call is the trace span ``scx.network_crossover`` around
    ``scx.ranking``, then ``scx.tree_basis`` (TNET) or ``scx.cnet_setup``
    (CNET: big-M, fixing, the first subproblem and basis), then ``scx.cg``
    (``utils/trace.py``).

    Returns:
        Output with the vertex solution, combined runtime, and the total
        pivot count (simplex iterations + TNET push iterations).
    """
    if solver_settings is None:
        solver_settings = SolverSettings(log_console=0)
    logger.info("*** Running %s algorithm ***", method)
    with trace.span("scx.network_crossover"):
        return _network_crossover(x, ot, mcf, method, solver,
                                  solver_settings, device,
                                  {} if stats is None else stats)


def _network_crossover(x, ot, mcf, method, solver, solver_settings, device,
                       stats) -> Output:
    timer = Timer()
    timer.start()
    push_iter = 0

    x = np.asarray(x, dtype=np.float64).reshape(-1)
    if method in ("tnet", "cnet_ot"):
        if ot is None:
            raise ValueError(f"method {method!r} requires an OptTransport instance")
        if x.size != ot.n:
            raise ValueError(
                f"x has {x.size} entries but the OT instance has "
                f"{ot.n} arcs (s.size * d.size)")
        manager = OTManager(ot, device=device)
    elif method == "cnet_mcf":
        if mcf is None:
            raise ValueError("method 'cnet_mcf' requires a MinCostFlow instance")
        if x.size != mcf.n:
            raise ValueError(
                f"x has {x.size} entries but the MCF instance has "
                f"{mcf.n} arcs")
        manager = MCFManager(mcf, device=device)
    else:
        raise ValueError(
            "Invalid method. Choose from 'tnet', 'cnet_ot', 'cnet_mcf'.")

    with trace.span("scx.ranking", stats=stats, key="ranking_s"):
        queue, flow_indicators = manager.get_sorted_flows(x)

    if method == "tnet":
        manager.get_mcf()
        with trace.span("scx.tree_basis", stats=stats, key="tree_basis_s"):
            tree_basis, push_iter = tree_basis_identify(manager,
                                                        flow_indicators)
        manager.set_basis(tree_basis)
        manager.add_free_variables(np.where(tree_basis.vbasis == 0)[0])
    else:
        with trace.span("scx.cnet_setup"):
            if method == "cnet_ot":
                manager.extend_by_bigM(manager.m * float(np.max(ot.M)))
                manager.get_mcf()
            else:  # cnet_mcf
                scale = float(np.max(np.abs(mcf.c))) or 1.0
                manager.rescale_cost(scale)
                manager.fix_variables(
                    ind_fix_to_up=np.where(x >= mcf.u / 2)[0],
                    ind_fix_to_low=np.where(x < mcf.u / 2)[0])
                manager.extend_by_bigM(
                    manager.m * float(np.max(manager.mcf.c[:manager.n])))
            manager.update_subproblem()
            manager.set_initial_basis()

    stats["push_iters"] = push_iter
    timer.stop()
    with trace.span("scx.cg", stats=stats, key="cg_s"):
        cg_output = column_generation(manager, queue, solver,
                                      solver_settings, stats=stats)
    stats["direct_solve"] = cg_output.status == "CG_FAILED"

    if cg_output.status == "CG_FAILED":
        # the crossover must still deliver an exact vertex when the column
        # generation runs dry (e.g. a warm start too weak for the ranking,
        # or residual numerical trouble after everything was freed): solve
        # the original instance directly with the native network simplex
        logger.warning("*** column generation failed; solving the full "
                       "instance directly ***")
        target = ot.to_MCF() if ot is not None else mcf
        direct = network_simplex_output(target)
        total_runtime = (timer.total + (cg_output.runtime or timer.total * 0)
                         + (direct.runtime or timer.total * 0))
        return Output(x=direct.x, obj_val=direct.obj_val,
                      runtime=total_runtime,
                      iter_count=(cg_output.iter_count or 0) + push_iter
                      + (direct.iter_count or 0),
                      basis=direct.basis, status=direct.status)

    total_iters = (cg_output.iter_count or 0) + push_iter
    total_runtime = timer.total + (cg_output.runtime or timer.total * 0)
    logger.info("*** Optimal solution found with %s pivots in %s ***",
                total_iters, total_runtime)
    return Output(x=cg_output.x, obj_val=cg_output.obj_val,
                  runtime=total_runtime, iter_count=total_iters,
                  basis=cg_output.basis, status=cg_output.status)


def column_generation(net_manager: NetworkManager,
                      queue: np.ndarray,
                      solver: str = "JAX",
                      solver_settings: SolverSettings | None = None, *,
                      stats: dict | None = None) -> Output:
    """Column-generation outer loop (reference algorithms.py:81-144).

    Frees the next slice of the sorted flow queue, re-solves the subproblem
    warm-started from the recovered basis, and doubles the target size until
    the full-problem optimality condition holds.  ``stats``, if given, gets
    the number of rounds as ``cg_rounds``, the subproblem solves' pivots
    as ``cg_pivots`` and their seconds as ``subproblem_s``.  Each round's
    solve and its optimality test (the pricing over every arc) are the
    trace spans ``scx.cg.subproblem`` and ``scx.cg.pricing``.
    """
    if solver_settings is None:
        solver_settings = SolverSettings(log_console=0)
    timer = Timer()
    timer.start()

    left = 0
    num_vars = (int(10 * net_manager.m)
                if net_manager.n / max(net_manager.m, 1) > 1000
                else int(1.2 * net_manager.m))
    x = None
    obj_val = None
    iters = 0
    status = "OPTIMAL"
    cg_round = 0
    sub_s = 0.0

    while True:
        if left >= len(queue):
            logger.warning("##### Column generation exhausted the queue #####")
            status = "CG_FAILED"
            break
        right = min(num_vars, len(queue))
        net_manager.add_free_variables(queue[left:right])
        net_manager.update_subproblem()

        timer.stop()
        with trace.span("scx.cg.subproblem"):
            sub_output = net_manager.solve_subproblem(solver, solver_settings)
        obj_val = net_manager.recover_obj_val(sub_output.obj_val)
        timer.accumulate(sub_output.runtime)
        timer.start()
        sub_s += sub_output.runtime.total_seconds()

        net_manager.set_basis(
            net_manager.recover_basis_from_sub_basis(sub_output.basis))
        x = net_manager.recover_x_from_sub_x(sub_output.x)
        obj_val = net_manager.objective(x)
        iters += sub_output.iter_count or 0
        cg_round += 1
        logger.info("*** CG round %d: %d columns, %s pivots ***",
                    cg_round, right, sub_output.iter_count)

        with trace.span("scx.cg.pricing"):
            optimal = net_manager.check_optimality_condition(x, sub_output.y)
        if optimal:
            break

        num_vars = int(COLUMN_GENERATION_RATIO * num_vars)
        left = right

    timer.stop()
    if stats is not None:
        stats["subproblem_s"] = sub_s
    trace.count("cg.rounds", cg_round, stats, "cg_rounds")
    trace.count("cg.pivots", iters, stats, "cg_pivots")
    return Output(x=x, obj_val=obj_val, runtime=timer.total,
                  iter_count=iters, basis=net_manager.basis, status=status)
