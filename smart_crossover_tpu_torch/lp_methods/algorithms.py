"""Perturbation crossover for general LP.

Host copy of ``smart_crossover_tpu/lp_methods/algorithms.py``; only the
import paths differ (the port may not import the JAX package).

Control flow mirrors the reference (lp_methods/algorithms.py:18-265):

1. barrier-solve the LP with crossover off (in-house IPM) to get an interior
   pair (x, y);
2. detect the feasibility-problem case via the projected-cost norm;
3. estimate the optimal face from primal/dual slacks, fix the variables and
   constraints off the face, perturb the objective (deterministic, seeded),
   and re-solve the restricted perturbed LP with barrier + crossover — the
   perturbation makes the vendor... here the *in-house* crossover cheap;
4. shrink the face estimate and retry if the restriction was infeasible;
5. accept if the relative primal-dual gap vs. the barrier objective is below
   1e-8, otherwise finish with warm-started primal simplex on the original.

The null-space projections that set the perturbation scale run on the
in-house CG/MINRES kernels (solvers/projection.py) instead of Gurobi's QP.
"""
from __future__ import annotations

import logging

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as splinalg

from smart_crossover_tpu_torch.lp_methods.lp_manager import LPManager
from smart_crossover_tpu_torch.models import GeneralLP, Output
from smart_crossover_tpu_torch.parameters import (
    CONSTANT_SCALE_FACTOR,
    OPTIMAL_FACE_ESTIMATOR,
    OPTIMAL_FACE_ESTIMATOR_UPDATE_RATIO,
    PERTURB_THRESHOLD,
    PERTURB_UPPER_BOUND,
    PRIMAL_DUAL_GAP_THRESHOLD,
    PROJECTOR_THRESHOLD,
)
from smart_crossover_tpu_torch.solvers.projection import (
    apply_projector,
    apply_projector_with_free,
)
from smart_crossover_tpu_torch.solvers.settings import SolverSettings
from smart_crossover_tpu_torch.solvers.solving import solve_lp

logger = logging.getLogger(__name__)


def run_perturb_algorithm(lp: GeneralLP,
                          solver: str = "JAX",
                          barrierTol: float = 1e-8,
                          optimalityTol: float = 1e-6,
                          log_file: str = "") -> Output:
    """Run the perturbation crossover (entry parity with reference :18)."""
    logger.info("*** Running the perturbation crossover algorithm ***")
    barrier_output = solve_lp(
        lp, solver, method="barrier",
        settings=SolverSettings(barrierTol=barrierTol, presolve="on",
                                crossover="off", log_file=log_file))
    if barrier_output.status not in ("OPTIMAL", "NEAR_OPTIMAL"):
        return barrier_output

    is_feas_problem = check_feasibility_problem(lp)

    gamma, gamma_dual = OPTIMAL_FACE_ESTIMATOR, OPTIMAL_FACE_ESTIMATOR
    perturb_manager = None
    perturb_output = None
    for attempt in range(8):
        logger.info("*** building and solving a perturbed subproblem "
                    "(gamma=%.1e) ***", gamma)
        perturb_manager = get_perturb_problem(
            lp, barrier_output.x, barrier_output.y, gamma, gamma_dual,
            is_feas=is_feas_problem)
        perturb_output = solve_lp(
            perturb_manager.lp_sub, solver=solver, method="barrier",
            # a diverging (unbounded-face) perturbed solve should fail fast:
            # legitimate perturbed subproblems converge well within 60 iters
            # certify='off': an INFEASIBLE/UNBOUNDED perturbed subproblem is
            # an EXPECTED outcome handled by the gamma-shrink retry below —
            # exact ray extraction there would be pure overhead
            # timeLimit 900: a subproblem whose crossover crawls signals a
            # bad face estimate; the gamma-shrink retry below then fixes
            # more variables and re-solves a SMALLER subproblem — far
            # cheaper than letting one attempt burn the full 3600 s budget
            settings=SolverSettings(presolve="on", crossover="on",
                                    barrierMaxIters=60, certify="off",
                                    timeLimit=900.0,
                                    log_file=log_file),
            warm_start_solution=(
                perturb_manager.get_subx(barrier_output.x),
                barrier_output.y))
        if perturb_output.status != "OPTIMAL":
            # covers INFEASIBLE/UNBOUNDED and also ITERATION_LIMIT/STALLED:
            # an over-eager face estimate can leave the perturbed LP
            # unbounded, which the barrier may only reveal as divergence
            gamma *= OPTIMAL_FACE_ESTIMATOR_UPDATE_RATIO
            gamma_dual *= OPTIMAL_FACE_ESTIMATOR_UPDATE_RATIO ** 2
            logger.info("*** perturbed subproblem not solved (%s); "
                        "shrinking the face estimate ***",
                        perturb_output.status)
        else:
            break
    if perturb_output is None or perturb_output.status != "OPTIMAL":
        # the perturbation never produced a usable vertex; fall back to the
        # plain crossover (warm primal simplex from the barrier solution),
        # which is slower but always yields an exact vertex
        logger.warning("*** perturbation failed (%s); falling back to the "
                       "plain warm-started simplex crossover ***",
                       perturb_output.status if perturb_output else "none")
        fb = solve_lp(
            lp, solver=solver, method="primal_simplex",
            settings=SolverSettings(presolve="on",
                                    optimalityTol=optimalityTol,
                                    log_file=log_file),
            warm_start_solution=(barrier_output.x, barrier_output.y))
        return Output(x=fb.x, y=fb.y, x_bar=barrier_output.x,
                      obj_val=fb.obj_val,
                      runtime=barrier_output.runtime
                      + (fb.runtime or barrier_output.runtime * 0),
                      iter_count=fb.iter_count,
                      bar_iter_count=barrier_output.bar_iter_count,
                      rcost=fb.rcost, basis=fb.basis, status=fb.status)

    if check_perturb_output_precision(perturb_manager, perturb_output.x,
                                      lp.c, barrier_output.obj_val):
        logger.info("*** a primal optimal BFS was found directly ***")
        x_full = perturb_manager.get_orix(perturb_output.x)
        basis_full = perturb_manager.recover_basis_from_sub_basis(
            perturb_output.basis)
        return Output(x=x_full, y=perturb_output.y,
                      x_bar=barrier_output.x,
                      obj_val=float(lp.c @ x_full) + lp.obj_offset,
                      runtime=(barrier_output.runtime
                               + perturb_output.runtime),
                      iter_count=perturb_output.iter_count,
                      bar_iter_count=(barrier_output.bar_iter_count or 0)
                      + (perturb_output.bar_iter_count or 0),
                      basis=basis_full, status="OPTIMAL")

    final_output = solve_lp(
        lp, solver=solver,
        method="simplex" if solver == "MSK" else "primal_simplex",
        settings=SolverSettings(presolve="on", optimalityTol=optimalityTol,
                                log_file=log_file),
        warm_start_solution=(
            perturb_manager.recover_x_from_sub_x(perturb_output.x),
            perturb_output.y),
        warm_start_basis=perturb_manager.recover_basis_from_sub_basis(
            perturb_output.basis))
    total_runtime = (barrier_output.runtime + perturb_output.runtime
                     + (final_output.runtime or barrier_output.runtime * 0))
    return Output(x=final_output.x, y=final_output.y,
                  x_bar=barrier_output.x, obj_val=final_output.obj_val,
                  runtime=total_runtime,
                  iter_count=((perturb_output.iter_count or 0)
                              + (final_output.iter_count or 0)),
                  bar_iter_count=(barrier_output.bar_iter_count or 0)
                  + (perturb_output.bar_iter_count or 0),
                  rcost=final_output.rcost, basis=final_output.basis,
                  status=final_output.status)


def get_perturb_problem(lp: GeneralLP, x: np.ndarray, y: np.ndarray,
                        gamma: float, gamma_dual: float,
                        is_feas: bool) -> LPManager:
    """Restrict to the estimated optimal face with a perturbed objective
    (reference :79-111): fix x_j to lower where x-l < gamma*s_d, to upper
    where u-x < gamma*(-s_d); force rows to equality where s_p < gamma_dual*(-y)."""
    s_d = lp.get_dual_slack(y)
    s_p = lp.get_primal_slack(x)

    manager = LPManager(lp.copy())
    manager.lp.c = perturb_c(lp, x, is_feas)
    manager.fix_variables(
        ind_fix_to_low=np.where(x - lp.l < gamma * s_d)[0],
        ind_fix_to_up=np.where(lp.u - x < gamma * -s_d)[0])
    manager.fix_constraints(
        ind_fix_to_up=np.where(s_p < gamma_dual * -y)[0])
    logger.info("  fixed variables: %d, fixed constraints: %d",
                manager.get_num_fixed_variables(),
                manager.get_num_fixed_constraints())
    manager.update_subproblem()
    return manager


def perturb_c(lp: GeneralLP, x: np.ndarray, is_feas: bool) -> np.ndarray:
    """Deterministic seeded objective perturbation (reference :114-151)."""
    x_real = get_x_perturb_val(lp, x)
    x_real[x_real < PERTURB_THRESHOLD] = 1e-6
    x_real[lp.get_free_ind()] = 1.0

    rng = np.random.RandomState(42)
    p = rng.uniform(0.9, 1.0, x_real.size)
    p = p / np.linalg.norm(p)

    # perturb each variable TOWARD its finite bound: +p when l is finite
    # (rests at the lower bound), -p when only u is finite, 0 when free.
    # A blindly positive perturbation creates an unbounded ray on every
    # l = -inf variable, which matters most in the feasibility case where
    # the perturbation IS the whole objective.
    sign = np.where(np.isfinite(lp.l), 1.0,
                    np.where(np.isfinite(lp.u), -1.0, 0.0))

    if is_feas:
        return lp.c + sign * p

    projector = get_projector_Xc(lp, x_real)
    n_std = x_real.size + lp.num_slacks
    scale_factor = get_scale_factor(projector, n_std)
    p = np.minimum(p / x_real * scale_factor / CONSTANT_SCALE_FACTOR,
                   PERTURB_UPPER_BOUND)
    return lp.c + sign * p


def get_projector_c(lp: GeneralLP) -> np.ndarray:
    """Project the (standardised) cost onto null(A_std)."""
    return apply_projector(lp.get_standard_A(), lp.get_standard_c())


def get_projector_Xc(lp: GeneralLP, x: np.ndarray) -> np.ndarray:
    """Project Xc onto null(A X) with free columns eliminated first
    (reference :162-180)."""
    xx = lp.get_standard_x(x)
    free = lp.get_free_ind()
    if free.size == 0:
        Y = lp.get_standard_A() @ sp.diags(xx)
        return apply_projector(Y, xx * lp.get_standard_c())
    nonfree = lp.get_nonfree_ind()
    xx_nf = xx[nonfree]
    A_nf = lp.get_nonfree_var_matrix()
    A_f = lp.get_free_var_matrix()
    c_std = lp.get_standard_c()
    from smart_crossover_tpu_torch.utils.threads import _tp_limits

    with _tp_limits(limits=1, user_api="blas"):   # BLAS1-only CG loop
        trans, _ = splinalg.cg(A_f.T @ A_f, c_std[free], rtol=1e-8,
                               maxiter=1000)
    c_nf = c_std[nonfree] - A_nf.T @ (A_f @ trans)
    return apply_projector_with_free(A_nf @ sp.diags(xx_nf),
                                     xx_nf * c_nf, A_f)


def get_scale_factor(projector: np.ndarray, n: int) -> float:
    return float(np.linalg.norm(projector)) / n


def get_x_perturb_val(lp: GeneralLP, x: np.ndarray) -> np.ndarray:
    """min(x - l, u - x), with free variables kept at their x value."""
    x_min = np.minimum(x - lp.l, lp.u - x)
    free = lp.get_free_ind()
    x_min[free] = x[free]
    return x_min


def check_perturb_output_precision(manager: LPManager, x_ptb: np.ndarray,
                                   c_ori: np.ndarray,
                                   barrier_obj: float) -> bool:
    """Relative primal-dual gap acceptance (reference :205-224)."""
    x = manager.get_orix(x_ptb)
    obj = float(c_ori @ x) + manager.lp.obj_offset
    gap = abs(obj - barrier_obj)
    rel_gap = gap / (abs(obj) + abs(barrier_obj) + 1.0)
    logger.info("*** primal-dual gap: %.2e ***", rel_gap)
    return rel_gap < PRIMAL_DUAL_GAP_THRESHOLD


def check_feasibility_problem(lp: GeneralLP) -> bool:
    """The LP is 'a feasibility problem' when c projects to ~0 on null(A)."""
    proj_c = get_projector_c(lp)
    c_norm = float(np.linalg.norm(lp.c))
    if c_norm == 0.0 or np.linalg.norm(proj_c) / c_norm < PROJECTOR_THRESHOLD:
        logger.info("*** the problem is a feasibility problem ***")
        return True
    return False
