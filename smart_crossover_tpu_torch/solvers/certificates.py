"""Optimality certificates.

Host copy of ``smart_crossover_tpu/solvers/certificates.py``; only the
import paths differ (the port may not import the JAX package).

The reference's quality control is mathematical self-verification embedded in
its managers (SURVEY.md §4: artificial-variable + reduced-cost tests,
relative primal-dual gap).  This module exposes those checks as standalone,
reusable certificates over (x, y, basis) triples — the acceptance criteria
for every solver and crossover in the framework, and the oracles the test
suite builds on.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from smart_crossover_tpu_torch.models import GeneralLP, MinCostFlow


@dataclass
class Certificate:
    primal_feasible: bool
    dual_feasible: bool
    complementary: bool
    primal_infeas: float
    dual_infeas: float
    rel_gap: float

    @property
    def optimal(self) -> bool:
        return self.primal_feasible and self.dual_feasible and self.complementary


def certify_lp(lp: GeneralLP, x: np.ndarray, y: np.ndarray,
               feas_tol: float = 1e-7, opt_tol: float = 1e-6) -> Certificate:
    """Verify (x, y) as an optimal primal-dual pair for a GeneralLP."""
    A = sp.csr_matrix(lp.A)
    r = lp.b - np.asarray(A @ x).reshape(-1)
    eq = lp.sense == "="
    scale_b = 1.0 + np.linalg.norm(lp.b)
    pviol = np.where(eq, np.abs(r), np.maximum(-r, 0.0))
    bound_viol = np.maximum.reduce([
        np.where(np.isfinite(lp.l), lp.l - x, 0.0),
        np.where(np.isfinite(lp.u), x - lp.u, 0.0),
        np.zeros_like(x)])
    pinf = float(max(pviol.max(initial=0.0), bound_viol.max(initial=0.0))
                 / scale_b)

    rc = lp.get_dual_slack(y)
    scale_c = 1.0 + np.linalg.norm(lp.c)
    # dual feasibility: rc >= 0 where x can decrease, <= 0 where it can rise
    lo_slack = np.where(np.isfinite(lp.l), x - lp.l, np.inf)
    up_slack = np.where(np.isfinite(lp.u), lp.u - x, np.inf)
    dviol = np.where(lo_slack <= feas_tol * scale_b, np.maximum(-rc, 0.0),
                     np.where(up_slack <= feas_tol * scale_b,
                              np.maximum(rc, 0.0), np.abs(rc)))
    # fixed columns (l == u) may carry any reduced cost at optimality
    fixed = (np.isfinite(lp.l) & np.isfinite(lp.u)
             & (lp.u - lp.l <= feas_tol * scale_b))
    dviol = np.where(fixed, 0.0, dviol)
    # '<' rows need y <= 0
    yviol = np.maximum(np.where(~eq, y, 0.0), 0.0)
    dinf = float(max(dviol.max(initial=0.0), yviol.max(initial=0.0))
                 / scale_c)

    pobj = float(lp.c @ x)
    dobj = float(lp.b @ y
                 + np.where(np.isfinite(lp.l), lp.l * np.maximum(rc, 0.0),
                            0.0).sum()
                 + np.where(np.isfinite(lp.u), lp.u * np.minimum(rc, 0.0),
                            0.0).sum())
    gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
    return Certificate(primal_feasible=pinf <= feas_tol,
                       dual_feasible=dinf <= opt_tol,
                       complementary=gap <= 100 * opt_tol,
                       primal_infeas=pinf, dual_infeas=dinf, rel_gap=gap)


def certify_mcf(mcf: MinCostFlow, x: np.ndarray, y: np.ndarray,
                feas_tol: float = 1e-7, opt_tol: float = 1e-6) -> Certificate:
    """Verify (x, y) for a min-cost flow (the reference's network acceptance:
    flow conservation, capacities, reduced costs >= -tol off upper bounds —
    net_manager.py:306-319)."""
    r = mcf.b - np.asarray(mcf.A @ x).reshape(-1)
    scale_b = 1.0 + np.linalg.norm(mcf.b)
    pinf = float(max(np.abs(r).max(initial=0.0),
                     np.maximum(-x, 0.0).max(initial=0.0),
                     np.maximum(x - mcf.u, 0.0).max(initial=0.0)) / scale_b)
    rc = mcf.c - (y[mcf.heads] - y[mcf.tails])
    at_up = np.isfinite(mcf.u) & (x >= mcf.u - feas_tol * scale_b)
    dviol = np.where(at_up, np.maximum(rc, 0.0), np.maximum(-rc, 0.0))
    # basic-ish arcs (0 < x < u) must have |rc| ~ 0
    interior = (x > feas_tol * scale_b) & ~at_up
    dviol = np.where(interior, np.abs(rc), dviol)
    scale_c = 1.0 + np.linalg.norm(mcf.c)
    dinf = float(dviol.max(initial=0.0) / scale_c)
    pobj = float(mcf.c @ x)
    dobj = float(mcf.b @ y + np.where(at_up, mcf.u * rc, 0.0).sum())
    gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
    return Certificate(primal_feasible=pinf <= feas_tol,
                       dual_feasible=dinf <= opt_tol,
                       complementary=gap <= 100 * opt_tol,
                       primal_infeas=pinf, dual_infeas=dinf, rel_gap=gap)
