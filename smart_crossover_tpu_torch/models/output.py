"""Result types: simplex basis and solver output.

Host copy of ``smart_crossover_tpu/models/output.py``, unchanged (the port
may not import the JAX package).

Basis encoding follows the convention the reference uses throughout (its
Gurobi VBasis/CBasis convention, see reference output.py:9-17 and the status
translations in solver_caller/cplex.py:86-103):

* ``vbasis[j] ==  0``  variable j is basic
* ``vbasis[j] == -1``  nonbasic at lower bound
* ``vbasis[j] == -2``  nonbasic at upper bound
* ``vbasis[j] == -3``  superbasic (nonbasic free variable)
* ``cbasis[i] ==  0``  the slack of constraint i is basic
* ``cbasis[i] == -1``  constraint i is tight (slack nonbasic)
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

VBASIS_BASIC = 0
VBASIS_AT_LOWER = -1
VBASIS_AT_UPPER = -2
VBASIS_SUPERBASIC = -3
CBASIS_BASIC = 0
CBASIS_NONBASIC = -1


@dataclass
class Basis:
    """Variable + constraint basis statuses (int arrays)."""

    vbasis: np.ndarray
    cbasis: np.ndarray

    def __post_init__(self) -> None:
        self.vbasis = np.asarray(self.vbasis).astype(np.int32)
        self.cbasis = np.asarray(self.cbasis).astype(np.int32)

    def copy(self) -> "Basis":
        return Basis(self.vbasis.copy(), self.cbasis.copy())

    @property
    def num_basic(self) -> int:
        return int(np.sum(self.vbasis == VBASIS_BASIC) + np.sum(self.cbasis == CBASIS_BASIC))


@dataclass(frozen=True)
class Output:
    """Result of an LP / crossover solve.

    Field-for-field capability match with the reference's Output
    (reference output.py:20-53):

    Attributes:
        x: vertex (basic) primal solution.
        y: dual solution.
        x_bar: interior-point / first-order primal solution.
        obj_val: objective value.
        runtime: wall-clock runtime as a timedelta.
        iter_count: simplex-type iteration count (pivots / pushes).
        bar_iter_count: barrier / first-order iteration count.
        rcost: reduced costs.
        basis: the final basis.
        status: solver status string ('OPTIMAL', 'INFEASIBLE', 'UNBOUNDED',
            'ITERATION_LIMIT', 'TIME_LIMIT', ...).
        farkas_ray: dual ray certifying INFEASIBLE (verifiable with
            solvers.rays.verify_farkas) — the in-house analog of the vendor
            Farkas duals the reference inherits (ref caller.py:164-179).
        unbounded_ray: primal recession direction certifying UNBOUNDED
            (verifiable with solvers.rays.verify_ray).
    """

    x: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    x_bar: Optional[np.ndarray] = None
    obj_val: Optional[float] = None
    runtime: Optional[datetime.timedelta] = None
    iter_count: Optional[float] = None
    bar_iter_count: Optional[int] = None
    rcost: Optional[np.ndarray] = None
    basis: Optional[Basis] = None
    status: Optional[str] = None
    farkas_ray: Optional[np.ndarray] = None
    unbounded_ray: Optional[np.ndarray] = None

    def __str__(self) -> str:
        rt = self.runtime.total_seconds() if self.runtime is not None else None
        return (
            f"Output(status={self.status}, obj_val={self.obj_val}, "
            f"runtime={rt}s, iter_count={self.iter_count}, "
            f"bar_iter_count={self.bar_iter_count})"
        )
