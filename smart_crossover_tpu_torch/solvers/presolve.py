"""LP presolve.

Host copy of ``smart_crossover_tpu/solvers/presolve.py``; only the import
paths differ (the port may not import the JAX package).

The reference prepares its "optLP" suite by running Gurobi's presolve and
re-writing the reduced models (reference filehandling.py:62-74).  This module
is the in-house equivalent: a fixpoint of cheap, safe reductions

* empty rows (with infeasibility detection),
* fixed columns (l == u) substituted into the RHS,
* singleton equality rows (fix the variable),
* empty columns (moved to their cost-optimal bound; detects unboundedness),

returning the reduced GeneralLP plus a postsolve function that lifts a
reduced primal solution back to the original variable space.
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import scipy.sparse as sp

from smart_crossover_tpu_torch.models import GeneralLP


class PresolveError(ValueError):
    """Raised when presolve proves the LP infeasible or unbounded."""

    def __init__(self, status: str, msg: str = ""):
        super().__init__(f"{status}: {msg}")
        self.status = status


@dataclass
class PresolveInfo:
    kept_rows: np.ndarray
    kept_cols: np.ndarray
    fixed_values: np.ndarray       # over original columns (nan = kept)
    obj_offset: float
    # (row, col) of each singleton-'='-row substitution, in application
    # order; postsolve_y replays them in reverse to rebuild exact duals
    singleton_fixes: list = None

    def postsolve_x(self, x_red: np.ndarray) -> np.ndarray:
        x = self.fixed_values.copy()
        x[self.kept_cols] = x_red
        return x

    def postsolve_y(self, y_red: np.ndarray, lp: GeneralLP) -> np.ndarray:
        """Lift reduced-space duals to the original rows.

        Empty rows take y=0 (no coefficients).  Each dropped singleton row i
        that fixed column j gets the unique y_i zeroing that column's reduced
        cost, y_i = (c_j - sum_{k != i} A_kj y_k) / A_ij, replayed in reverse
        substitution order so chained singletons resolve correctly."""
        y = np.zeros(lp.m)
        y[self.kept_rows] = y_red
        if self.singleton_fixes:
            A = sp.csc_matrix(lp.A)
            for i, j in reversed(self.singleton_fixes):
                col = A.getcol(j)
                aij = col[i, 0]
                rest = (col.T @ y).item() - aij * y[i]
                y[i] = (lp.c[j] - rest) / aij
        return y


def presolve_lp(lp: GeneralLP, tol: float = 1e-10,
                max_rounds: int = 20) -> tuple[GeneralLP, PresolveInfo]:
    """Reduce the LP; raises PresolveError on detected infeasibility or
    unboundedness."""
    A = sp.csc_matrix(lp.A).astype(np.float64)
    b = lp.b.copy()
    c = lp.c.copy()
    l = lp.l.copy()
    u = lp.u.copy()
    sense = lp.sense.copy()
    n0, m0 = lp.n, lp.m

    col_alive = np.ones(n0, dtype=bool)
    row_alive = np.ones(m0, dtype=bool)
    fixed_values = np.full(n0, np.nan)
    obj_offset = 0.0
    singleton_fixes: list = []

    def fix_column(j: int, val: float):
        nonlocal obj_offset, b
        col = A.getcol(j)
        b = b - np.asarray(col.todense()).ravel() * val
        obj_offset += c[j] * val
        fixed_values[j] = val
        col_alive[j] = False

    for _ in range(max_rounds):
        changed = False

        # fixed columns
        for j in np.where(col_alive)[0]:
            if np.isfinite(l[j]) and np.isfinite(u[j]) and u[j] - l[j] <= tol:
                if u[j] < l[j] - tol:
                    raise PresolveError("INFEASIBLE", f"l > u on column {j}")
                fix_column(j, l[j])
                changed = True

        # row nonzero counts over alive columns
        mask_cols = sp.diags(col_alive.astype(np.float64))
        nnz_per_row = np.asarray(
            (A @ mask_cols).astype(bool).sum(axis=1)).ravel()

        # empty rows
        for i in np.where(row_alive & (nnz_per_row == 0))[0]:
            if sense[i] == "=" and abs(b[i]) > 1e-7:
                raise PresolveError("INFEASIBLE", f"empty '=' row {i} with b={b[i]}")
            if sense[i] == "<" and b[i] < -1e-7:
                raise PresolveError("INFEASIBLE", f"empty '<' row {i} with b={b[i]}")
            row_alive[i] = False
            changed = True

        # singleton equality rows -> fix the variable
        Acsr = A.tocsr()
        for i in np.where(row_alive & (nnz_per_row == 1))[0]:
            if sense[i] != "=":
                continue
            row = Acsr.getrow(i)
            alive_in_row = [(j, v) for j, v in zip(row.indices, row.data)
                            if col_alive[j] and v != 0.0]
            if len(alive_in_row) != 1:
                continue
            j, aij = alive_in_row[0]
            val = b[i] / aij
            if val < l[j] - 1e-7 or val > u[j] + 1e-7:
                raise PresolveError(
                    "INFEASIBLE", f"singleton row {i} forces x[{j}]={val} "
                    f"outside [{l[j]}, {u[j]}]")
            fix_column(j, val)
            singleton_fixes.append((int(i), int(j)))
            row_alive[i] = False
            changed = True

        # empty columns -> cost-optimal bound
        col_nnz = np.asarray(
            (sp.diags(row_alive.astype(np.float64)) @ A)
            .astype(bool).sum(axis=0)).ravel()
        for j in np.where(col_alive & (col_nnz == 0))[0]:
            if c[j] > tol:
                if not np.isfinite(l[j]):
                    raise PresolveError("UNBOUNDED", f"empty column {j}")
                fix_column(j, l[j])
            elif c[j] < -tol:
                if not np.isfinite(u[j]):
                    raise PresolveError("UNBOUNDED", f"empty column {j}")
                fix_column(j, u[j])
            else:
                fix_column(j, float(np.clip(0.0, l[j], u[j])))
            changed = True

        if not changed:
            break

    kept_rows = np.where(row_alive)[0]
    kept_cols = np.where(col_alive)[0]
    lp_red = GeneralLP(A=A[kept_rows][:, kept_cols].tocsr(),
                       b=b[kept_rows], c=c[kept_cols],
                       l=l[kept_cols], u=u[kept_cols],
                       sense=sense[kept_rows],
                       name=lp.name + "_presolved")
    info = PresolveInfo(kept_rows=kept_rows, kept_cols=kept_cols,
                        fixed_values=fixed_values, obj_offset=obj_offset,
                        singleton_fixes=singleton_fixes)
    return lp_red, info
