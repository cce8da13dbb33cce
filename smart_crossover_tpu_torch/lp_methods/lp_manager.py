"""LP subproblem manager for the perturbation crossover.

Host copy of ``smart_crossover_tpu/lp_methods/lp_manager.py``; only the
import paths differ (the port may not import the JAX package).

Capability parity with the reference LPManager (lp_methods/lp_manager.py:8-134):
fix variables to bounds / constraints to equality, build the restricted
subproblem, and recover solutions/bases in the full index space.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.sparse as sp

from smart_crossover_tpu_torch.models import Basis, GeneralLP


class LPManager:
    """Bookkeeping for the optimal-face-restricted subproblem."""

    def __init__(self, lp: GeneralLP) -> None:
        self.lp = lp
        self.m = lp.m
        self.n = lp.n
        self.var_info: Dict[str, np.ndarray] = {
            "non_fix": np.arange(self.n, dtype=np.int64),
            "fix_low": np.array([], dtype=np.int64),
            "fix_up": np.array([], dtype=np.int64),
            "fix": np.array([], dtype=np.int64),
        }
        self.fixed_constraints = np.array([], dtype=np.int64)
        self.lp_sub: GeneralLP | None = None

    def fix_variables(self, ind_fix_to_low: np.ndarray,
                      ind_fix_to_up: np.ndarray) -> None:
        self.var_info["fix_low"] = np.asarray(ind_fix_to_low, dtype=np.int64)
        self.var_info["fix_up"] = np.asarray(ind_fix_to_up, dtype=np.int64)
        mask = np.ones(self.n, dtype=bool)
        mask[self.var_info["fix_low"]] = False
        mask[self.var_info["fix_up"]] = False
        self.var_info["non_fix"] = np.where(mask)[0]
        self.var_info["fix"] = np.where(~mask)[0]

    def fix_constraints(self, ind_fix_to_up: np.ndarray) -> None:
        """Force the listed '<' rows to hold with equality."""
        self.fixed_constraints = np.asarray(ind_fix_to_up, dtype=np.int64)

    def update_subproblem(self) -> None:
        A = sp.csc_matrix(self.lp.A)
        nf = self.var_info["non_fix"]
        fl, fu = self.var_info["fix_low"], self.var_info["fix_up"]
        if self.var_info["fix"].size == 0:
            sub = self.lp.copy()
        else:
            b = self.lp.b.copy()
            if fu.size:
                b = b - np.asarray(A[:, fu] @ self.lp.u[fu]).reshape(-1)
            if fl.size:
                b = b - np.asarray(A[:, fl] @ self.lp.l[fl]).reshape(-1)
            sub = GeneralLP(A=A[:, nf], b=b, c=self.lp.c[nf],
                            l=self.lp.l[nf], u=self.lp.u[nf],
                            sense=self.lp.sense.copy(),
                            name=self.lp.name + "_sub")
        if self.fixed_constraints.size:
            sub.sense = sub.sense.copy()
            sub.sense[self.fixed_constraints] = "="
        self.lp_sub = sub

    # --- recovery -----------------------------------------------------------
    def recover_x_from_sub_x(self, x_sub: np.ndarray) -> np.ndarray:
        x = np.zeros(self.n)
        x[self.var_info["non_fix"]] = x_sub
        x[self.var_info["fix_up"]] = self.lp.u[self.var_info["fix_up"]]
        return x

    def get_orix(self, x_sub: np.ndarray) -> np.ndarray:
        x = self.recover_x_from_sub_x(x_sub)
        x[self.var_info["fix_low"]] = self.lp.l[self.var_info["fix_low"]]
        return x

    def get_subx(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x)[self.var_info["non_fix"]]

    def recover_basis_from_sub_basis(self, basis_sub: Basis) -> Basis:
        vbasis = np.full(self.n, -1, dtype=np.int32)
        vbasis[self.var_info["non_fix"]] = basis_sub.vbasis
        vbasis[self.var_info["fix_up"]] = -2
        return Basis(vbasis, basis_sub.cbasis)

    def update_c(self, c_sub_new: np.ndarray) -> None:
        self.lp.c[self.var_info["non_fix"]] = c_sub_new
        if self.lp_sub is not None:
            self.lp_sub.c = c_sub_new

    def get_num_fixed_variables(self) -> int:
        return int(self.var_info["fix"].size)

    def get_num_fixed_constraints(self) -> int:
        return int(self.fixed_constraints.size)
