"""Class-based solver-caller API.

The reference exposes a stateful ``SolverCaller`` object API
(reference solver_caller/caller.py:44-236: read model, set warm starts, run
a method, extract results).  Migrating code written against that shape works
against this in-house implementation; new code should prefer the functional
facade in solvers/solving.py.

Host copy of ``smart_crossover_tpu/solvers/caller.py`` on the port's
``solve_lp`` / ``solve_mcf``; only the import paths differ.
"""
from __future__ import annotations

import datetime
from typing import Optional, Tuple, Union

import numpy as np

from smart_crossover_tpu_torch.models import (
    Basis,
    GeneralLP,
    MinCostFlow,
    OptTransport,
    Output,
    StandardLP,
)
from smart_crossover_tpu_torch.solvers.settings import SolverSettings
from smart_crossover_tpu_torch.solvers.solving import solve_lp, solve_mcf


class SolverCaller:
    """In-house solver caller (the 'JAX' backend).

    Methods mirror the reference ABC: read_* to ingest a model, optional
    add_warm_start_*, one run_* call, then return_* extractors (or
    return_output for the assembled Output).
    """

    solver_name = "JAX"

    def __init__(self, solver_settings: SolverSettings | None = None) -> None:
        self.settings = solver_settings or SolverSettings()
        self.model: Union[GeneralLP, MinCostFlow, None] = None
        self._warm_basis: Optional[Basis] = None
        self._warm_solution: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._output: Optional[Output] = None

    # --- model ingest -------------------------------------------------------
    def read_model_from_file(self, path: str) -> None:
        """.mps/.mps.gz/.lp/.lp.gz ingest (reference caller.py:57-64 reads
        both formats through the vendor readers)."""
        from smart_crossover_tpu_torch.data.loaders import load_instance

        model = load_instance(path)
        if isinstance(model, OptTransport):
            model = model.to_MCF()
        elif isinstance(model, StandardLP):
            model = model.to_general()
        self.model = model

    def read_mcf(self, mcf: MinCostFlow) -> None:
        self.model = mcf

    def read_ot(self, ot: OptTransport) -> None:
        self.model = ot.to_MCF()

    def read_stdlp(self, stdlp: StandardLP) -> None:
        self.model = stdlp.to_general()

    def read_genlp(self, genlp: GeneralLP) -> None:
        self.model = genlp

    # --- model export -------------------------------------------------------
    def _as_genlp(self) -> GeneralLP:
        if isinstance(self.model, MinCostFlow):
            return self.model.to_standard_lp().to_general()
        return self.model

    def get_A(self):
        import scipy.sparse as sp

        return sp.csr_matrix(self._as_genlp().A)

    def get_b(self):
        return self._as_genlp().b

    def get_c(self):
        return self._as_genlp().c

    def get_l(self):
        return self._as_genlp().l

    def get_u(self):
        return self._as_genlp().u

    def get_sense(self):
        return self._as_genlp().sense

    def return_genlp(self) -> GeneralLP:
        return self._as_genlp()

    # --- warm starts --------------------------------------------------------
    def add_warm_start_basis(self, basis: Basis) -> None:
        self._warm_basis = basis

    def add_warm_start_solution(
            self, start_solution: Tuple[np.ndarray, np.ndarray]) -> None:
        self._warm_solution = start_solution

    # --- run methods --------------------------------------------------------
    def _run(self, method: str, crossover: str | None = None) -> None:
        settings = self.settings
        if crossover is not None:
            from dataclasses import replace

            settings = replace(settings, crossover=crossover)
        if isinstance(self.model, MinCostFlow) and method in (
                "default", "network_simplex"):
            self._output = solve_mcf(self.model, method=method,
                                     settings=settings,
                                     warm_start_basis=self._warm_basis)
        else:
            self._output = solve_lp(self._as_genlp(), method=method,
                                    settings=settings,
                                    warm_start_basis=self._warm_basis,
                                    warm_start_solution=self._warm_solution)

    def run_default(self) -> None:
        self._run("default")

    def run_barrier(self) -> None:
        self._run("barrier", crossover="on")

    def run_barrier_no_crossover(self) -> None:
        self._run("barrier", crossover="off")

    def run_simplex(self) -> None:
        self._run("simplex")

    def run_primal_simplex(self) -> None:
        self._run("primal_simplex")

    def run_dual_simplex(self) -> None:
        self._run("dual_simplex")

    def run_network_simplex(self) -> None:
        self._run("network_simplex")

    def reset_model(self) -> None:
        self.model = None
        self._warm_basis = None
        self._warm_solution = None
        self._output = None

    # --- result extraction --------------------------------------------------
    def _out(self) -> Output:
        if self._output is None:
            raise RuntimeError("no solve has been run")
        return self._output

    def return_x(self) -> np.ndarray:
        return self._out().x

    def return_y(self) -> np.ndarray:
        return self._out().y

    def return_barx(self) -> np.ndarray:
        return self._out().x_bar

    def return_obj_val(self) -> float:
        return self._out().obj_val

    def return_runtime(self) -> datetime.timedelta:
        return self._out().runtime

    def return_iter_count(self):
        return self._out().iter_count

    def return_bar_iter_count(self):
        return self._out().bar_iter_count

    def return_reduced_cost(self) -> np.ndarray:
        return self._out().rcost

    def return_basis(self) -> Basis:
        return self._out().basis

    def return_status(self) -> str:
        return self._out().status

    def return_output(self) -> Output:
        return self._out()


def generate_solver_caller(solver: str = "JAX",
                           solver_settings: SolverSettings | None = None
                           ) -> SolverCaller:
    """Reference solving.py:13-29 parity: every backend name returns the
    in-house caller."""
    if solver not in ("JAX", "TPU", "GRB", "CPL", "MSK"):
        raise ValueError("Invalid solver. Choose from 'JAX', 'TPU' "
                         "(or legacy 'GRB'/'CPL'/'MSK').")
    return SolverCaller(solver_settings)
