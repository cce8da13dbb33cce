"""solvers of the PyTorch port (see smart_crossover_tpu/solvers): the names
of the JAX package's ``__all__``, the heavier engines imported lazily.

A name that is also a submodule's (``sinkhorn``, ``network_simplex``) is
imported here, so that importing the submodule cannot leave the module
where the function belongs."""
from smart_crossover_tpu_torch.solvers.network_simplex import network_simplex
from smart_crossover_tpu_torch.solvers.settings import SolverSettings
from smart_crossover_tpu_torch.solvers.sinkhorn import sinkhorn, sinkhorn_plan

__all__ = [
    "SolverSettings",
    "sinkhorn",
    "sinkhorn_plan",
    "ipm_solve",
    "ipm_general_lp",
    "primal_simplex",
    "dual_simplex",
    "network_simplex",
    "pdhg_solve",
    "pdhg_general_lp",
    "apply_projector",
    "presolve_lp",
    "solve_lp",
    "solve_mcf",
    "solve_ot",
    "SolverCaller",
    "generate_solver_caller",
]

_P = "smart_crossover_tpu_torch.solvers."
_LAZY = {
    "ipm_solve": (_P + "ipm", "ipm_solve"),
    "ipm_general_lp": (_P + "ipm", "ipm_general_lp"),
    "primal_simplex": (_P + "simplex", "primal_simplex"),
    "dual_simplex": (_P + "simplex", "dual_simplex"),
    "pdhg_solve": (_P + "pdhg", "pdhg_solve"),
    "pdhg_general_lp": (_P + "pdhg", "pdhg_general_lp"),
    "apply_projector": (_P + "projection", "apply_projector"),
    "presolve_lp": (_P + "presolve", "presolve_lp"),
    "solve_lp": (_P + "solving", "solve_lp"),
    "solve_mcf": (_P + "solving", "solve_mcf"),
    "solve_ot": (_P + "solving", "solve_ot"),
    "SolverCaller": (_P + "caller", "SolverCaller"),
    "generate_solver_caller": (_P + "caller", "generate_solver_caller"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(
        f"module 'smart_crossover_tpu_torch.solvers' has no attribute "
        f"{name!r}")
