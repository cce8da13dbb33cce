"""Solver settings.

Host copy of ``smart_crossover_tpu/solvers/settings.py``, unchanged.

Field-compatible with the reference's SolverSettings (reference
caller.py:17-41) so call sites migrate unchanged, with extra knobs for the
in-house first-order engines (which the reference had no need for — it
delegated to Gurobi/CPLEX/Mosek).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SolverSettings:
    presolve: str = "on"
    crossover: str = "on"
    barrierTol: float = 1e-8
    optimalityTol: float = 1e-6
    timeLimit: int = 3600
    log_file: str = ""
    log_console: int = 1
    iterLimit: int = 1000
    simplexPricing: str = ""  # 'SE' steepest-edge-ish block pricing / 'PP' partial

    # In-house engine knobs (no reference analog).
    simplexMaxIters: int = 200_000
    barrierMaxIters: int = 200
    networkSimplexMaxIters: int = 10_000_000
    firstOrderMaxIters: int = 100_000
    sinkhornReg: float = 1e-2
    # First-order engine variant: 'adaptive' (PDLP, default/oracle) or
    # 'halpern' (restarted reflected-Halpern, the sharp-tail engine;
    # 2.2x at 1e-8 on the 1500x6000 class).
    fomMode: str = "adaptive"
    # Device transportation-simplex engine for method='device_simplex':
    # 'parent' (one-hot binary lifting), 'anc' (incremental ancestor
    # matrix — the large-instance engine), 'mask' (oracle).
    deviceSimplexEngine: str = "parent"
    # Exact INFEASIBLE/UNBOUNDED certification (solvers/rays.py) when the
    # barrier/first-order engines fail: 'auto' certifies when the iterates
    # point at infeasibility/unboundedness, 'on' on any failure status,
    # 'off' never (used by callers that handle failure statuses themselves,
    # e.g. the perturbation crossover's gamma-shrink retry loop).
    certify: str = "auto"
