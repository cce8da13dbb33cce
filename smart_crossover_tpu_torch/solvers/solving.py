"""Crossover start statuses (host, numpy).

Port of ``smart_crossover_tpu/solvers/solving.py::_crossover_statuses``.
The rest of that module, the ``solve_lp`` / ``solve_mcf`` / ``solve_ot``
facade, is not ported yet (ROADMAP 1.14).
"""
from __future__ import annotations

import numpy as np

from smart_crossover_tpu_torch.solvers.simplex import (
    ST_BASIC,
    ST_LOWER,
    ST_UPPER,
)


def _crossover_statuses(x, l, u, ctol: float = 1e-7) -> np.ndarray:
    """Classify an interior solution into simplex statuses (the in-house
    analog of a vendor barrier crossover start): variables hugging a bound
    become nonbasic at that bound, everything else is proposed basic and the
    simplex basis repair + phase-1/2 finishes the job."""
    st = np.full(x.size, ST_BASIC, dtype=np.int8)
    dl = x - l
    du = u - x
    near = ctol * (1.0 + np.abs(x))
    at_l = np.isfinite(l) & (dl <= du) & (dl < near)
    at_u = np.isfinite(u) & (du < dl) & (du < near)
    st[at_l] = ST_LOWER
    st[at_u] = ST_UPPER
    st[~np.isfinite(l) & ~np.isfinite(u)] = ST_BASIC
    return st
