"""Arc-list PDHG for min-cost flow on the card.

Port of ``smart_crossover_tpu/solvers/pdhg_mcf.py`` (``_power_opnorm``,
``pdhg_mcf_device``): the first-order warm start of the GOTO-17 protocol
(first-order warm start, then crossover; ``scripts/run_goto17.py``).  The
restarted PDHG cores of ``solvers/pdhg.py`` (adaptive PDLP and reflected
Halpern) run on the MCF's node-arc incidence matrix as a CSR operator
(``ops/pdhg_sparse.py::CSROperator``, A and A' as CSR tensors).  On an
H100 80GB HBM3 (700 W) it ran 14-27% faster per Halpern iteration than
the ``index_add_``/gather operator (``IncidenceOperator``, whose atomic
sums are not reproducible either) at 98k and at 786k arcs;
``chip_smoke.py``'s GOTO phases time both.  The JAX module relabels nodes
by degree and groups arcs by degree bucket so that its TPU matvecs become
reshapes and sorts; the port keeps the instance's own node and arc order
throughout.
"""
from __future__ import annotations

import datetime
import time

import numpy as np
import torch

from smart_crossover_tpu_torch.config import device_float, resolve_device
from smart_crossover_tpu_torch.ops.pdhg_sparse import CSROperator
from smart_crossover_tpu_torch.solvers.pdhg import (
    _pdhg_core,
    _pdhg_core_halpern,
)


def _start_vector(n: int, seed: int = 0) -> np.ndarray:
    """The power iteration's start: a numpy Gaussian (n,) in arc order."""
    return np.random.default_rng(seed).standard_normal(n)


def _power_opnorm(op, v, iters: int = 30):
    """||A||_2 of an operator by ``iters`` power-iteration rounds from
    ``v`` (a tensor on the operator's device), as the JAX package does."""
    for _ in range(iters):
        w = op.T @ (op @ v)
        v = w / (torch.linalg.norm(w) + 1e-30)
    w = op @ v
    return torch.sqrt(torch.linalg.norm(op.T @ w)
                      / (torch.linalg.norm(v) + 1e-30))


def pdhg_mcf_device(mcf, tol: float = 1e-4, max_iters: int = 5000,
                    mode: str = "halpern", dtype=None,
                    check_every: int = 250, restart_period: int = 500,
                    x0=None, y0=None, *, device=None):
    """First-order warm-start engine for MCF on the card.

    ``mode``: 'halpern' (restarted reflected Halpern, the default) or
    'adaptive' (PDLP adaptive steps).  ``device``: the CUDA card by
    default (without one that default raises), ``"cpu"`` for the CPU;
    ``dtype``: float32 on the card, float64 on the CPU unless given.

    Returns (x, y, iters, converged, runtime) with x and y in the
    instance's arc and node order, f64 numpy arrays.
    """
    if mode not in ("adaptive", "halpern"):
        raise ValueError(f"pdhg_mcf_device: unknown mode {mode!r}")
    t0 = time.perf_counter()
    dev = resolve_device(device)
    if dtype is None:
        dtype = device_float(dev)
    m, n = len(mcf.b), len(mcf.c)
    A = mcf.A.tocoo()
    op = CSROperator(A.row, A.col, A.data, (m, n), dtype, dev)

    def dev_t(v):
        return torch.as_tensor(np.asarray(v, np.float64)).to(
            device=dev, dtype=dtype)

    c, u, b = dev_t(mcf.c), dev_t(mcf.u), dev_t(mcf.b)
    l = torch.zeros(n, dtype=dtype, device=dev)
    xs = dev_t(x0) if x0 is not None else torch.clamp(
        torch.zeros(n, dtype=dtype, device=dev), l, u)
    ys = dev_t(y0) if y0 is not None else torch.zeros(m, dtype=dtype,
                                                       device=dev)
    opnorm = _power_opnorm(op, dev_t(_start_vector(n)))
    is_eq = torch.ones(m, dtype=torch.bool, device=dev)
    core = _pdhg_core_halpern if mode == "halpern" else _pdhg_core
    x, y, iters, done = core(op, b, c, l, u, is_eq, opnorm, xs, ys,
                             max_iters=max_iters, check_every=check_every,
                             restart_period=restart_period, tol=tol)
    x = x.double().cpu().numpy()
    y = y.double().cpu().numpy()
    runtime = datetime.timedelta(seconds=time.perf_counter() - t0)
    return x, y, int(iters), bool(done), runtime
