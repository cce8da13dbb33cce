"""Mesh-sharded PDHG: one large LP, column blocks over the 'model' axis.

Port of ``smart_crossover_tpu/parallel/pdhg_sharded.py``.  The primal
vector x and the columns of A are split over the ranks; the dual vector y
is replicated.  Per iteration:

    x-update:  local   (c_loc - A_loc' y)          — no communication
    y-update:  sum_j   (A_loc @ x_bar_loc)          — one m-vector all-reduce

The JAX function is XLA code with no Pallas kernel, and so is this one.
"""
from __future__ import annotations

import numpy as np
import torch

from smart_crossover_tpu_torch.config import to_device
from smart_crossover_tpu_torch.parallel.mesh import MODEL_AXIS
from smart_crossover_tpu_torch.solvers.pdhg import _host


def sharded_pdhg(mesh, A, b, c, l, u, sense=None,
                 num_iters: int = 10_000, restart_period: int = 200,
                 opnorm: float | None = None):
    """Run fixed-step PDHG (tau = sigma = 0.9 / ||A||) with averaging
    restarts every ``restart_period`` iterations, A column-sharded over
    the mesh's 'model' axis.

    Args:
        A: (m, n) dense; the mesh width divides n.
        sense: '='/'<' per row (None = all '=').
        opnorm: ||A||_2; default 30 power iterations on the host from
            ``default_rng(0)``, as the JAX function computes it.

    Returns:
        (x, y) as float64 numpy arrays (x gathered).
    """
    m, n = A.shape
    if opnorm is None:
        An = _host(A)
        v = np.random.default_rng(0).standard_normal(n)
        for _ in range(30):
            w = An.T @ (An @ v)
            v = w / (np.linalg.norm(w) + 1e-30)
        opnorm = float(np.sqrt(np.linalg.norm(An.T @ (An @ v))))
    tau = 0.9 / opnorm
    sigma = 0.9 / opnorm

    lo, hi = mesh.slice(MODEL_AXIS, n)
    A_loc = to_device(A[:, lo:hi], mesh.device)
    dt = A_loc.dtype
    c_loc, l_loc, u_loc = (to_device(a[lo:hi], mesh.device, dt)
                           for a in (c, l, u))
    b_full = to_device(b, mesh.device, dt)
    is_eq = torch.as_tensor(
        np.ones(m, bool) if sense is None else np.asarray(sense) == "=",
        device=mesh.device)

    x = torch.clamp(torch.zeros_like(c_loc), l_loc, u_loc)
    y = torch.zeros_like(b_full)
    for _ in range(num_iters // restart_period):
        xs = torch.zeros_like(x)
        ys = torch.zeros_like(y)
        for _ in range(restart_period):
            x_new = torch.clamp(x - tau * (c_loc - A_loc.T @ y), l_loc, u_loc)
            x_bar = 2.0 * x_new - x
            Ax = mesh.sum(A_loc @ x_bar)
            y_new = y + sigma * (b_full - Ax)
            y = torch.where(is_eq, y_new, torch.clamp(y_new, max=0.0))
            x = x_new
            xs += x
            ys += y
        # restart at the window average (fixed-period averaging restart)
        x = xs / restart_period
        y = ys / restart_period
    x = mesh.gather(x, MODEL_AXIS)
    return (x.to("cpu", torch.float64).numpy(),
            y.to("cpu", torch.float64).numpy())
