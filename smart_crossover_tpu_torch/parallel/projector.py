"""Mesh-sharded null-space projection and Sinkhorn.

Port of ``smart_crossover_tpu/parallel/projector.py``.  One large instance
(a big Y, a big OT cost matrix) is split by columns over the mesh's
'model' axis: each rank holds its column block, and the reductions over
columns are all-reduces of small vectors (``parallel/mesh.py``).
"""
from __future__ import annotations

import torch

from smart_crossover_tpu_torch.config import to_device
from smart_crossover_tpu_torch.parallel.mesh import MODEL_AXIS
from smart_crossover_tpu_torch.solvers.projection import _cg_normal


def sharded_projector(mesh, Y, v, tol: float = 1e-8, max_iter: int = 200):
    """Distributed  v - Y'(YY')^+ Y v  with Y column-sharded over 'model'.

    Each rank holds Y_loc (m, n/p) and v_loc (n/p).  The CG operator
    ``z -> YY'z`` is ``all_reduce(Y_loc @ (Y_loc' @ z))``, one m-vector
    all-reduce per CG iteration; CG's stopping rule is
    ``solvers/projection.py::_cg_normal``'s (``jax.scipy``'s), read from
    replicated values, so every rank stops at the same iteration.
    Returns the full (n,) result on the rank's device.
    """
    lo, hi = mesh.slice(MODEL_AXIS, Y.shape[1])
    Y_loc = to_device(Y[:, lo:hi], mesh.device)
    v_loc = to_device(v[lo:hi], mesh.device, Y_loc.dtype)
    Yv = mesh.sum(Y_loc @ v_loc)
    z, _ = _cg_normal(Y_loc, Yv, tol, max_iter,
                      mv=lambda w: mesh.sum(Y_loc @ (Y_loc.mT @ w)))
    return mesh.gather(v_loc - Y_loc.mT @ z, MODEL_AXIS)


def sinkhorn_potentials_sharded(mesh, s_full, d_loc, M_loc, reg,
                                num_iters: int):
    """Log-domain Sinkhorn potentials (f, g_loc) with M's columns sharded:
    the f-update's row logsumexp reduces across ranks with a MAX
    all-reduce (stability) and then a SUM; the g-update is rank-local."""
    log_s = torch.log(s_full)
    log_d = torch.log(d_loc)
    f = torch.zeros_like(log_s)
    g = torch.zeros_like(log_d)
    for _ in range(num_iters):
        t = (g[None, :] - M_loc) / reg
        tmax = mesh.max(t.amax(1))
        ssum = mesh.sum(torch.exp(t - tmax[:, None]).sum(1))
        f = reg * (log_s - (tmax + torch.log(ssum)))
        t2 = (f[:, None] - M_loc) / reg
        t2max = t2.amax(0)
        g = reg * (log_d - (t2max + torch.log(
            torch.exp(t2 - t2max[None, :]).sum(0))))
    return f, g


def sharded_sinkhorn_plan(mesh, s, d, M, reg, num_iters: int = 200):
    """Sinkhorn for ONE large OT instance with the demand axis sharded.

    M (S, D) is column-sharded over 'model'; ``reg`` is absolute (not
    scaled by max M).  Returns the full (S, D) plan exp((f + g - M) /
    reg) on the rank's device."""
    lo, hi = mesh.slice(MODEL_AXIS, M.shape[1])
    M_loc = to_device(M[:, lo:hi], mesh.device)
    s_full = to_device(s, mesh.device, M_loc.dtype)
    d_loc = to_device(d[lo:hi], mesh.device, M_loc.dtype)
    f, g = sinkhorn_potentials_sharded(mesh, s_full, d_loc, M_loc, reg,
                                       num_iters)
    plan = torch.exp((f[:, None] + g[None, :] - M_loc) / reg)
    return mesh.gather(plan, MODEL_AXIS, dim=1)
