"""Log-domain Sinkhorn for optimal transport, batched over a leading axis.

Port of ``smart_crossover_tpu/solvers/sinkhorn.py``.  Every function takes
an explicit batch: s (B, S), d (B, D), M (B, S, D).  ``reg`` is a float or
a (B,) tensor of per-instance absolute regularisations.  The hot loop has a
hand-written CUDA kernel in ``ops/sinkhorn_fused.py``; these are the plain
tensor versions.
"""
from __future__ import annotations

import torch


def _per_instance(reg, like: torch.Tensor) -> torch.Tensor:
    """``reg`` as a (B or 1, 1) column in ``like``'s dtype and device."""
    return torch.as_tensor(reg, dtype=like.dtype,
                           device=like.device).reshape(-1, 1)


def _logsumexp(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Max-first logsumexp with the same guard on non-finite maxima as
    ``jax.scipy.special.logsumexp``."""
    tmax = t.amax(dim, keepdim=True)
    tmax = torch.where(torch.isfinite(tmax), tmax, torch.zeros_like(tmax))
    return (torch.log(torch.exp(t - tmax).sum(dim, keepdim=True))
            + tmax).squeeze(dim)


def sinkhorn_potentials(s, d, M, reg, num_iters: int = 1000):
    """Run ``num_iters`` Sinkhorn iterations; return potentials (f, g) with
    X = exp((f[:, :, None] + g[:, None, :] - M) / reg)."""
    r = _per_instance(reg, M)
    log_s = torch.log(s)
    log_d = torch.log(d)
    f = torch.zeros_like(log_s)
    g = torch.zeros_like(log_d)
    r3 = r[:, :, None]
    for _ in range(num_iters):
        f = r * (log_s - _logsumexp((g[:, None, :] - M) / r3, dim=2))
        g = r * (log_d - _logsumexp((f[:, :, None] - M) / r3, dim=1))
    return f, g


def plan_from_potentials(f, g, M, reg):
    r = _per_instance(reg, M)[:, :, None]
    return torch.exp((f[:, :, None] + g[:, None, :] - M) / r)


def round_to_feasible(X, s, d):
    """Altschuler-Weed-Rigollet rounding onto the transport polytope
    (exact row and column sums), per instance."""
    one = torch.ones((), dtype=X.dtype, device=X.device)
    row = X.sum(2)
    X = X * torch.minimum(one, s / torch.where(row > 0, row, one))[:, :, None]
    col = X.sum(1)
    X = X * torch.minimum(one, d / torch.where(col > 0, col, one))[:, None, :]
    err_r = s - X.sum(2)
    err_c = d - X.sum(1)
    total = err_r.sum(1)
    total = torch.where(total > 0, total, one)
    return X + err_r[:, :, None] * err_c[:, None, :] / total[:, None, None]


def sinkhorn_plan(s, d, M, reg, num_iters: int = 1000,
                  round_plan: bool = True):
    """Sinkhorn transport plans, optionally rounded to exact marginals."""
    f, g = sinkhorn_potentials(s, d, M, reg, num_iters)
    X = plan_from_potentials(f, g, M, reg)
    if round_plan:
        X = round_to_feasible(X, s, d)
    return X
