"""Log-domain Sinkhorn for optimal transport, batched over a leading axis.

Port of ``smart_crossover_tpu/solvers/sinkhorn.py``.  Every function takes
an explicit batch: s (B, S), d (B, D), M (B, S, D).  ``reg`` is a float or
a (B,) tensor of per-instance absolute regularisations.  The hot loop has a
hand-written CUDA kernel in ``ops/sinkhorn_fused.py``; these are the plain
tensor versions.  The ``sinkhorn(ot)`` wrapper on one ``OptTransport``
runs that kernel on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from smart_crossover_tpu_torch.config import resolve_device, to_device
from smart_crossover_tpu_torch.ops.sinkhorn_fused import sinkhorn_plan_fused
from smart_crossover_tpu_torch.parameters import SINKHORN_DEFAULT_REG


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


def _iterate(f, g, log_s, log_d, M, r, num_iters: int):
    """``num_iters`` Sinkhorn rounds at the (B, 1) regularisation column r."""
    r3 = r[:, :, None]
    for _ in range(num_iters):
        f = r * (log_s - _logsumexp((g[:, None, :] - M) / r3, dim=2))
        g = r * (log_d - _logsumexp((f[:, :, None] - M) / r3, dim=1))
    return f, g


def sinkhorn_potentials(s, d, M, reg, num_iters: int = 1000):
    """Run ``num_iters`` Sinkhorn iterations; return potentials (f, g) with
    X = exp((f[:, :, None] + g[:, None, :] - M) / reg)."""
    log_s = torch.log(s)
    log_d = torch.log(d)
    return _iterate(torch.zeros_like(log_s), torch.zeros_like(log_d),
                    log_s, log_d, M, _per_instance(reg, M), num_iters)


def sinkhorn_potentials_annealed(s, d, M, reg, num_iters: int = 500,
                                 stages: int = 4, start_factor: float = 16.0):
    """Epsilon-annealed Sinkhorn: ``stages`` rounds of ``num_iters //
    stages`` iterations, the regularisation falling geometrically from
    ``start_factor * reg`` to ``reg``, each round warm-started from the
    last (``smart_crossover_tpu/solvers/sinkhorn.py:54``)."""
    log_s = torch.log(s)
    log_d = torch.log(d)
    per_stage = max(num_iters // stages, 1)
    ratio = start_factor ** (1.0 / max(stages - 1, 1))
    r = _per_instance(reg, M)
    f, g = torch.zeros_like(log_s), torch.zeros_like(log_d)
    for k in range(stages):
        f, g = _iterate(f, g, log_s, log_d, M, r * ratio ** (stages - 1 - k),
                        per_stage)
    return f, g


def sinkhorn_potentials_tol(s, d, M, reg, tol: float = 1e-9,
                            max_iters: int = 10_000, check_every: int = 10):
    """Tolerance-stopped Sinkhorn (POT's stopThr): per instance, blocks of
    ``check_every`` iterations until the row-marginal L1 error is at most
    ``tol`` or ``max_iters`` is reached
    (``smart_crossover_tpu/solvers/sinkhorn.py:85``); a finished instance
    takes no further step.  Returns (f, g, iters (B,))."""
    log_s = torch.log(s)
    log_d = torch.log(d)
    r = _per_instance(reg, M)
    f, g = torch.zeros_like(log_s), torch.zeros_like(log_d)
    iters = torch.zeros(M.shape[0], dtype=torch.int64, device=M.device)
    active = torch.ones(M.shape[0], dtype=torch.bool, device=M.device)
    while bool(active.any()):
        fn, gn = _iterate(f, g, log_s, log_d, M, r, check_every)
        f = torch.where(active[:, None], fn, f)
        g = torch.where(active[:, None], gn, g)
        iters = iters + check_every * active
        row = plan_from_potentials(f, g, M, r[:, 0]).sum(2)
        err = (row - s).abs().sum(1)
        active = active & (err > tol) & (iters < max_iters)
    return f, g, iters


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


def sinkhorn(ot, reg: float | None = None, num_iters: int = 1000,
             relative_reg: bool = True, round_plan: bool = True, *,
             device=None) -> np.ndarray:
    """Sinkhorn warm start of one ``OptTransport``, through the fused kernel
    (port of ``smart_crossover_tpu/solvers/sinkhorn.py:152``).

    eps = reg * max(M) (``relative_reg``) or reg is folded into the cost,
    and the kernel runs on M / eps at regularisation 1, as the batched
    pipelines run it (the plan is invariant under (M / eps, eps = 1)).
    ``device``: the CUDA card by default (float32, the kernel; without a
    card this raises), or e.g. "cpu" (the input's float64, the plain
    version).

    Returns the (S*D,) float64 flow vector (the flattened plan, rounded
    onto the transport polytope unless ``round_plan`` is False), the ``x``
    argument of ``network_crossover``.
    """
    if np.any(np.asarray(ot.s) <= 0) or np.any(np.asarray(ot.d) <= 0):
        raise ValueError(
            "sinkhorn requires strictly positive supplies/demands; drop "
            "zero-mass entries first")
    if reg is None:
        reg = SINKHORN_DEFAULT_REG
    dev = resolve_device(device)
    M = to_device(ot.M, dev)
    s = to_device(ot.s, dev, M.dtype)[None]
    d = to_device(ot.d, dev, M.dtype)[None]
    eps = reg * M.max() if relative_reg else reg
    plan, _, _ = sinkhorn_plan_fused(s, d, (M / eps)[None].contiguous(), 1.0,
                                     num_iters)
    if round_plan:
        plan = round_to_feasible(plan, s, d)
    return plan[0].to(torch.float64).cpu().numpy().ravel()
