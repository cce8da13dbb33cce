"""Bipartite spanning-tree flow solve and push-to-feasibility, batched.

Port of ``smart_crossover_tpu/ops/tree.py``.  Each instance of the batch
runs the JAX package's loop; the batch loop ends when no instance is
active, and an inactive instance takes no step.
"""
from __future__ import annotations

import torch

# push steps run between two host checks of "any instance still active";
# a finished instance's later steps are no-ops (theta = 0)
_PUSH_CHECK_EVERY = 16


def bipartite_tree_solve(mask, s, d, max_rounds: int | None = None):
    """Flows X on each spanning-tree ``mask`` (B, S, D) with row sums ``s``
    (B, S) and column sums ``d`` (B, D), by leaf elimination: each round
    assigns every supplier leaf, then every demander leaf, its residual
    balance.  Flows may be negative."""
    B, S, D = mask.shape
    if max_rounds is None:
        max_rounds = S + D + 2
    dtype = torch.promote_types(torch.promote_types(s.dtype, d.dtype),
                                torch.float32)
    active = mask.clone()
    rs = s.to(dtype).clone()
    rd = d.to(dtype).clone()
    X = torch.zeros(B, S, D, dtype=dtype, device=mask.device)
    for _ in range(max_rounds):
        if not bool(active.any()):
            break
        leaf_s = active.sum(2) == 1
        oh_j = (active & leaf_s[:, :, None]).to(dtype)
        flow_s = torch.where(leaf_s, rs, 0.0)
        X = X + flow_s[:, :, None] * oh_j
        rd = rd - (flow_s[:, :, None] * oh_j).sum(1)
        rs = rs - flow_s
        active = active & ~leaf_s[:, :, None]

        leaf_d = active.sum(1) == 1
        oh_i = (active & leaf_d[:, None, :]).to(dtype)
        flow_d = torch.where(leaf_d, rd, 0.0)
        X = X + flow_d[:, None, :] * oh_i
        rs = rs - (oh_i * flow_d[:, None, :]).sum(2)
        rd = rd - flow_d
        active = active & ~leaf_d[:, None, :]
    return X


def push_to_bfs(X, tol: float = 0.0, max_iter: int = 100_000):
    """Irrigation push of signed tree flows X (B, S, D) to feasibility.

    Per instance, while min(X) < -tol: take the most negative cell
    (I1, J1) (first in flat order), J2 = argmax of row I1, I2 = argmax of
    column J1, and shift theta = min(-X[I1,J1], X[I1,J2], X[I2,J1]) around
    the 4-cycle.  Returns (X, push_iters (B,)).
    """
    X = X.clone()
    B, S, D = X.shape
    b = torch.arange(B, device=X.device)
    iters = torch.zeros(B, dtype=torch.int64, device=X.device)
    steps = 0
    while steps < max_iter:
        for _ in range(min(_PUSH_CHECK_EVERY, max_iter - steps)):
            flat = X.reshape(B, -1)
            vmin, fmin = flat.min(1)
            active = (vmin < -tol) & (iters < max_iter)
            I1 = fmin // D
            J1 = fmin % D
            J2 = X[b, I1, :].argmax(1)
            I2 = X[b, :, J1].argmax(1)
            theta = torch.minimum(torch.minimum(-X[b, I1, J1], X[b, I1, J2]),
                                  X[b, I2, J1])
            theta = torch.where(active, theta, 0.0)
            X[b, I1, J1] += theta
            X[b, I2, J1] -= theta
            X[b, I1, J2] -= theta
            X[b, I2, J2] += theta
            iters += active
            steps += 1
        if not bool(((X.reshape(B, -1).amin(1) < -tol)
                     & (iters < max_iter)).any()):
            break
    return X, iters
