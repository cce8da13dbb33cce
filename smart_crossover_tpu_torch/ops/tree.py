"""Bipartite spanning-tree flow solve and push-to-feasibility, batched.

Port of ``smart_crossover_tpu/ops/tree.py``.  Each instance of the batch
runs the JAX package's loop; the batch loop ends when no instance is
active, and an inactive instance takes no step.  On a card the push runs
as one launch of ``csrc/tree_push.cu``; ``push_to_bfs_plain`` is its plain
version.
"""
from __future__ import annotations

import torch

from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch.utils import trace

# push steps run between two host checks of "any instance still active";
# a finished instance's later steps are no-ops (theta = 0)
_PUSH_CHECK_EVERY = 16
# leaf-elimination rounds between two host checks of "any edge left"; a
# round with no edge left changes nothing
_SOLVE_CHECK_EVERY = 8


def bipartite_tree_solve(mask, s, d, max_rounds: int | None = None):
    """Flows X on each spanning-tree ``mask`` (B, S, D) with row sums ``s``
    (B, S) and column sums ``d`` (B, D), by leaf elimination: each round
    assigns every supplier leaf, then every demander leaf, its residual
    balance.  Flows may be negative.  The host reads "any edge left" once
    per ``_SOLVE_CHECK_EVERY`` rounds."""
    B, S, D = mask.shape
    if max_rounds is None:
        max_rounds = S + D + 2
    dtype = torch.promote_types(torch.promote_types(s.dtype, d.dtype),
                                torch.float32)
    active = mask.clone()
    rs = s.to(dtype).clone()
    rd = d.to(dtype).clone()
    X = torch.zeros(B, S, D, dtype=dtype, device=mask.device)
    for r in range(max_rounds):
        if r % _SOLVE_CHECK_EVERY == 0 and not bool(active.any()):
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

    A CUDA tensor runs the whole loop in one launch of
    ``csrc/tree_push.cu``, one block per instance, which takes the plain
    loop's steps bit for bit; it must be float32 or float64.  A CPU tensor
    runs ``push_to_bfs_plain``.  Both count ``push.steps``, the longest
    instance's steps, in the open trace span.
    """
    if not X.is_cuda:
        return push_to_bfs_plain(X, tol, max_iter)
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"push_to_bfs: the kernel takes float32 or float64 "
                        f"flows, not {X.dtype}")
    X = X.clone(memory_format=torch.contiguous_format)
    B, S, D = X.shape
    if X.numel() == 0:
        return X, torch.zeros(B, dtype=torch.int64, device=X.device)
    iters = torch.empty(B, dtype=torch.int64, device=X.device)
    lib = _build.library()
    f64 = int(X.dtype == torch.float64)
    with torch.cuda.device(X.device):
        # a block's row-minima cache goes to global scratch where it does
        # not fit the block's shared memory
        per_block = lib.scx_tree_push_scratch_bytes(S, f64)
        if per_block < 0:
            _build.check(-per_block, "scx_tree_push_scratch_bytes")
        scratch = (torch.empty(B * per_block, dtype=torch.uint8,
                               device=X.device) if per_block else None)
        err = lib.scx_tree_push(
            X.data_ptr(), iters.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, S, D,
            float(tol), min(int(max_iter), 2**31 - 1), f64,
            torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(err, "scx_tree_push")
    _build.LAUNCHES["tree_push"] += 1
    _count_steps(iters)
    return X, iters


def _count_steps(iters) -> None:
    """``push.steps``: the longest instance's steps, read from the device
    only while the tracer records."""
    if iters.numel() and trace.TRACER.recording_now():
        trace.count("push.steps", int(iters.max()))


def push_to_bfs_plain(X, tol: float = 0.0, max_iter: int = 100_000):
    """Plain tensor version of the push kernel, driven from the host: the
    batch takes one step at a time, and the host reads "any instance still
    active" once per ``_PUSH_CHECK_EVERY`` steps."""
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
    _count_steps(iters)
    return X, iters
