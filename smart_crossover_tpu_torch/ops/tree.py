"""Bipartite spanning-tree walks and push-to-feasibility, batched.

Port of ``smart_crossover_tpu/ops/tree.py`` and of the parent vector of
``smart_crossover_tpu/ops/transport_simplex_parent.py``.  On a card each
function is one launch: the tree solve and the parent vector of
``csrc/tree_walk.cu`` (``tree_walk``), the push of ``csrc/tree_push.cu``.
Their ``*_plain`` versions, the CPU path and the oracle, run the JAX
package's loops batched: the batch loop ends when no instance is active,
and an inactive instance takes no step.
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
# the walk kernel's status of an instance
_WALK_STATUS = {1: "does not hold S + D - 1 arcs",
                2: "leaves a node unreached (its arcs hold a cycle)"}


def tree_walk(mask, s=None, d=None):
    """One launch of ``csrc/tree_walk.cu`` on spanning-tree masks ``mask``
    (B, S, D) on a card, one block an instance: without ``s`` and ``d`` the
    parent vector (B, S + D) int64 of each tree rooted at node 0 (row 0),
    with them the tree flows X (B, S, D) with row sums ``s`` (B, S) and
    column sums ``d`` (B, D), float32 or float64 (another dtype raises
    ``TypeError``), in the wider of their dtypes.  The flows' walk starts
    at the first node of largest |mass|: each arc carries the balance of
    its side away from that node, summed in float64 and rounded once, and
    the masses' imbalance (float32 roundings) stays at that node, so an
    arc whose far side holds only zero masses carries exactly 0.

    Instance b's cells must be contiguous; the batch stride is taken as
    it is (Borůvka's masks are views with a stride of S * D + 1).  Raises
    ``ValueError``, after one small read of the device, where a mask is no
    spanning tree.  While the tracer records, the deepest instance's walk
    depth from its root counts as ``tree_walk.depth`` in the open span."""
    launch, out, info = walk_launcher(mask, s, d)
    if info is None:
        return out
    launch()
    status, depth = info.cpu().unbind(1)
    bad = status.nonzero().flatten().tolist()
    if bad:
        raise ValueError(
            f"tree_walk: the mask of instance {bad[0]} "
            f"{_WALK_STATUS[int(status[bad[0]])]} ({len(bad)} of "
            f"{mask.shape[0]} instances are no spanning tree)")
    trace.count("tree_walk.depth", int(depth.max()))
    return out


def walk_launcher(mask, s=None, d=None):
    """``tree_walk``'s checks and buffers: (launch, out, info), where each
    ``launch()`` issues one kernel into ``out`` and the per-instance
    (status, depth) ``info`` (B, 2) int32 on the current stream, without a
    read of the device; ``info`` is None for an empty batch."""
    if not mask.is_cuda:
        raise ValueError(f"tree_walk: no kernel for {mask.device}")
    B, S, D = mask.shape
    if S == 0 or D == 0:
        raise ValueError(f"tree_walk: an empty transportation problem "
                         f"({S} x {D})")
    flows = s is not None
    if flows:
        floats = (torch.float32, torch.float64)
        if s.dtype not in floats or d.dtype not in floats:
            raise TypeError(f"tree_walk: the kernel takes float32 or float64 "
                            f"masses, not {s.dtype} and {d.dtype}")
        dtype = torch.promote_types(s.dtype, d.dtype)
        s = s.to(mask.device, dtype).contiguous()
        d = d.to(mask.device, dtype).contiguous()
        out = torch.zeros(B, S, D, dtype=dtype, device=mask.device)
    else:
        dtype = torch.float32
        out = torch.empty(B, S + D, dtype=torch.int64, device=mask.device)
    if B == 0:
        return None, out, None
    if mask.dtype != torch.bool:
        mask = mask != 0
    if not mask[0].is_contiguous():
        mask = mask.contiguous()
    info = torch.empty(B, 2, dtype=torch.int32, device=mask.device)
    lib = _build.library()
    f64 = int(dtype == torch.float64)
    with torch.cuda.device(mask.device):
        # a block's node and arc arrays go to global scratch where they do
        # not fit its shared memory
        per_block = lib.scx_tree_walk_scratch_bytes(S, D, f64)
        if per_block < 0:
            _build.check(-per_block, "scx_tree_walk_scratch_bytes")
    scratch = (torch.empty(B * per_block, dtype=torch.uint8,
                           device=mask.device) if per_block else None)

    def launch():
        with torch.cuda.device(mask.device):
            err = lib.scx_tree_walk(
                mask.data_ptr(), mask.stride(0),
                s.data_ptr() if flows else None,
                d.data_ptr() if flows else None,
                None if scratch is None else scratch.data_ptr(), B, S, D,
                f64, None if flows else out.data_ptr(),
                out.data_ptr() if flows else None, info.data_ptr(),
                torch.cuda.current_stream(mask.device).cuda_stream)
        _build.check(err, "scx_tree_walk")
        _build.LAUNCHES["tree_walk"] += 1

    return launch, out, info


def bipartite_tree_solve(mask, s, d, max_rounds: int | None = None):
    """Flows X on each spanning-tree ``mask`` (B, S, D) with row sums ``s``
    (B, S) and column sums ``d`` (B, D).  Flows may be negative.

    A CUDA tensor runs one launch of ``tree_walk`` (float32 or float64
    masses), which walks every tree to its end: ``max_rounds``, kept for
    the JAX package's signature, must then be None (``ValueError``
    otherwise).  A CPU tensor runs ``bipartite_tree_solve_plain``, whose
    elimination rounds it bounds."""
    if mask.is_cuda:
        _no_rounds_on_the_card(max_rounds)
        return tree_walk(mask, s, d)
    return bipartite_tree_solve_plain(mask, s, d, max_rounds)


def bipartite_tree_solve_plain(mask, s, d, max_rounds: int | None = None):
    """Plain tensor version of the tree solve, by leaf elimination: each
    round assigns every supplier leaf, then every demander leaf, its
    residual balance.  The host reads "any edge left" once per
    ``_SOLVE_CHECK_EVERY`` rounds."""
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


def build_parent_from_mask(Bm, max_rounds: int | None = None):
    """Root each basis tree Bm (B, S, D) at node 0 (row 0).

    Nodes 0..S-1 are rows, S..S+D-1 columns.  Returns parent (B, V) int64
    with parent[root] == root.  A CUDA tensor runs one launch of
    ``tree_walk`` (``max_rounds`` must be None, as in
    ``bipartite_tree_solve``); a CPU tensor runs
    ``build_parent_from_mask_plain``, whose BFS rounds ``max_rounds``
    bounds.  In a tree every node's parent is unique, so both give the
    same vector."""
    if Bm.is_cuda:
        _no_rounds_on_the_card(max_rounds)
        return tree_walk(Bm)
    return build_parent_from_mask_plain(Bm, max_rounds)


def _no_rounds_on_the_card(max_rounds):
    if max_rounds is not None:
        raise ValueError("max_rounds bounds only the plain loops; the "
                         "tree walk kernel walks every tree to its end")


def build_parent_from_mask_plain(Bm, max_rounds: int | None = None):
    """Plain tensor version of the parent vector: breadth-first masked
    propagation, O(diameter) rounds, with a host read of "every node
    reached" each round."""
    B, S, D = Bm.shape
    V = S + D
    if max_rounds is None:
        max_rounds = V + 2
    dev = Bm.device
    parent = torch.zeros(B, V, dtype=torch.int64, device=dev)
    arow = torch.zeros(B, S, dtype=torch.bool, device=dev)
    arow[:, 0] = True
    acol = torch.zeros(B, D, dtype=torch.bool, device=dev)
    for _ in range(max_rounds):
        if bool(arow.all()) and bool(acol.all()):
            break
        # in a tree, a newly reached column has exactly one assigned row
        reach_c = Bm & arow[:, :, None] & ~acol[:, None, :]
        hit_c = reach_c.any(1)
        pi_c = reach_c.to(torch.uint8).argmax(1)
        parent[:, S:] = torch.where(hit_c, pi_c, parent[:, S:])
        acol = acol | hit_c
        reach_r = Bm & acol[:, None, :] & ~arow[:, :, None]
        hit_r = reach_r.any(2)
        pj_r = reach_r.to(torch.uint8).argmax(2) + S
        parent[:, :S] = torch.where(hit_r, pj_r, parent[:, :S])
        arow = arow | hit_r
    return parent


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
