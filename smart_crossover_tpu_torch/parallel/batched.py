"""Batched TNET pipelines, from Sinkhorn warm start to exact vertices.

Port of ``smart_crossover_tpu/parallel/batched.py`` (``tnet_single``,
``batched_tnet``, ``batched_tnet_exact_device``).  Every stage takes the
instance batch as a leading axis.  The Sinkhorn stage always runs the
fused route: per-instance eps = reg * max(M_b) is folded into the cost and
the fused kernel runs at reg = 1 (the plan is invariant under
(M / eps, eps = 1)).  The pivot stage runs the in-kernel transportation
simplex.  The other engines of the JAX package, its host repair
(``batched_tnet_exact``) and its sharded pipelines are not ported yet.
"""
from __future__ import annotations

from smart_crossover_tpu_torch.config import resolve_device, to_device
from smart_crossover_tpu_torch.network_methods.tree_bi import (
    identify_tree_flows,
)
from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
from smart_crossover_tpu_torch.ops.ranking import ot_flow_indicators
from smart_crossover_tpu_torch.ops.sinkhorn_fused import sinkhorn_plan_fused
from smart_crossover_tpu_torch.ops.transport_simplex_mega import (
    batched_transport_simplex_mega,
)
from smart_crossover_tpu_torch.solvers.sinkhorn import round_to_feasible


def _warm_start(s, d, M, reg: float, sinkhorn_iters: int):
    eps = reg * M.amax((1, 2))
    Mn = (M / eps[:, None, None]).contiguous()
    plan, _, _ = sinkhorn_plan_fused(s, d, Mn, 1.0, sinkhorn_iters)
    Xs = round_to_feasible(plan, s, d)
    W = ot_flow_indicators(Xs, s, d)
    return identify_tree_flows(W, s, d)


def batched_tnet(s, d, M, reg: float = 0.02, sinkhorn_iters: int = 200):
    """TNET over a batch, flow-indicator tree weights: s (B, S), d (B, D),
    M (B, S, D) tensors.  Returns (X_vertex, push_iters, obj)."""
    X, push = _warm_start(s, d, M, reg, sinkhorn_iters)
    return X, push, (X * M).sum((1, 2))


def tnet_single(s, d, M, reg: float = 0.02, sinkhorn_iters: int = 200):
    """One instance, s (S,), d (D,), M (S, D): Sinkhorn -> indicators ->
    MST -> tree solve -> push.  Returns (X_vertex, push_iters, obj)."""
    X, push, obj = batched_tnet(s[None], d[None], M[None], reg,
                                sinkhorn_iters)
    return X[0], push[0], obj[0]


def batched_tnet_exact_device(s, d, M, reg: float = 0.005,
                              sinkhorn_iters: int = 1000,
                              max_pivots: int = 5000,
                              engine: str = "mega", device=None):
    """Exact batched OT crossover on one device.

    The TNET pipeline finds a feasible tree vertex per instance; Borůvka
    over its support (X0 > 1e-12) completes a spanning-tree basis, and the
    transportation simplex pivots it to optimality.

    Args:
        s, d, M: (B, S), (B, D), (B, S, D) numpy arrays or tensors.
        device: where to run (default: M's device, else the CPU).  On CUDA
            the stages run in float32 through the hand-written kernels; on
            the CPU in the input's dtype through their plain versions.

    Returns (X, obj, push_iters, pivots, optimal, basis_mask), batched
    tensors on ``device``; ``network_methods.certify`` recomputes the exact
    f64 vertex from basis_mask.
    """
    if engine != "mega":
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet (ROADMAP 1.8: the parent, "
            "anc, packed and mask engines); use engine='mega'")
    dev = resolve_device(device, M)
    M = to_device(M, dev)
    s = to_device(s, dev, M.dtype)
    d = to_device(d, dev, M.dtype)
    X0, push = _warm_start(s, d, M, reg, sinkhorn_iters)
    support = (X0 > 1e-12).to(M.dtype)
    Bm0 = boruvka_bipartite_mst(support)
    X, Bm, pivots, optimal = batched_transport_simplex_mega(
        X0, Bm0, M, max_pivots=max_pivots)
    obj = (X.to(M.dtype) * M).sum((1, 2))
    return X, obj, push, pivots, optimal, Bm
