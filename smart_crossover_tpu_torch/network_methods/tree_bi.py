"""Tree basis identification for TNET (port of
``smart_crossover_tpu/network_methods/tree_bi.py``).

``identify_tree_flows`` is batched; ``tree_basis_identify`` runs it on
one instance (B = 1) on its manager's device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from smart_crossover_tpu_torch.config import to_device
from smart_crossover_tpu_torch.models import Basis
from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
from smart_crossover_tpu_torch.ops.tree import bipartite_tree_solve, push_to_bfs
from smart_crossover_tpu_torch.utils import trace

# a tree flow above this is basic (the JAX package's 10 * 1e-9)
BASIC_FLOW = 1e-8


def tree_basis_identify(ot_manager, flow_weights: np.ndarray
                        ) -> Tuple[Basis, int]:
    """A feasible tree basis of the manager's OT instance: the max-weight
    spanning tree of the flow indicators, its tree flows, pushed to
    feasibility.

    Unlike the JAX package, the grid is not padded to multiples of 64 with
    1e-9-mass nodes: that padding only let instances share one XLA
    compile.  d is still rebalanced to sum(s), as there.

    Returns the basis (vbasis over the s*d grid, cbasis = [-1]*(m-1) + [0])
    and the number of push iterations.
    """
    ot = ot_manager.ot
    ns, nd = ot.s.size, ot.d.size
    dev = ot_manager.device
    d = ot.d * (ot.s.sum() / ot.d.sum())
    W = to_device(np.asarray(flow_weights).reshape(1, ns, nd), dev)
    X, push_iter = identify_tree_flows(W, to_device(ot.s[None], dev, W.dtype),
                                       to_device(d[None], dev, W.dtype))
    vbasis = np.full(ns * nd, -1, dtype=np.int32)
    vbasis[X[0].reshape(-1).cpu().numpy() > BASIC_FLOW] = 0
    cbasis = np.concatenate([-np.ones(ot_manager.m - 1, dtype=np.int32), [0]])
    return Basis(vbasis, cbasis), int(push_iter[0])


def identify_tree_flows(W, s, d):
    """Max-weight spanning tree of W (B, S, D), its tree flows for
    supplies s (B, S) and demands d (B, D), pushed to feasibility.
    Returns (X, push_iters (B,))."""
    with trace.span("scx.boruvka_flow", W.device):
        mask = boruvka_bipartite_mst(W)
    with trace.span("scx.tree_solve", W.device):
        X = bipartite_tree_solve(mask, s, d)
    with trace.span("scx.push", W.device):
        return push_to_bfs(X)
