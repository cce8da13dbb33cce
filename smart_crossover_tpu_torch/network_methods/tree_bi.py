"""Tree basis identification for TNET, batched (port of
``identify_tree_flows`` from ``smart_crossover_tpu/network_methods/
tree_bi.py``; ``tree_basis_identify`` is not ported yet)."""
from __future__ import annotations

from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
from smart_crossover_tpu_torch.ops.tree import bipartite_tree_solve, push_to_bfs


def identify_tree_flows(W, s, d):
    """Max-weight spanning tree of W (B, S, D), its tree flows for
    supplies s (B, S) and demands d (B, D), pushed to feasibility.
    Returns (X, push_iters (B,))."""
    mask = boruvka_bipartite_mst(W)
    X = bipartite_tree_solve(mask, s, d)
    return push_to_bfs(X)
