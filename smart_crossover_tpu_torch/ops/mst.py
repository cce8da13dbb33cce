"""Borůvka maximum-weight spanning tree on dense bipartite graphs, batched.

Port of ``smart_crossover_tpu/ops/mst.py``.  Edges are totally ordered by
(weight desc, flat edge id asc); every component picks its best outgoing
edge under that strict order, so the tree is unique and equals the JAX
package's.  The TPU expressed each index chase as a one-hot matmul; here
they are native gathers and segment reductions (``gather``,
``scatter_reduce``).
"""
from __future__ import annotations

import math

import torch

NO_EDGE = torch.iinfo(torch.int64).max


def boruvka_bipartite_mst(W):
    """Maximum-weight spanning tree of each complete bipartite graph.

    Args:
        W: (B, S, D) edge weights (finite).

    Returns:
        (B, S, D) boolean masks, each with exactly S + D - 1 True entries.
    """
    B, S, D = W.shape
    V = S + D
    dev = W.device
    max_rounds = int(math.ceil(math.log2(max(V, 2)))) + 2
    jump_rounds = int(math.ceil(math.log2(max(V, 2)))) + 1
    sup_ids = torch.arange(S, device=dev)
    dem_ids = torch.arange(D, device=dev)
    c_ids = torch.arange(V, device=dev).expand(B, V)
    neg_inf = torch.tensor(-math.inf, dtype=W.dtype, device=dev)

    comp = c_ids.clone()
    tree = torch.zeros(B, S * D + 1, dtype=torch.bool, device=dev)
    for _ in range(max_rounds):
        cross = comp[:, :S, None] != comp[:, None, S:]
        Wm = torch.where(cross, W, neg_inf)
        # first maximum = smallest flat edge id along each axis
        best_w_s, best_j = Wm.max(2)
        best_w_d, best_i = Wm.max(1)
        node_w = torch.cat([best_w_s, best_w_d], 1)
        node_eid = torch.cat([sup_ids * D + best_j, best_i * D + dem_ids], 1)
        finite = torch.isfinite(node_w)
        node_eid = torch.where(finite, node_eid, NO_EDGE)

        # per-component champion: max weight, then min edge id
        comp_w = torch.full((B, V), -math.inf, dtype=W.dtype, device=dev)
        comp_w = comp_w.scatter_reduce(1, comp, node_w, "amax")
        is_cand = finite & (node_w == comp_w.gather(1, comp))
        cand_eid = torch.where(is_cand, node_eid, NO_EDGE)
        comp_eid = torch.full((B, V), NO_EDGE, dtype=torch.int64, device=dev)
        comp_eid = comp_eid.scatter_reduce(1, comp, cand_eid, "amin")

        pick = comp_eid < NO_EDGE
        if not bool(pick.any()):
            break
        safe = torch.where(pick, comp_eid, 0)
        tree.scatter_(1, torch.where(pick, safe, S * D), True)

        # hook each picking component onto the component across its edge
        e_cs = comp[:, :S].gather(1, safe // D)
        e_cd = comp[:, S:].gather(1, safe % D)
        other = torch.where(e_cs == c_ids, e_cd, e_cs)
        parent = torch.where(pick, other, c_ids)
        # break mutual (2-cycle) hooks: the smaller label becomes the root
        mutual = parent.gather(1, parent) == c_ids
        parent = torch.where(mutual & (c_ids < parent), c_ids, parent)
        for _ in range(jump_rounds):
            p2 = parent.gather(1, parent)
            if torch.equal(p2, parent):
                break
            parent = p2
        comp = parent.gather(1, comp)
    return tree[:, :S * D].reshape(B, S, D)
