"""Rooting a spanning-tree basis as a parent vector, batched.

Port of ``build_parent_from_mask`` from
``smart_crossover_tpu/ops/transport_simplex_parent.py``; the parent-array
pivot engine itself is not ported yet.
"""
from __future__ import annotations

import torch


def build_parent_from_mask(Bm, max_rounds: int | None = None):
    """Root each basis tree Bm (B, S, D) at node 0 (row 0).

    Nodes 0..S-1 are rows, S..S+D-1 columns.  Breadth-first masked
    propagation, O(diameter) rounds.  Returns parent (B, V) int64 with
    parent[root] == root.
    """
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
