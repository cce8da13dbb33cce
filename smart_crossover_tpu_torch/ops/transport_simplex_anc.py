"""Root-path (ancestor) matrix and tree cells of a rooted basis tree.

Port of ``build_ancestor_matrix`` and ``_tree_cells`` from
``smart_crossover_tpu/ops/transport_simplex_anc.py``; the ancestor-matrix
pivot engine itself is not ported yet.  The TPU built N by one-hot
matmuls; here each doubling round is a boolean row gather.
"""
from __future__ import annotations

import torch


def _num_levels(V: int) -> int:
    K = 1
    while (1 << K) < V:
        K += 1
    return K


def build_ancestor_matrix(parent):
    """N[b, u, w] = True iff w is on u's root path (u and the root
    included), for parent (B, V).  K = ceil(log2 V) doubling rounds:
    N'[u] = N[u] | N[ptr[u]], ptr' = ptr[ptr]."""
    B, V = parent.shape
    b = torch.arange(B, device=parent.device)[:, None]
    N = torch.eye(V, dtype=torch.bool,
                  device=parent.device).expand(B, V, V).clone()
    ptr = parent
    for _ in range(_num_levels(V)):
        N = N | N[b, ptr]
        ptr = ptr.gather(1, ptr)
    return N


def _tree_cells(parent, S: int, D: int):
    """Tree cell (row ci, column cj) keyed by each non-root node, and the
    non-root mask, for parent (B, V)."""
    V = S + D
    vids = torch.arange(V, device=parent.device)
    is_row = vids < S
    ci = torch.where(is_row, vids, parent)
    cj = torch.where(is_row, parent - S, vids - S)
    return ci, cj, parent != vids
