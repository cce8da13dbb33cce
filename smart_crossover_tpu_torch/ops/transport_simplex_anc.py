"""Ancestor-matrix batched transportation simplex.

Port of ``smart_crossover_tpu/ops/transport_simplex_anc.py``
(``build_ancestor_matrix``, ``_cell_values``, ``_row_of``,
``transport_simplex_anc`` with its potential refresh, and the batched
form).  The engine keeps the root-path indicator matrix N (B, V, V) bool,
N[u, w] iff w is on u's root path, and updates it incrementally every
pivot by XOR row algebra over the re-hung subtree; potentials, tree-cell
costs w and flows Xv move by O(V) updates, and the potentials are
recomputed from w every ``refresh`` pivots.  The TPU built N and read
cells by one-hot matmuls; here those are boolean row gathers and
``gather``s.

The batch pivots in lockstep as in ``transport_simplex_parent``: each
instance keeps its own refresh schedule (a refresh, then a chunk of at
most ``refresh`` pivots), an instance whose chunk has ended waits with
masked no-op steps, and the refreshes happen where the host reads the
batch's state, once per ``PIVOT_CHECK_EVERY`` steps.  Each instance walks
exactly the pivots of the JAX engine.
"""
from __future__ import annotations

import math

import torch

from smart_crossover_tpu_torch.ops.transport_simplex_parent import (
    PIVOT_CHECK_EVERY,
    _cell_flat,
    _cell_values,
    _chain,
    _num_levels,
    _price,
    _tree_cells,  # noqa: F401  (read here by the mega module and tests)
    build_parent_from_mask,
    set_cells,
)


def build_ancestor_matrix(parent, dtype=None):
    """N[b, u, w] = True iff w is on u's root path (u and the root
    included), for parent (B, V).  K = ceil(log2 V) doubling rounds:
    N'[u] = N[u] | N[ptr[u]], ptr' = ptr[ptr].  ``dtype`` (the JAX
    package's matmul dtype for its one-hot rounds) is a no-op: N is
    bool."""
    B, V = parent.shape
    b = torch.arange(B, device=parent.device)[:, None]
    N = torch.eye(V, dtype=torch.bool,
                  device=parent.device).expand(B, V, V).clone()
    ptr = parent
    for _ in range(_num_levels(V)):
        N = N | N[b, ptr]
        ptr = ptr.gather(1, ptr)
    return N


def _row_of(N, i):
    """Row i[b] of each instance's ancestor matrix: (B, V)."""
    return N[torch.arange(N.shape[0], device=N.device), i]


def rebuild_plan(parent, Xv, S: int, D: int):
    """Dense plans (B, S, D) from tree flows keyed by child node."""
    B = parent.shape[0]
    flat, notroot = _cell_flat(parent.long(), S, D)
    X = torch.zeros(B, S * D + 1, dtype=Xv.dtype, device=Xv.device)
    X = X.scatter(1, flat, torch.where(notroot, Xv, 0.0))
    return X[:, :S * D].reshape(B, S, D)


def ratio_test(Xv, anc_x, anc_y, S: int):
    """The entering cell's cycle from the root paths of its endpoints:
    (sign, theta, cl).  Cycle edges are keyed by child node (anc_x ^ anc_y);
    x_end is a row node, so a cycle cell changes by -theta iff it is on x's
    branch and keyed by a row node, or on y's and keyed by a column node.
    theta is the least flow on a decreasing cell; the leaving arc cl is
    the lowest node id with a ratio within 1e-12 of it."""
    V = Xv.shape[1]
    vids = torch.arange(V, device=Xv.device)
    is_row = vids < S
    oncycle = anc_x ^ anc_y
    one = torch.ones((), dtype=Xv.dtype, device=Xv.device)
    sign = torch.where(anc_x, torch.where(is_row, -one, one),
                       torch.where(is_row, one, -one))
    sign = torch.where(oncycle, sign, 0.0)
    ratios = torch.where(oncycle & (sign < 0), Xv, math.inf)
    theta = ratios.amin(1)
    cl = torch.where(ratios <= (theta + 1e-12)[:, None], vids, V).argmin(1)
    return sign, theta, cl


def tree_pivot(st, go, dmin, ei, ej, anc_x, anc_y, sign, theta, cl, C):
    """The O(V) part of a pivot the anc and packed engines share, for the
    instances where ``go`` holds: the potential shift on the re-hung
    subtree C (B, V), the re-keying of w and Xv along the reversed path
    e_same..cl, the parent update and the pricing mask.  Reads the state
    before the pivot and writes pot, w, Xv, parent and mask of ``st``;
    returns on_x (whether cl is on x_end's branch) for the N update."""
    M, parent, dep, pot, w, Xv, mask = (st["M"], st["parent"], st["dep"],
                                        st["pot"], st["w"], st["Xv"],
                                        st["mask"])
    B, S, D = M.shape
    V = S + D
    dev = M.device
    b = torch.arange(B, device=dev)
    vids = torch.arange(V, device=dev)
    is_row = vids < S
    x_end, y_end = ei, S + ej

    on_x = anc_x[b, cl]
    e_same = torch.where(on_x, x_end, y_end)
    e_other = torch.where(on_x, y_end, x_end)
    n_es = torch.where(on_x[:, None], anc_x, anc_y)

    # potentials: the entering arc prices to zero across C's boundary;
    # within C relative potentials are unchanged
    row_shift = torch.where(on_x, dmin, -dmin)
    shift = torch.where(is_row, row_shift[:, None], -row_shift[:, None])
    pot_new = pot + torch.where(C, shift, 0.0)
    # the entering cell's cost: after the shift it prices to zero
    m_enter = pot_new[b, x_end] + pot_new[b, y_end]

    # the reversed path segment e_same..cl re-keys every edge child ->
    # old parent; cl's old slot (the leaving arc) takes its on-path
    # child's values; targets along a root path are distinct
    seg = n_es & (dep >= dep[b, cl][:, None])
    src = seg & (vids != cl[:, None])
    Xv_upd = Xv + sign * theta[:, None]
    tgt = torch.where(src, parent, V)
    child = torch.full((B, V + 1), -1, dtype=parent.dtype,
                       device=dev).scatter(1, tgt, vids.expand(B, V))[:, :V]
    hit = child >= 0
    chc = child.clamp(min=0)
    es = vids == e_same[:, None]
    Xv_new = torch.where(es, theta[:, None],
                         torch.where(hit, Xv_upd.gather(1, chc), Xv_upd))
    w_new = torch.where(es, m_enter[:, None],
                        torch.where(hit, w.gather(1, chc), w))
    parent_new = torch.where(es, e_other[:, None],
                             torch.where(seg & hit, child, parent))

    p_cl = parent[b, cl]
    li = torch.where(cl < S, cl, p_cl)
    lj = torch.where(cl < S, p_cl - S, cl - S)

    g = go[:, None]
    st["pot"] = torch.where(g, pot_new, pot)
    st["Xv"] = torch.where(g, Xv_new, Xv)
    st["w"] = torch.where(g, w_new, w)
    st["parent"] = torch.where(g, parent_new, parent)
    set_cells(mask, go, ei * D + ej, True)
    # (li, lj) is a tree cell where go holds; clamped for the others
    set_cells(mask, go, (li * D + lj).clamp(0, S * D - 1), False)
    return on_x


def setup_state(X, Bm, M, max_pivots: int):
    """The state both incremental engines start from: the rooted tree, the
    tree cells' costs w and flows Xv, and the lockstep schedule (every
    instance first refreshes its potentials)."""
    B, S, D = M.shape
    V = S + D
    dev = M.device
    Bm = Bm.to(torch.bool)
    parent = build_parent_from_mask(Bm)
    finished = torch.full((B,), max_pivots <= 0, dtype=torch.bool,
                          device=dev)
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    return {"M": M, "mask": Bm.clone(), "parent": parent,
            "w": _cell_values(M, parent),
            "Xv": _cell_values(X.to(M.dtype), parent),
            "pot": torch.zeros(B, V, dtype=M.dtype, device=dev),
            "it": zeros, "start": zeros.clone(), "finished": finished,
            "need_refresh": ~finished}


def refresh(st):
    """Exact potentials from the (exactly re-keyed) tree costs, for the
    instances whose chunk has ended; their next chunk starts here."""
    r = st["need_refresh"] & ~st["finished"]
    K = _num_levels(st["parent"].shape[1])
    pot = _chain(st["parent"], st["w"], K)[2]
    st["pot"] = torch.where(r[:, None], pot, st["pot"])
    st["start"] = torch.where(r, st["it"], st["start"])
    st["need_refresh"] = st["need_refresh"] & ~r


def close_step(st, active, now_done, go, refresh_every: int,
               max_pivots: int):
    """The schedule after one lockstep step.  Right after a refresh
    (it == start) an instance whose pricing finds no entering cell is
    optimal; later in a chunk that only ends the chunk (the drifted
    potentials say done), as does reaching ``refresh_every`` pivots in
    it; an instance at ``max_pivots`` is finished."""
    fresh = st["it"] == st["start"]
    st["finished"] |= active & now_done & fresh
    st["it"] += go
    it = st["it"]
    chunk_end = active & ~(now_done & fresh) & (
        now_done | (it >= st["start"] + refresh_every) | (it >= max_pivots))
    capped = chunk_end & (it >= max_pivots)
    st["finished"] |= capped
    st["need_refresh"] |= chunk_end & ~capped


def run_refresh_rounds(step, st: dict, every: int = PIVOT_CHECK_EVERY):
    """Refresh where needed, then ``every`` lockstep steps, until every
    instance is finished; one host read per round."""
    while True:
        flags = torch.stack([st["finished"].all(),
                             st["need_refresh"].any()]).tolist()
        if flags[0]:
            return st
        if flags[1]:
            refresh(st)
        for _ in range(every):
            step(st)


def _anc_step(st, tol: float, refresh_every: int, max_pivots: int):
    """One pivot of the ancestor-matrix engine (``pivot_body``) for the
    instances between refreshes."""
    M, N, dep = st["M"], st["N"], st["dep"]
    B, S = M.shape[:2]
    b = torch.arange(B, device=M.device)
    active = ~st["finished"] & ~st["need_refresh"]
    dmin, ei, ej = _price(M, st["mask"], st["pot"])
    now_done = dmin >= -tol
    go = active & ~now_done
    anc_x = _row_of(N, ei)
    anc_y = _row_of(N, S + ej)
    sign, theta, cl = ratio_test(st["Xv"], anc_x, anc_y, S)
    # the re-hung component C = the old subtree of cl: column cl of N
    C = N[b, :, cl]
    on_x = tree_pivot(st, go, dmin, ei, ej, anc_x, anc_y, sign, theta, cl,
                      C)
    n_es = torch.where(on_x[:, None], anc_x, anc_y)
    n_eo = torch.where(on_x[:, None], anc_y, anc_x)
    # N rows of C: (N ^ n_es) | the LCA bit | n_eo, where the LCA of u and
    # e_same is the deepest node their root paths share
    common = N & n_es[:, None, :]
    lca_dep = torch.where(common, dep[:, None, :], -1).amax(2)
    lca_bit = common & (dep[:, None, :] == lca_dep[:, :, None])
    N_new = (N ^ n_es[:, None, :]) | lca_bit | n_eo[:, None, :]
    st["N"] = N = torch.where((C & go[:, None])[:, :, None], N_new, N)
    st["dep"] = N.sum(2) - 1
    close_step(st, active, now_done, go, refresh_every, max_pivots)


def batched_transport_simplex_anc(X, Bm, M, s=None, d=None,
                                  tol: float = 1e-7, max_pivots: int = 5000,
                                  refresh: int = 128):
    """Pivot a batch of basic feasible transport plans to optimality
    (ancestor matrix).

    Contract of the JAX package's ``batched_transport_simplex_anc``: X
    (B, S, D) basic feasible plans (s and d are not read), Bm (B, S, D)
    spanning-tree basis masks, M (B, S, D) costs, all on one device; the
    pivots run in M's dtype.  Returns (X_opt, Bm_opt, pivots, optimal)
    with batch dims: the plan and the basis are rebuilt from the final
    tree.
    """
    B, S, D = M.shape
    st = setup_state(X, Bm, M, max_pivots)
    st["N"] = build_ancestor_matrix(st["parent"])
    st["dep"] = st["N"].sum(2) - 1
    run_refresh_rounds(
        lambda st_: _anc_step(st_, tol, refresh, max_pivots), st)
    parent = st["parent"]
    X_out = rebuild_plan(parent, st["Xv"], S, D)
    flat, notroot = _cell_flat(parent, S, D)
    Bm_out = torch.zeros(B, S * D + 1, dtype=torch.bool, device=M.device)
    Bm_out = Bm_out.scatter(1, flat, notroot)[:, :S * D].reshape(B, S, D)
    pot = _chain(parent, st["w"], _num_levels(S + D))[2]
    optimal = _price(M, Bm_out, pot)[0] >= -tol
    return X_out.clamp(min=0.0), Bm_out, st["it"], optimal


def transport_simplex_anc(X, Bm, M, s=None, d=None, tol: float = 1e-7,
                          max_pivots: int = 5000, refresh: int = 128):
    """One instance: X, Bm, M (S, D).  Returns (X_opt, Bm_opt, pivots,
    optimal)."""
    out = batched_transport_simplex_anc(X[None], Bm[None], M[None], tol=tol,
                                        max_pivots=max_pivots,
                                        refresh=refresh)
    return tuple(o[0] for o in out)
