"""Parent-array batched transportation simplex, and the helpers every
device pivot engine shares.

Port of ``smart_crossover_tpu/ops/transport_simplex_parent.py``
(``_chain``, ``_root_paths2``, ``transport_simplex_parent`` and its
batched form; its ``build_parent_from_mask`` is in ``ops/tree.py``, one
launch of the tree walk kernel on a card).  The basis tree is a
``parent`` vector over the V = S + D nodes (rows 0..S-1, columns S..V-1)
and every per-pivot step is O(V log V) work by binary lifting.  The TPU
expressed each lifting round as a one-hot matmul over float node ids under
``Precision.HIGHEST``; here the tables are int64 node ids and every round
is a ``gather`` (the values are the same: a one-hot product picks one term
exactly).

The JAX engine is a ``lax.while_loop`` vmapped over the batch.  Here the
batch pivots in lockstep, one pivot step for every instance at a time: an
instance that is done (optimal, or at ``max_pivots``) takes masked no-op
steps, each instance counts its own pivots, and the host reads "any
instance still pivoting" once per ``PIVOT_CHECK_EVERY`` steps
(``run_lockstep``).  Each instance walks exactly the pivots the JAX engine
walks.
"""
from __future__ import annotations

import math

import torch

# the parent vector lives beside its kernel in ops/tree.py; its names stay
# importable here for this engine, the anc engine and the tests
from smart_crossover_tpu_torch.ops.tree import (  # noqa: F401
    build_parent_from_mask,
    build_parent_from_mask_plain,
)

# pivot steps between two host reads of "any instance still pivoting"; a
# finished instance's steps in between are masked no-ops
PIVOT_CHECK_EVERY = 16


def _num_levels(V: int) -> int:
    K = 1
    while (1 << K) < V:
        K += 1
    return K


def _tree_cells(parent, S: int, D: int):
    """Tree cell (row ci, column cj) keyed by each non-root node, and the
    non-root mask, for parent (B, V)."""
    V = S + D
    vids = torch.arange(V, device=parent.device)
    is_row = vids < S
    ci = torch.where(is_row, vids, parent)
    cj = torch.where(is_row, parent - S, vids - S)
    return ci, cj, parent != vids


def _cell_flat(parent, S: int, D: int):
    """Flat cell index ci * D + cj of each node's tree cell (S * D at the
    root, one past the last cell) and the non-root mask."""
    ci, cj, notroot = _tree_cells(parent, S, D)
    return torch.where(notroot, ci * D + cj, S * D), notroot


def _cell_values(A, parent):
    """A[b, ci(v), cj(v)] for every non-root node v, 0 at the root: the
    JAX package's one-hot products (``_cell_onehots``, ``_cell_values``),
    which pick one term exactly, as a gather."""
    B, S, D = A.shape
    flat, notroot = _cell_flat(parent, S, D)
    vals = A.reshape(B, -1).gather(1, flat.clamp(max=S * D - 1))
    return torch.where(notroot, vals, 0.0)


def _chain(parent, w, K: int):
    """K doubling rounds over parent (B, V): the lifting tables (ptr after
    2^k hops, as node ids), the depths and the dual potentials with
    pot[v] = w[v] - pot[parent(v)], in the JAX package's operation order
    (the (acc, sgn) pair composes the affine recursion)."""
    V = parent.shape[1]
    isroot = parent == torch.arange(V, device=parent.device)
    dep = (~isroot).to(torch.int64)
    acc = torch.where(isroot, 0.0, w)
    sgn = torch.where(isroot, 0.0, -1.0).to(w.dtype)
    ptr = parent
    tabs = []
    for _ in range(K):
        tabs.append(ptr)
        g_dep, g_acc, g_sgn = (t.gather(1, ptr) for t in (dep, acc, sgn))
        dep = dep + g_dep
        acc = acc + sgn * g_acc
        sgn = sgn * g_sgn
        ptr = ptr.gather(1, ptr)
    return tabs, dep, acc


def _root_paths2(x_end, y_end, tabs):
    """Root-path indicators (B, V) of the endpoints x_end, y_end (B,):
    path[v] iff v is x's ancestor (x and the root included).  Each lifting
    level adds every node reached so far moved up by that level's jump,
    summed as counts (a deterministic integer scatter-add), as the JAX
    package sums its one-hot products."""
    B, V = tabs[0].shape
    paths = torch.zeros(B, 2, V, dtype=torch.int32, device=x_end.device)
    b = torch.arange(B, device=x_end.device)
    paths[b, 0, x_end] = 1
    paths[b, 1, y_end] = 1
    for tab in tabs:
        paths = paths + torch.zeros_like(paths).scatter_add_(
            2, tab[:, None, :].expand(B, 2, V), paths)
    return paths[:, 0] > 0, paths[:, 1] > 0


def _price(M, mask, pot):
    """Dantzig pricing over the non-basic cells of M - u - v: (dmin, ei,
    ej), ties to the lowest flat index."""
    B, S, D = M.shape
    delta = torch.where(mask, 0.0, M - pot[:, :S, None] - pot[:, None, S:])
    dmin, flat = delta.reshape(B, -1).min(1)
    return dmin, flat // D, flat % D


def _optimal(M, mask, parent, tol):
    """The JAX engines' exit test: potentials from the tree costs, then
    every non-basic reduced cost >= -tol."""
    pot = _chain(parent, _cell_values(M, parent),
                 _num_levels(M.shape[1] + M.shape[2]))[2]
    return _price(M, mask, pot)[0] >= -tol


def set_cells(mask, go, flat, value: bool) -> None:
    """mask.view(B, -1)[b, flat[b]] = value for the instances where go[b]
    holds, in place and without a host read (indexing by a boolean mask
    would wait for the device to count it)."""
    m = mask.view(mask.shape[0], -1)
    idx = flat[:, None]
    cur = m.gather(1, idx)
    m.scatter_(1, idx, cur | go[:, None] if value else cur & ~go[:, None])


def run_lockstep(step, st: dict, every: int = PIVOT_CHECK_EVERY) -> dict:
    """Call ``step(st)`` until every instance is finished
    (``st["finished"]`` (B,) bool), reading the host once per ``every``
    steps."""
    while not bool(st["finished"].all()):
        for _ in range(every):
            step(st)
    return st


def _parent_step(st, M, tol: float, max_pivots: int, K: int):
    """One pivot of the parent-array engine for every instance that is not
    finished (``transport_simplex_parent``'s loop body)."""
    X, Bm, parent = st["X"], st["Bm"], st["parent"]
    B, S, D = M.shape
    V = S + D
    SD = S * D
    dev = M.device
    b = torch.arange(B, device=dev)
    vids = torch.arange(V, device=dev)

    flat, notroot = _cell_flat(parent, S, D)
    Xf = X.reshape(B, -1)
    Xv = torch.where(notroot, Xf.gather(1, flat.clamp(max=SD - 1)), 0.0)
    tabs, dep, pot = _chain(parent, _cell_values(M, parent), K)
    dmin, ei, ej = _price(M, Bm, pot)
    done = dmin >= -tol
    go = ~st["finished"] & ~done
    x_end, y_end = ei, S + ej

    anc_x, anc_y = _root_paths2(x_end, y_end, tabs)
    oncycle = (anc_x ^ anc_y) & notroot
    # bipartite alternation: the tree cell at child c changes by -theta
    # when the hop count from its endpoint is even
    par_x = (dep[b, x_end][:, None] - dep) % 2 == 0
    par_y = (dep[b, y_end][:, None] - dep) % 2 == 0
    one = torch.ones((), dtype=M.dtype, device=dev)
    sign = torch.where(anc_x, torch.where(par_x, -one, one),
                       torch.where(par_y, -one, one))
    sign = torch.where(oncycle, sign, 0.0)
    ratios = torch.where(oncycle & (sign < 0), Xv, math.inf)
    theta = ratios.amin(1)
    # leaving arc: min ratio, smallest node index tie-break
    cl = torch.where(ratios <= (theta + 1e-12)[:, None], vids, V).argmin(1)
    lflat = flat[b, cl].clamp(max=SD - 1)

    # X update: the cycle's tree cells move by sign * theta (distinct
    # cells, one term each, as the JAX one-hot product), the entering
    # cell by +theta
    upd = torch.zeros(B, SD + 1, dtype=M.dtype, device=dev).scatter(
        1, flat, sign * theta[:, None])[:, :SD]
    ent = torch.zeros(B, SD, dtype=M.dtype, device=dev)
    ent[b, ei * D + ej] = theta
    X_new = (Xf + upd + ent).clamp(min=0.0)
    X_new[b, lflat] = 0.0

    # tree update: reverse the path from the entering endpoint on the
    # leaving arc's side up to cl, then hang that endpoint off the other
    # endpoint through the entering arc; the on-path child of a path node
    # is the unique path node whose parent it is
    on_x = anc_x[b, cl]
    e_same = torch.where(on_x, x_end, y_end)
    e_other = torch.where(on_x, y_end, x_end)
    anc_e = torch.where(on_x[:, None], anc_x, anc_y)
    tgt = torch.where(anc_e & notroot, parent, V)
    child = torch.zeros(B, V + 1, dtype=parent.dtype, device=dev).scatter(
        1, tgt, vids.expand(B, V))[:, :V]
    seg = anc_e & (dep >= dep[b, cl][:, None])
    parent_new = torch.where(seg, child, parent)
    parent_new[b, e_same] = e_other

    g = go[:, None]
    st["X"] = torch.where(g, X_new, Xf).reshape(B, S, D)
    st["parent"] = torch.where(g, parent_new, parent)
    set_cells(Bm, go, ei * D + ej, True)
    set_cells(Bm, go, lflat, False)
    st["it"] += go
    st["finished"] |= done | (st["it"] >= max_pivots)


def batched_transport_simplex_parent(X, Bm, M, s=None, d=None,
                                     tol: float = 1e-7,
                                     max_pivots: int = 5000):
    """Pivot a batch of basic feasible transport plans to optimality
    (parent array).

    Contract of the JAX package's ``batched_transport_simplex_parent``:
    X (B, S, D) basic feasible plans (row sums s, column sums d; s and d
    are not read), Bm (B, S, D) spanning-tree basis masks, M (B, S, D)
    costs, all on one device; the pivots run in M's dtype.  Returns
    (X_opt, Bm_opt, pivots, optimal) with batch dims.
    """
    B, S, D = M.shape
    st = {"X": X.to(M.dtype).clone(), "Bm": Bm.to(torch.bool).clone(),
          "parent": build_parent_from_mask(Bm.to(torch.bool)),
          "it": torch.zeros(B, dtype=torch.int64, device=M.device),
          "finished": torch.full((B,), max_pivots <= 0, dtype=torch.bool,
                                 device=M.device)}
    K = _num_levels(S + D)
    run_lockstep(lambda st_: _parent_step(st_, M, tol, max_pivots, K), st)
    optimal = _optimal(M, st["Bm"], st["parent"], tol)
    return st["X"], st["Bm"], st["it"], optimal


def transport_simplex_parent(X, Bm, M, s=None, d=None, tol: float = 1e-7,
                             max_pivots: int = 5000):
    """One instance: X, Bm, M (S, D).  Returns (X_opt, Bm_opt, pivots,
    optimal)."""
    out = batched_transport_simplex_parent(X[None], Bm[None], M[None],
                                           tol=tol, max_pivots=max_pivots)
    return tuple(o[0] for o in out)
