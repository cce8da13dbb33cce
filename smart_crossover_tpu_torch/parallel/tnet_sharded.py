"""Model-parallel TNET: ONE large OT instance sharded across the mesh.

Port of ``smart_crossover_tpu/parallel/tnet_sharded.py``.  The demand axis
is split over the mesh's 'model' axis: each rank owns W[:, j0:j0+Dloc], so
a demander's edge column is local while supplier-side reductions cross
ranks.  The four stages:

* Sinkhorn        — row logsumexp by MAX then SUM all-reduce
                    (``parallel/projector.py``);
* Borůvka MST     — each supplier's best edge by a two-phase reduction
                    (MAX weight, then MIN global edge id among the ranks
                    at that weight); component bookkeeping on replicated
                    (S + D) vectors;
* tree solve      — leaf elimination; demander side local, supplier side
                    all-reduced;
* irrigation push — the global argmin / argmax through the same two-phase
                    reduction.

The JAX module writes each index chase as a one-hot matmul for the TPU;
here they are gathers and segment reductions (``index_select``,
``scatter_reduce``, ``index_add_``).  Ties break as there: the largest
weight, then the smallest global id ``i * D + j``; a local argmax or
argmin takes the first occurrence.  Every loop condition is read from an
all-reduced value, the same on every rank.
"""
from __future__ import annotations

import math

import torch

from smart_crossover_tpu_torch.config import to_device
from smart_crossover_tpu_torch.parallel.mesh import MODEL_AXIS
from smart_crossover_tpu_torch.parallel.projector import (
    sinkhorn_potentials_sharded,
)

# the JAX package's int32 sentinel; ids are int64 here and every edge id
# i * D + j of an instance below 2^31 cells compares under it as there
_BIG_ID = torch.iinfo(torch.int32).max
# push steps and leaf-elimination rounds between two host reads of the
# all-reduced loop condition; a step past the end changes nothing
_PUSH_CHECK_EVERY = 16
_SOLVE_CHECK_EVERY = 8


def _global_best(mesh, w_loc, id_loc):
    """Two-phase cross-rank argmax, elementwise: (max weight, min global
    id among the entries at that weight; _BIG_ID where it is -inf)."""
    wmax = mesh.max(w_loc)
    cand = torch.where((w_loc == wmax) & torch.isfinite(wmax), id_loc,
                       _BIG_ID)
    return wmax, mesh.min(cand)


def _boruvka(mesh, W, S, D, j0):
    """The maximum-weight spanning tree of the complete bipartite graph on
    W's (S, D) weights, W column-sharded; returns this rank's (S, Dloc)
    block of the tree mask."""
    Dloc = W.shape[1]
    V = S + D
    dev = W.device
    jump_rounds = int(math.ceil(math.log2(max(V, 2)))) + 1
    mst_rounds = int(math.ceil(math.log2(max(V, 2)))) + 2
    srows = torch.arange(S, device=dev)
    gcols = j0 + torch.arange(Dloc, device=dev)
    cid = torch.arange(V, device=dev)
    neg_inf = torch.tensor(-math.inf, dtype=W.dtype, device=dev)
    comp = cid.clone()
    # one spare cell takes the marks of edges outside this rank's block
    tree = torch.zeros(S * Dloc + 1, dtype=torch.bool, device=dev)
    for _ in range(mst_rounds):
        comp_s = comp[:S]
        comp_dl = comp[S + j0:S + j0 + Dloc]
        Wm = torch.where(comp_s[:, None] != comp_dl[None, :], W, neg_inf)
        # each supplier's best edge across ranks
        bw_s, bj = Wm.max(1)
        eid_s = torch.where(torch.isfinite(bw_s), srows * D + j0 + bj,
                            _BIG_ID)
        bw_s, eid_s = _global_best(mesh, bw_s, eid_s)
        # each local demander's best edge
        bw_d, bi = Wm.max(0)
        eid_d = torch.where(torch.isfinite(bw_d), bi * D + gcols, _BIG_ID)

        # component champions: the largest weight, then the smallest id
        comp_w = torch.full((V,), -math.inf, dtype=W.dtype, device=dev)
        comp_w = comp_w.scatter_reduce(0, comp_s, bw_s, "amax")
        comp_w_d = torch.full_like(comp_w, -math.inf).scatter_reduce(
            0, comp_dl, bw_d, "amax")
        comp_w = torch.maximum(comp_w, mesh.max(comp_w_d))
        comp_w = torch.where(torch.isfinite(comp_w), comp_w, -1e30)
        big = torch.full((V,), _BIG_ID, dtype=torch.int64, device=dev)
        comp_eid = big.scatter_reduce(
            0, comp_s, torch.where(bw_s == comp_w[comp_s], eid_s, _BIG_ID),
            "amin")
        comp_eid_d = big.scatter_reduce(
            0, comp_dl, torch.where(bw_d == comp_w[comp_dl], eid_d, _BIG_ID),
            "amin")
        comp_eid = torch.minimum(comp_eid, mesh.min(comp_eid_d))

        pick = comp_eid < _BIG_ID
        if not bool(pick.any()):           # replicated: alike on every rank
            break
        safe = torch.where(pick, comp_eid, 0)
        pi = safe // D
        pj = safe % D
        in_block = pick & (pj >= j0) & (pj < j0 + Dloc)
        tree[torch.where(in_block, pi * Dloc + pj - j0, S * Dloc)] = True
        # hook each picking component onto the one across its edge, break
        # mutual hooks towards the smaller label, then pointer-jump
        e_cs = comp[pi]
        e_cd = comp[S + pj]
        parent = torch.where(pick, torch.where(e_cs == cid, e_cd, e_cs), cid)
        mutual = parent[parent] == cid
        parent = torch.where(mutual & (cid < parent), cid, parent)
        for _ in range(jump_rounds):
            parent = parent[parent]
        comp = parent[comp]
    return tree[:S * Dloc].reshape(S, Dloc)


def _tree_solve(mesh, act, s_full, d_loc):
    """Flows on the column-sharded spanning tree ``act`` with row sums
    s_full and this rank's column sums d_loc, by leaf elimination."""
    S, Dloc = act.shape
    dt = s_full.dtype
    rs = s_full.clone()
    rd = d_loc.clone()
    X = torch.zeros(S, Dloc, dtype=dt, device=act.device)
    for r in range(S + mesh.size(MODEL_AXIS) * Dloc + 2):
        if r % _SOLVE_CHECK_EVERY == 0 and not bool(mesh.sum(act.sum()) > 0):
            break
        leaf_s = mesh.sum(act.sum(1)) == 1
        oh_j = (act & leaf_s[:, None]).to(dt)
        flow_s = torch.where(leaf_s, rs, 0.0)
        X = X + flow_s[:, None] * oh_j
        rd = rd - (flow_s[:, None] * oh_j).sum(0)
        rs = rs - flow_s
        act = act & ~leaf_s[:, None]

        leaf_d = act.sum(0) == 1
        oh_i = (act & leaf_d[None, :]).to(dt)
        flow_d = torch.where(leaf_d, rd, 0.0)
        X = X + flow_d[None, :] * oh_i
        rs = rs - mesh.sum((oh_i * flow_d[None, :]).sum(1))
        rd = rd - flow_d
        act = act & ~leaf_d[None, :]
    return X


def _push(mesh, X, D, j0, cap: int):
    """Irrigation push of the column-sharded signed tree flows X to
    feasibility: while the global min is negative, take its cell (I1, J1)
    (the smallest global id among equal minima), J2 = argmax of row I1,
    I2 = argmax of column J1, and shift theta = min(-X[I1,J1], X[I1,J2],
    X[I2,J1]) around the 4-cycle.  Indices stay (1,)-tensors on the device
    (a 0-d index would be read on the host).  Returns (X, pushes)."""
    S, Dloc = X.shape
    dev = X.device
    flat = X.view(-1)
    inf = torch.tensor(math.inf, dtype=X.dtype, device=dev)

    def cell(i, j):
        """(flat index into this rank's block, whether it owns column j)."""
        own = (j >= j0) & (j < j0 + Dloc)
        return i * Dloc + torch.where(own, j - j0, 0), own

    pushes = torch.zeros(1, dtype=torch.int64, device=dev)
    steps = 0
    while steps < cap:
        for _ in range(min(_PUSH_CHECK_EVERY, cap - steps)):
            lmin, lid = flat.min(0, keepdim=True)
            gid = (lid // Dloc) * D + j0 + lid % Dloc
            negmin, gmin = _global_best(mesh, -lmin, gid)
            active = negmin > 0             # the global min is negative
            I1 = gmin // D
            J1 = gmin % D
            # J2 = argmax of row I1 (across ranks); I2 = argmax of column
            # J1 (on its owner): one two-phase reduction for both
            rowv = X.index_select(0, I1).view(-1)
            j2l = rowv.argmax(0, keepdim=True)
            k1, own1 = cell(torch.zeros_like(J1), J1)
            colv = torch.where(own1, X.index_select(1, k1).view(-1), -inf)
            i2l = colv.argmax(0, keepdim=True)
            _, best = _global_best(mesh, torch.cat([rowv[j2l], colv[i2l]]),
                                   torch.cat([j0 + j2l, i2l]))
            J2, I2 = best[:1], best[1:]
            cells = [cell(I1, J1), cell(I1, J2), cell(I2, J1)]
            x11, x12, x21 = mesh.max(torch.cat(
                [torch.where(own, flat[k], -inf) for k, own in cells]))
            theta = torch.minimum(torch.minimum(-x11, x12), x21)
            theta = torch.where(active, theta, 0.0)
            for (k, own), delta in zip(cells + [cell(I2, J2)],
                                       (theta, -theta, -theta, theta)):
                flat.index_add_(0, k, torch.where(own, delta, 0.0))
            pushes += active
            steps += 1
        if not bool(mesh.min(flat.amin()) < 0):
            break
    return X, pushes


def sharded_tnet_single(mesh, s, d, M, reg: float = 0.01,
                        sinkhorn_iters: int = 200,
                        push_iters_cap: int = 100_000):
    """Run the TNET basis-identification pipeline on one sharded OT.

    Args:
        mesh: a mesh whose 'model' width divides D.
        s: (S,), d: (D,), M: (S, D).

    Returns:
        (X, push_iters): the (S, D) basic feasible vertex flow (gathered,
        float64 numpy) and the push-iteration count.
    """
    S, D = M.shape
    j0, j1 = mesh.slice(MODEL_AXIS, D)
    M_loc = to_device(M[:, j0:j1], mesh.device)
    dt = M_loc.dtype
    s_full = to_device(s, mesh.device, dt)
    d_loc = to_device(d[j0:j1], mesh.device, dt)
    eps = reg * mesh.max(M_loc.amax())

    # Sinkhorn, then rounding to the exact sharded marginals
    f, g = sinkhorn_potentials_sharded(mesh, s_full, d_loc, M_loc, eps,
                                       sinkhorn_iters)
    X = torch.exp((f[:, None] + g[None, :] - M_loc) / eps)
    row = mesh.sum(X.sum(1))
    X = X * torch.clamp(s_full / torch.where(row > 0, row, 1.0),
                        max=1.0)[:, None]
    col = X.sum(0)
    X = X * torch.clamp(d_loc / torch.where(col > 0, col, 1.0),
                        max=1.0)[None, :]
    err_r = s_full - mesh.sum(X.sum(1))
    err_c = d_loc - X.sum(0)
    tot = mesh.sum(err_c.sum())
    X = X + torch.outer(err_r, err_c) / torch.where(tot > 0, tot, 1.0)

    # flow indicators, the tree, its flows, then the push
    W = torch.maximum(X / s_full[:, None], X / d_loc[None, :])
    tree = _boruvka(mesh, W, S, D, j0)
    Xt = _tree_solve(mesh, tree, s_full, d_loc)
    Xt, push_n = _push(mesh, Xt, D, j0, push_iters_cap)
    X = mesh.gather(Xt, MODEL_AXIS, dim=1)
    return X.to("cpu", torch.float64).numpy(), int(push_n)
