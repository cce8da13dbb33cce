"""Batched transportation simplex with the whole pivot loop on the card.

Replaces the TPU kernel ``smart_crossover_tpu/ops/transport_simplex_mega.py::
_mega_kernel`` (wrapper ``batched_transport_simplex_mega``).  The CUDA
kernel (``csrc/transport_simplex_mega.cu``) runs one instance per thread
block, the whole solve in one launch; the plain version here runs the same
algorithm as batched tensor code, one Python-driven pivot step for the
whole batch at a time, finished instances masked.  Both keep the TPU
kernel's pivot rule exactly:

* pricing: Dantzig over non-basic cells of M - u - v, ties to the lowest
  flat index; optimal when dmin >= -tol;
* ratio test: theta = min Xv over the cycle's decreasing cells; the leaving
  arc is the lowest node id with ratio <= theta + 1e-12;
* the entering tree cell's cost is the exact M[ei, ej];
* potentials are refreshed from the tree every ``refresh`` pivots and at
  exit, pot[v] = (-1)^dep[v] sum_k N[v,k] (-1)^dep[k] w[k]; between
  refreshes they shift incrementally on the re-hung subtree.

The tree state is the root-path indicator matrix N (B, V, V) with per-node
parent, depth dep, tree-cell cost w and flow Xv.  The dense plan is built
from (parent, Xv) once at exit.  Unlike the TPU kernel, nothing is padded:
there are no pad leaves, so node ids are rows 0..S-1 and columns S..V-1.

On the H100 the kernel is bound by the pricing pass (S*D cells of M and the
mask per pivot) and the N rows of the re-hung subtree, all read from global
memory (L2-resident at 64 x 256^2); see the source for the layout.  It runs
in float32, as the TPU kernel does.
"""
from __future__ import annotations

import math

import torch

from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch.ops.transport_simplex_anc import (
    _tree_cells,
    build_ancestor_matrix,
)
from smart_crossover_tpu_torch.ops.transport_simplex_parent import (
    build_parent_from_mask,
)

# the kernel keeps 43 bytes per node in shared memory (227 KB per block)
_MAX_KERNEL_NODES = 5000


def mega_setup(X, Bm, M):
    """Initial pivot state from basic feasible plans X (B, S, D) and their
    spanning-tree masks Bm: a dict of M (float32), N (bool), mask (bool),
    parent / dep (int32) and w / Xv (float32)."""
    B, S, D = M.shape
    f32 = torch.float32
    M = M.to(f32).contiguous()
    X = X.to(f32)
    Bm = Bm.to(torch.bool)
    parent = build_parent_from_mask(Bm)
    N = build_ancestor_matrix(parent)
    dep = N.sum(2) - 1
    ci, cj, notroot = _tree_cells(parent, S, D)
    flat = torch.where(notroot, ci * D + cj, 0)
    w = torch.where(notroot, M.reshape(B, -1).gather(1, flat), 0.0)
    Xv = torch.where(notroot, X.reshape(B, -1).gather(1, flat), 0.0)
    i32 = torch.int32
    return {"M": M, "N": N.contiguous(), "mask": Bm.contiguous(),
            "parent": parent.to(i32).contiguous(),
            "dep": dep.to(i32).contiguous(),
            "w": w.contiguous(), "Xv": Xv.contiguous()}


def _refresh_pot(N, dep, w):
    par = torch.where(dep % 2 == 0, 1.0, -1.0).to(w.dtype)
    acc = torch.where(N, (par * w)[:, None, :], 0.0).sum(2)
    return acc * par


def _price(M, mask, pot):
    B, S, D = M.shape
    delta = torch.where(mask, 0.0, M - pot[:, :S, None] - pot[:, None, S:])
    dmin, flat = delta.reshape(B, -1).min(1)
    return dmin, flat // D, flat % D


def _pivot(st, go, dmin, ei, ej):
    """One pivot for the instances where ``go`` holds; ``st`` is updated in
    place (the other instances keep their state)."""
    M, N, mask = st["M"], st["N"], st["mask"]
    parent, dep, w, Xv, pot = (st["parent"], st["dep"], st["w"], st["Xv"],
                               st["pot"])
    B, S, D = M.shape
    V = S + D
    dev = M.device
    b = torch.arange(B, device=dev)
    vids = torch.arange(V, device=dev)
    is_row = vids < S
    inf = torch.tensor(math.inf, dtype=Xv.dtype, device=dev)

    x_end = ei
    y_end = S + ej
    ax = N[b, x_end]
    ay = N[b, y_end]
    onc = ax ^ ay
    sign = torch.where(onc, torch.where(ax == is_row, -1.0, 1.0),
                       0.0).to(Xv.dtype)
    ratios = torch.where(sign < -0.5, Xv, inf)
    theta = ratios.amin(1)
    cl = torch.where(ratios <= (theta + 1e-12)[:, None], vids, V).amin(1)

    dep_cl = dep[b, cl]
    on_x = ax[b, cl]
    e_same = torch.where(on_x, x_end, y_end)
    e_other = torch.where(on_x, y_end, x_end)
    nes = torch.where(on_x[:, None], ax, ay)
    neo = torch.where(on_x[:, None], ay, ax)
    src = nes & (dep >= dep_cl[:, None]) & (vids != cl[:, None])
    Xvu = Xv + sign * theta[:, None]
    m_enter = M[b, ei, ej]
    row_shift = torch.where(on_x, dmin, -dmin)
    p_cl = parent[b, cl].long()
    li = torch.where(cl < S, cl, p_cl)
    lj = torch.where(cl < S, p_cl - S, cl - S)

    # N rows of the re-hung subtree C: (N ^ nes) | lca bit | neo
    C = N[b, :, cl] & go[:, None]
    common = N & nes[:, None, :]
    lca_dep = torch.where(common, dep[:, None, :], -1).amax(2)
    lca_bit = common & (dep[:, None, :] == lca_dep[:, :, None])
    N_new = (N ^ nes[:, None, :]) | lca_bit | neo[:, None, :]
    st["N"] = N = torch.where(C[:, :, None], N_new, N)
    dep_new = (N.sum(2) - 1).to(dep.dtype)

    # the reversed path e_same..cl re-keys child -> old parent
    tgt = torch.where(src, parent.long(), V)
    child = torch.full((B, V + 1), -1, dtype=torch.int64, device=dev)
    child = child.scatter(1, tgt, vids.expand(B, V))[:, :V]
    hit = child >= 0
    chc = child.clamp(min=0)
    es = vids == e_same[:, None]
    Xv_new = torch.where(es, theta[:, None],
                         torch.where(hit, Xvu.gather(1, chc), Xvu))
    w_new = torch.where(es, m_enter[:, None],
                        torch.where(hit, w.gather(1, chc), w))
    seg_hit = hit & nes & (dep >= dep_cl[:, None])
    par_new = torch.where(es, e_other[:, None].to(parent.dtype),
                          torch.where(seg_hit, child.to(parent.dtype),
                                      parent))
    shift = torch.where(is_row, row_shift[:, None], -row_shift[:, None])
    pot_new = pot + torch.where(C, shift, 0.0)

    g = go[:, None]
    st["parent"] = torch.where(g, par_new, parent)
    st["dep"] = torch.where(g, dep_new, dep)
    st["Xv"] = torch.where(g, Xv_new, Xv)
    st["w"] = torch.where(g, w_new, w)
    st["pot"] = pot_new
    bg = b[go]
    mask[bg, ei[go], ej[go]] = True
    mask[bg, li[go], lj[go]] = False


def transport_simplex_mega_plain(state, tol: float = 1e-7,
                                 max_pivots: int = 5000, refresh: int = 128):
    """Plain tensor version of the kernel, from a ``mega_setup`` state.

    Returns (parent, Xv, w, pot, mask, pivots, optimal), batched.
    """
    M = state["M"]
    B = M.shape[0]
    dev = M.device
    st = {"M": M, "N": state["N"].clone(), "mask": state["mask"].clone(),
          "parent": state["parent"].clone(), "dep": state["dep"].clone(),
          "w": state["w"].clone(), "Xv": state["Xv"].clone(),
          "pot": torch.zeros_like(state["w"])}
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    start = torch.zeros_like(it)
    optimal = torch.zeros(B, dtype=torch.bool, device=dev)
    finished = torch.full((B,), max_pivots <= 0, dtype=torch.bool,
                          device=dev)
    need_refresh = ~finished
    while not bool(finished.all()):
        # an outer round of the kernel: refresh, then a chunk of pivots
        r = need_refresh
        st["pot"] = torch.where(r[:, None],
                                _refresh_pot(st["N"], st["dep"], st["w"]),
                                st["pot"])
        start = torch.where(r, it, start)
        dmin, ei, ej = _price(M, st["mask"], st["pot"])
        now_done = dmin >= -tol
        optimal |= r & now_done
        finished |= r & now_done
        go = ~finished & ~now_done
        _pivot(st, go, dmin, ei, ej)
        it = it + go
        chunk_end = ~finished & (now_done | (it >= start + refresh)
                                 | (it >= max_pivots))
        capped = chunk_end & (it >= max_pivots)
        finished |= capped
        need_refresh = chunk_end & ~capped
    pot = _refresh_pot(st["N"], st["dep"], st["w"])
    return (st["parent"], st["Xv"], st["w"], pot, st["mask"], it, optimal)


def _check(name, t, dtype, shape):
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != shape:
        raise ValueError(f"transport_simplex_mega: {name} must be a "
                         f"contiguous {dtype} CUDA tensor of shape {shape}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _transport_simplex_mega_cuda(state, tol, max_pivots, refresh):
    M = state["M"]
    B, S, D = M.shape
    V = S + D
    if V > _MAX_KERNEL_NODES:
        raise ValueError(f"transport_simplex_mega: V = {V} nodes exceeds the "
                         f"kernel's shared-memory limit ({_MAX_KERNEL_NODES})")
    _check("M", M, torch.float32, (B, S, D))
    _check("N", state["N"], torch.bool, (B, V, V))
    _check("mask", state["mask"], torch.bool, (B, S, D))
    for k in ("parent", "dep"):
        _check(k, state[k], torch.int32, (B, V))
    for k in ("w", "Xv"):
        _check(k, state[k], torch.float32, (B, V))
    lib = _build.library()
    N_work = torch.empty_like(state["N"])
    mask = torch.empty_like(state["mask"])
    parent = torch.empty_like(state["parent"])
    Xv = torch.empty_like(state["Xv"])
    w = torch.empty_like(state["w"])
    pot = torch.empty_like(state["w"])
    stats = torch.empty(B, 2, dtype=torch.int32, device=M.device)
    stream = torch.cuda.current_stream(M.device).cuda_stream
    with torch.cuda.device(M.device):
        err = lib.scx_transport_simplex_mega(
            M.data_ptr(), state["N"].data_ptr(), state["mask"].data_ptr(),
            state["parent"].data_ptr(), state["dep"].data_ptr(),
            state["w"].data_ptr(), state["Xv"].data_ptr(),
            N_work.data_ptr(), mask.data_ptr(), parent.data_ptr(),
            Xv.data_ptr(), w.data_ptr(), pot.data_ptr(), stats.data_ptr(),
            B, S, D, float(tol), int(max_pivots), int(refresh), stream)
    _build.check(err, "scx_transport_simplex_mega")
    _build.LAUNCHES["transport_simplex_mega"] += 1
    return parent, Xv, w, pot, mask, stats[:, 0].long(), stats[:, 1] != 0


def transport_simplex_mega(state, tol: float = 1e-7, max_pivots: int = 5000,
                           refresh: int = 128):
    """Pivot a ``mega_setup`` state to optimality: the kernel for CUDA
    tensors, the plain version for CPU tensors.  Returns (parent, Xv, w,
    pot, mask, pivots, optimal)."""
    if state["M"].is_cuda:
        return _transport_simplex_mega_cuda(state, tol, max_pivots, refresh)
    if state["M"].device.type != "cpu":
        raise ValueError(
            f"transport_simplex_mega: no kernel for {state['M'].device}")
    return transport_simplex_mega_plain(state, tol, max_pivots, refresh)


def rebuild_plan(parent, Xv, S: int, D: int):
    """Dense plans (B, S, D) from tree flows keyed by child node."""
    B = parent.shape[0]
    ci, cj, notroot = _tree_cells(parent.long(), S, D)
    idx = torch.where(notroot, ci * D + cj, S * D)
    X = torch.zeros(B, S * D + 1, dtype=Xv.dtype, device=Xv.device)
    X = X.scatter(1, idx, torch.where(notroot, Xv, 0.0))
    return X[:, :S * D].reshape(B, S, D)


def batched_transport_simplex_mega(X, Bm, M, tol: float = 1e-7,
                                   max_pivots: int = 5000,
                                   refresh: int = 128):
    """Pivot a batch of basic feasible plans to optimality.

    Contract of the JAX package's ``batched_transport_simplex_mega``:
    X (B, S, D) basic feasible plans, Bm (B, S, D) spanning-tree masks, M
    (B, S, D) costs.  Returns (X_opt, Bm_opt, pivots, optimal) with batch
    dims; X_opt is float32, as the pivot loop runs in float32.
    """
    B, S, D = M.shape
    state = mega_setup(X, Bm, M)
    parent, Xv, _, _, mask, pivots, optimal = transport_simplex_mega(
        state, tol, max_pivots, refresh)
    X_out = rebuild_plan(parent, Xv, S, D)
    return X_out.clamp(min=0.0), mask, pivots, optimal
