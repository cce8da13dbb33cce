"""Bit-packed ancestor-matrix batched transportation simplex.

Port of ``smart_crossover_tpu/ops/transport_simplex_packed.py``
(``pack_bool_rows``, ``unpack_row``, ``transport_simplex_packed`` with its
refresh and block pricing, and the batched form).  The algorithm is the
anc engine's (``ops/transport_simplex_anc.py``) with the root-path matrix
N kept as (B, V, W) words of 32 bits, W = ceil(V / 32), and two changes
the JAX engine makes:

* the LCA depth of row u and e_same is popcount(N[u] & N[e_same]) - 1
  (two root paths meet in the LCA's own root path); the LCA node comes
  from e_same's path listed by depth;
* block pricing: a full pricing pass keeps the best cell of each of
  ``blocks`` slices of the flat cells as candidates, and later pivots
  price only the candidates against the current potentials, until none
  is still attractive, a long degenerate run, or the next refresh.

The words are int64 tensors holding 32-bit values, so shifts and
popcounts never meet a sign bit; the popcount is the SWAR bit count.  In
the lockstep batch an instance's full pricing pass and its candidate
pricing are both computed every step and the one the JAX engine's
``lax.cond`` takes is kept.
"""
from __future__ import annotations

import torch

from smart_crossover_tpu_torch.ops.transport_simplex_anc import (
    build_ancestor_matrix,
    close_step,
    rebuild_plan,
    ratio_test,
    run_refresh_rounds,
    setup_state,
    tree_pivot,
)
from smart_crossover_tpu_torch.ops.transport_simplex_parent import (
    _chain,
    _num_levels,
    _price,
)

# a candidate run of this many degenerate pivots forces full pricing
_MAX_DEGENERATE = 24


def pack_bool_rows(Nb, W: int):
    """(..., V) bool -> (..., W) words held in int64, bit j of word k =
    column 32 k + j."""
    V = Nb.shape[-1]
    x = torch.nn.functional.pad(Nb.to(torch.int64), (0, W * 32 - V))
    x = x.reshape(*x.shape[:-1], W, 32)
    return (x << torch.arange(32, device=x.device)).sum(-1)


def unpack_row(p, V: int):
    """(..., W) words -> (..., V) bool."""
    bits = (p[..., None] >> torch.arange(32, device=p.device)) & 1
    return bits.reshape(*p.shape[:-1], -1)[..., :V] > 0


def popcount32(x):
    """Set bits of each 32-bit value held in an int64 tensor (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _price_full(M, mask, pot, tol: float, blocks: int):
    """One dense pricing pass: (entering flat id, its reduced cost, the
    candidates).  The flat cells, padded with zeros to ``blocks`` equal
    slices, give one candidate per slice whose reduced cost is below -tol
    (S * D where none); ties go to the lowest index, so the entering cell
    is the plain Dantzig choice."""
    B, S, D = M.shape
    SD = S * D
    if not blocks:
        dmin, ei, ej = _price(M, mask, pot)
        return ei * D + ej, dmin, None
    L = -(-SD // blocks)
    delta = torch.where(mask, 0.0,
                        M - pot[:, :S, None] - pot[:, None, S:]).reshape(B, SD)
    delta = torch.nn.functional.pad(delta, (0, blocks * L - SD))
    vals, idx = delta.reshape(B, blocks, L).min(2)
    idxs = idx + torch.arange(blocks, device=M.device) * L
    dmin, kb = vals.min(1)
    flat = idxs.gather(1, kb[:, None])[:, 0]
    cand = torch.where(vals < -tol, idxs, SD)
    return flat, dmin, cand


def _price_packed(st, tol: float, blocks: int):
    """The JAX engine's pricing: the candidates against the current
    potentials where one is still valid (not basic, below
    min(-tol, dref / 4), fewer than 24 degenerate pivots in a row), else a
    full pass, which also sets the candidates and dref.  Returns (flat,
    dmin, done)."""
    M, mask, pot = st["M"], st["mask"], st["pot"]
    B, S, D = M.shape
    SD = S * D
    flat_f, dmin_f, cand_f = _price_full(M, mask, pot, tol, blocks)
    if not blocks:
        return flat_f, dmin_f, dmin_f >= -tol
    cand = st["cand"]
    safe = cand.clamp(max=SD - 1)
    ci = (cand // D).clamp(max=S - 1)
    cj = (cand % D).clamp(max=D - 1)
    rc = (M.reshape(B, SD).gather(1, safe) - pot.gather(1, ci)
          - pot[:, S:].gather(1, cj))
    basic = mask.reshape(B, SD).gather(1, safe)
    thresh = torch.clamp(0.25 * st["dref"], max=-tol)
    valid = ((cand < SD) & ~basic & (rc < thresh[:, None])
             & (st["degen"] < _MAX_DEGENERATE)[:, None])
    use = valid.any(1)
    k = torch.where(valid, rc, 0.0).argmin(1)
    flat_c = cand.gather(1, k[:, None])[:, 0]
    dmin_c = rc.gather(1, k[:, None])[:, 0]
    full = ~use & ~st["finished"] & ~st["need_refresh"]
    st["cand"] = torch.where(full[:, None], cand_f, cand)
    st["dref"] = torch.where(full, dmin_f, st["dref"])
    flat = torch.where(use, flat_c, flat_f)
    dmin = torch.where(use, dmin_c, dmin_f)
    return flat, dmin, ~use & (dmin_f >= -tol)


def _packed_step(st, tol: float, refresh_every: int, max_pivots: int,
                 blocks: int):
    """One pivot of the packed engine (``pivot_body``) for the instances
    between refreshes."""
    M, P, dep = st["M"], st["P"], st["dep"]
    B, S, D = M.shape
    V = S + D
    dev = M.device
    b = torch.arange(B, device=dev)
    vids = torch.arange(V, device=dev)
    active = ~st["finished"] & ~st["need_refresh"]
    fresh = st["it"] == st["start"]
    # a chunk's first step prices in full: the refresh voided the
    # candidates
    st["cand"] = torch.where((active & fresh)[:, None], S * D, st["cand"])
    flat, dmin, now_done = _price_packed(st, tol, blocks)
    flat = flat.clamp(max=S * D - 1)      # padding, only where done
    ei, ej = flat // D, flat % D
    go = active & ~now_done
    p_x = P[b, ei]
    p_y = P[b, S + ej]
    anc_x = unpack_row(p_x, V)
    anc_y = unpack_row(p_y, V)
    sign, theta, cl = ratio_test(st["Xv"], anc_x, anc_y, S)
    # the re-hung component C: bit cl of every row
    C = ((P[b, :, cl >> 5] >> (cl & 31)[:, None]) & 1) > 0
    on_x = tree_pivot(st, go, dmin, ei, ej, anc_x, anc_y, sign, theta, cl,
                      C)
    p_es = torch.where(on_x[:, None], p_x, p_y)
    p_eo = torch.where(on_x[:, None], p_y, p_x)
    n_es = torch.where(on_x[:, None], anc_x, anc_y)
    # lca_dep(u) = |path(u) & path(e_same)| - 1; e_same's path by depth
    # gives the LCA node, OR-ed back in as one bit per row
    lca_dep = popcount32(P & p_es[:, None, :]).sum(2) - 1
    by_dep = torch.zeros(B, V + 1, dtype=torch.int64, device=dev).scatter(
        1, torch.where(n_es, dep, V), vids.expand(B, V))
    lca = by_dep.gather(1, lca_dep.clamp(0, V - 1))
    W = P.shape[2]
    lca_oh = torch.where(
        torch.arange(W, device=dev) == (lca >> 5)[:, :, None],
        (1 << (lca & 31))[:, :, None], 0)
    P_new = (P ^ p_es[:, None, :]) | lca_oh | p_eo[:, None, :]
    st["P"] = P = torch.where((C & go[:, None])[:, :, None], P_new, P)
    st["dep"] = popcount32(P).sum(2) - 1
    st["degen"] = torch.where(
        go, torch.where(theta <= 1e-12, st["degen"] + 1, 0), st["degen"])
    close_step(st, active, now_done, go, refresh_every, max_pivots)


def batched_transport_simplex_packed(X, Bm, M, s=None, d=None,
                                     tol: float = 1e-7,
                                     max_pivots: int = 5000,
                                     refresh: int = 128, *,
                                     blocks: int = 16):
    """Pivot a batch of basic feasible transport plans to optimality
    (bit-packed ancestor matrix, block pricing).

    Contract of the JAX package's ``transport_simplex_packed``, batched: X
    (B, S, D) basic feasible plans (s and d are not read), Bm (B, S, D)
    spanning-tree basis masks, M (B, S, D) costs, all on one device; the
    pivots run in M's dtype.  ``blocks=0`` prices every pivot in full.
    Returns (X_opt, Bm_opt, pivots, optimal) with batch dims; the basis is
    the carried pricing mask.
    """
    B, S, D = M.shape
    V = S + D
    W = (V + 31) // 32
    st = setup_state(X, Bm, M, max_pivots)
    N0 = build_ancestor_matrix(st["parent"])
    st["P"] = pack_bool_rows(N0, W)
    st["dep"] = N0.sum(2) - 1
    del N0
    st["cand"] = torch.full((B, max(blocks, 1)), S * D, dtype=torch.int64,
                            device=M.device)
    st["dref"] = torch.zeros(B, dtype=M.dtype, device=M.device)
    st["degen"] = torch.zeros(B, dtype=torch.int64, device=M.device)
    run_refresh_rounds(
        lambda st_: _packed_step(st_, tol, refresh, max_pivots, blocks), st)
    X_out = rebuild_plan(st["parent"], st["Xv"], S, D)
    pot = _chain(st["parent"], st["w"], _num_levels(V))[2]
    optimal = _price(M, st["mask"], pot)[0] >= -tol
    return X_out.clamp(min=0.0), st["mask"], st["it"], optimal


def transport_simplex_packed(X, Bm, M, s=None, d=None, tol: float = 1e-7,
                             max_pivots: int = 5000, refresh: int = 128,
                             blocks: int = 16):
    """One instance: X, Bm, M (S, D).  Returns (X_opt, Bm_opt, pivots,
    optimal)."""
    out = batched_transport_simplex_packed(
        X[None], Bm[None], M[None], tol=tol, max_pivots=max_pivots,
        refresh=refresh, blocks=blocks)
    return tuple(o[0] for o in out)
