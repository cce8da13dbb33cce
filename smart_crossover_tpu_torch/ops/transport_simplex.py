"""Batched transportation simplex by dense propagation: the oracle engine.

Port of ``smart_crossover_tpu/ops/transport_simplex.py``
(``tree_potentials``, ``transport_simplex``, ``batched_transport_simplex``).
Every pivot recomputes the potentials by masked propagation over the basis
mask from row 0 (O(diameter) dense rounds), prices M - u - v, finds the
entering cell's cycle as the tree flow of a unit source at its row and a
unit sink at its column (``ops/tree.py::bipartite_tree_solve``), and takes
the ratio test over the dense plan.  It is the slowest engine and the one
the others are checked against.

The batch pivots in lockstep (``transport_simplex_parent.run_lockstep``),
and the propagation rounds inside a pivot run for the whole batch too: the
host reads "any instance still propagating" once per
``ROUND_CHECK_EVERY`` rounds (a finished instance's extra rounds change
nothing), so a pivot costs a few host reads, not one per round.
"""
from __future__ import annotations

import math

import torch

from smart_crossover_tpu_torch.ops.transport_simplex_parent import (
    run_lockstep,
    set_cells,
)
from smart_crossover_tpu_torch.ops.tree import bipartite_tree_solve

# propagation rounds between two host reads of "any node unassigned"
ROUND_CHECK_EVERY = 8


def tree_potentials(Bm, M, max_rounds: int | None = None):
    """Dual potentials (u (B, S), v (B, D)) with u_i + v_j = M_ij on the
    basis cells of each spanning tree Bm (B, S, D); root row 0 (u_0 = 0).
    Each round assigns the columns reachable from assigned rows, then the
    rows reachable from assigned columns."""
    B, S, D = M.shape
    if max_rounds is None:
        max_rounds = S + D + 2
    dev = M.device
    u = torch.zeros(B, S, dtype=M.dtype, device=dev)
    v = torch.zeros(B, D, dtype=M.dtype, device=dev)
    au = torch.zeros(B, S, dtype=torch.bool, device=dev)
    au[:, 0] = True
    av = torch.zeros(B, D, dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < max_rounds:
        for _ in range(min(ROUND_CHECK_EVERY, max_rounds - rounds)):
            v_new = torch.where(Bm & au[:, :, None], M - u[:, :, None],
                                -math.inf).amax(1)
            hit = torch.isfinite(v_new)
            v = torch.where(av, v, torch.where(hit, v_new, v))
            av = av | hit
            u_new = torch.where(Bm & av[:, None, :], M - v[:, None, :],
                                -math.inf).amax(2)
            hit = torch.isfinite(u_new)
            u = torch.where(au, u, torch.where(hit, u_new, u))
            au = au | hit
            rounds += 1
        if bool(au.all() & av.all()):
            break
    return u, v


def _mask_step(st, M, tol: float, max_pivots: int):
    """One pivot of the mask engine (``transport_simplex``'s loop body)
    for every instance that is not finished."""
    X, Bm = st["X"], st["Bm"]
    B, S, D = M.shape
    SD = S * D
    dev = M.device
    b = torch.arange(B, device=dev)
    u, v = tree_potentials(Bm, M)
    delta = torch.where(Bm, 0.0, M - u[:, :, None] - v[:, None, :])
    dmin, flat = delta.reshape(B, -1).min(1)
    done = dmin >= -tol
    go = ~st["finished"] & ~done
    ei, ej = flat // D, flat % D

    # the cycle: unit flow from row ei to column ej through the tree
    e_s = torch.zeros(B, S, dtype=M.dtype, device=dev)
    e_s[b, ei] = 1.0
    e_d = torch.zeros(B, D, dtype=M.dtype, device=dev)
    e_d[b, ej] = 1.0
    z = bipartite_tree_solve(Bm, e_s, e_d)
    pos = z > 1e-9
    ratios = torch.where(pos, X / torch.where(pos, z, 1.0), math.inf)
    theta = ratios.amin((1, 2))
    # leaving cell: min ratio, lowest flat index
    leave = torch.where(ratios.reshape(B, SD) <= (theta + 1e-12)[:, None],
                        torch.arange(SD, device=dev), SD).argmin(1)

    X_new = X - theta[:, None, None] * z
    X_new[b, ei, ej] += theta
    X_new = X_new.clamp(min=0.0).reshape(B, SD)
    X_new[b, leave] = 0.0
    g = go[:, None, None]
    st["X"] = torch.where(g, X_new.reshape(B, S, D), X)
    set_cells(Bm, go, flat, True)
    set_cells(Bm, go, leave, False)
    st["it"] += go
    st["finished"] |= done | (st["it"] >= max_pivots)


def batched_transport_simplex(X, Bm, M, s=None, d=None, tol: float = 1e-7,
                              max_pivots: int = 5000):
    """Pivot a batch of basic feasible transport plans to optimality (mask
    engine).

    Contract of the JAX package's ``batched_transport_simplex``: X
    (B, S, D) basic feasible plans (s and d are not read), Bm (B, S, D)
    spanning-tree basis masks, M (B, S, D) costs, all on one device; the
    pivots run in M's dtype.  Returns (X_opt, Bm_opt, pivots, optimal)
    with batch dims.
    """
    B = M.shape[0]
    st = {"X": X.to(M.dtype).clone(),
          "Bm": Bm.to(torch.bool).clone().contiguous(),
          "it": torch.zeros(B, dtype=torch.int64, device=M.device),
          "finished": torch.full((B,), max_pivots <= 0, dtype=torch.bool,
                                 device=M.device)}
    run_lockstep(lambda st_: _mask_step(st_, M, tol, max_pivots), st)
    u, v = tree_potentials(st["Bm"], M)
    delta = torch.where(st["Bm"], 0.0, M - u[:, :, None] - v[:, None, :])
    optimal = delta.amin((1, 2)) >= -tol
    return st["X"], st["Bm"], st["it"], optimal


def transport_simplex(X, Bm, M, s=None, d=None, tol: float = 1e-7,
                      max_pivots: int = 5000):
    """One instance: X, Bm, M (S, D).  Returns (X_opt, Bm_opt, pivots,
    optimal)."""
    out = batched_transport_simplex(X[None], Bm[None], M[None], tol=tol,
                                    max_pivots=max_pivots)
    return tuple(o[0] for o in out)
