"""Independent host-side certification of OT crossover results.

A numpy / scipy copy of ``smart_crossover_tpu/network_methods/certify.py``
(the port may not import the JAX package, whose package imports load jax).
The device pivots in float32: the spanning-tree basis it returns is exact,
its flow values are not.  This recomputes the exact float64 vertex and
duals from the basis alone and applies the reference acceptance test
(feasibility <= 1e-8, reduced costs >= -1e-6).  Deliberately independent
of the device code: scipy sparse LU on the tree system, dense numpy
reduced costs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from smart_crossover_tpu_torch.parameters import (
    TOLERANCE_FOR_ARTIFICIAL_VARS,
    TOLERANCE_FOR_REDUCED_COSTS,
)


@dataclass
class OTCertificate:
    ok: bool
    x: np.ndarray          # (S, D) exact f64 vertex (tree flows)
    obj_val: float
    max_feas_err: float    # max |Ax - b| over nodes
    min_flow: float        # most negative tree flow (degeneracy ~ -1e-16)
    min_rcost: float       # most negative reduced cost over all arcs
    reason: str = ""


def certify_ot_basis(Bm, s, d, M,
                     feas_tol: float = TOLERANCE_FOR_ARTIFICIAL_VARS,
                     rcost_tol: float = TOLERANCE_FOR_REDUCED_COSTS
                     ) -> OTCertificate:
    """Certify a claimed-optimal spanning-tree basis of one transportation
    problem, recomputing exact f64 flows and duals from scratch.

    Args:
        Bm: (S, D) boolean basis mask with S + D - 1 True entries forming
            a spanning tree of the bipartite graph.
        s, d: supplies / demands (sum(s) == sum(d)).
        M: (S, D) cost matrix.

    Arc (i, j) has -1 at supply row i and +1 at demand row S + j, with
    b = [-s, d] (the convention of ``OptTransport.to_MCF``).
    """
    Bm = np.asarray(Bm, dtype=bool)
    s = np.asarray(s, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)
    M = np.asarray(M, dtype=np.float64)
    S, D = M.shape
    V = S + D
    zeros = np.zeros((S, D))

    ti, tj = np.nonzero(Bm)
    nb = ti.size
    if nb != V - 1:
        return OTCertificate(False, zeros, np.nan, np.inf, -np.inf,
                             -np.inf, f"basis has {nb} arcs, want {V - 1}")

    k = np.arange(nb)
    rows = np.concatenate([ti, S + tj])
    cols = np.concatenate([k, k])
    data = np.concatenate([-np.ones(nb), np.ones(nb)])
    A = sp.csc_matrix((data, (rows, cols)), shape=(V, nb))
    b = np.concatenate([-s, d])

    # drop the last row: for a spanning tree the reduced system is square
    # and nonsingular; a singular factorization means Bm was not a tree
    Ared = sp.csc_matrix(A[:-1, :])
    try:
        lu = spla.splu(Ared)
        x_tree = lu.solve(b[:-1])
        y_red = lu.solve(M[ti, tj], trans="T")
    except RuntimeError as e:
        return OTCertificate(False, zeros, np.nan, np.inf, -np.inf,
                             -np.inf, f"tree solve failed: {e}")

    y = np.concatenate([y_red, [0.0]])
    X = np.zeros((S, D))
    X[ti, tj] = x_tree

    feas = float(np.abs(A @ x_tree - b).max())
    min_flow = float(x_tree.min()) if nb else 0.0
    # rcost_ij = M_ij - (y_{S+j} - y_i); zero on basic arcs by construction
    rc = M - (y[S:][None, :] - y[:S][:, None])
    min_rcost = float(rc.min())

    ok = (feas <= feas_tol and min_flow >= -feas_tol
          and min_rcost >= -rcost_tol)
    reason = "" if ok else (
        f"feas={feas:.2e} min_flow={min_flow:.2e} min_rcost={min_rcost:.2e}")
    obj = float(np.sum(X * M))
    return OTCertificate(ok, X, obj, feas, min_flow, min_rcost, reason)


def certify_ot_basis_batch(Bm, s, d, M, feas_tol: float | None = None,
                           rcost_tol: float | None = None,
                           threads: int | None = 1
                           ) -> list[OTCertificate]:
    """Certify a batch.  Serial by default: each instance is GIL-held
    scipy/numpy work (scipy's tree LU releases nothing), so a thread pool
    contends for the interpreter lock.  Pass threads>1 only on hosts where
    it has been measured to win."""
    import concurrent.futures as cf

    kw = {}
    if feas_tol is not None:
        kw["feas_tol"] = feas_tol
    if rcost_tol is not None:
        kw["rcost_tol"] = rcost_tol
    B = np.shape(M)[0]
    if threads is None:
        threads = 1
    if threads > 1 and B > 1:
        with cf.ThreadPoolExecutor(max_workers=threads) as pool:
            return list(pool.map(
                lambda i: certify_ot_basis(Bm[i], s[i], d[i], M[i], **kw),
                range(B)))
    return [certify_ot_basis(Bm[i], s[i], d[i], M[i], **kw)
            for i in range(B)]
