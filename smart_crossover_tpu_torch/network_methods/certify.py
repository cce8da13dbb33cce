"""Independent float64 certification of OT crossover results.

The device pivots in float32: the spanning-tree basis it returns is exact,
its flow values are not.  The certificate recomputes the exact float64
vertex and duals from the basis alone and applies the reference acceptance
test (feasibility <= 1e-8, reduced costs >= -1e-6).  It trusts nothing of
the route: it reads only the basis mask, the masses and the costs, and
shares no code with the device stages.

On a CUDA card a batch is certified by one launch of ``csrc/certify.cu``
(``ops/certify.py``): a block per instance solves the spanning tree by
elimination and takes the reduced-cost minimum over every cell, in
float64, as the H100 runs it natively.  On the CPU, and as the oracle the
kernel is held to, ``certify_ot_basis`` is a numpy / scipy copy of
``smart_crossover_tpu/network_methods/certify.py`` (the port may not import
the JAX package, whose package imports load jax): scipy sparse LU on the
tree system, dense numpy reduced costs.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from smart_crossover_tpu_torch.ops import certify as kernel
from smart_crossover_tpu_torch.parameters import (
    TOLERANCE_FOR_ARTIFICIAL_VARS,
    TOLERANCE_FOR_REDUCED_COSTS,
)
from smart_crossover_tpu_torch.utils import trace


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
        return _refused(zeros, f"basis has {nb} arcs, want {V - 1}")

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
        return _refused(zeros, f"tree solve failed: {e}")

    y = np.concatenate([y_red, [0.0]])
    X = np.zeros((S, D))
    X[ti, tj] = x_tree

    feas = float(np.abs(A @ x_tree - b).max())
    min_flow = float(x_tree.min()) if nb else 0.0
    # rcost_ij = M_ij - (y_{S+j} - y_i); zero on basic arcs by construction
    rc = M - (y[S:][None, :] - y[:S][:, None])
    min_rcost = float(rc.min())
    obj = float(np.sum(X * M))
    return _verdict(X, obj, feas, min_flow, min_rcost, feas_tol, rcost_tol)


def _refused(x, reason: str) -> OTCertificate:
    return OTCertificate(False, x, np.nan, np.inf, -np.inf, -np.inf, reason)


def _verdict(X, obj: float, feas: float, min_flow: float, min_rcost: float,
             feas_tol: float, rcost_tol: float) -> OTCertificate:
    """The acceptance test on a tree's numbers."""
    ok = (feas <= feas_tol and min_flow >= -feas_tol
          and min_rcost >= -rcost_tol)
    reason = "" if ok else (
        f"feas={feas:.2e} min_flow={min_flow:.2e} min_rcost={min_rcost:.2e}")
    return OTCertificate(ok, X, obj, feas, min_flow, min_rcost, reason)


def certify_ot_basis_batch(Bm, s, d, M, feas_tol: float | None = None,
                           rcost_tol: float | None = None,
                           threads: int | None = 1, *, device=None
                           ) -> list[OTCertificate]:
    """Certify a batch: ``Bm`` (B, S, D) basis masks, ``s`` (B, S), ``d``
    (B, D), ``M`` (B, S, D), numpy arrays or tensors.

    ``device``: where a CUDA tensor among ``Bm`` and ``M`` lies, else the
    CUDA card where there is one, else the CPU.  On a card one launch of
    ``csrc/certify.cu`` certifies the whole batch in float64 and each
    instance's ``x`` is built on the host from its tree flows.  On the CPU
    each instance runs ``certify_ot_basis``, serially by default: each is
    GIL-held scipy/numpy work (scipy's tree LU releases nothing), so a
    thread pool contends for the interpreter lock; pass threads>1 only on
    hosts where it has been measured to win."""
    tol = {"feas_tol": TOLERANCE_FOR_ARTIFICIAL_VARS if feas_tol is None
           else feas_tol,
           "rcost_tol": TOLERANCE_FOR_REDUCED_COSTS if rcost_tol is None
           else rcost_tol}
    dev = _device(device, Bm, M)
    with trace.span("scx.certify"):
        if dev.type == "cuda":
            certs = _certify_on_card(Bm, s, d, M, dev, **tol)
        else:
            certs = _certify_on_host(*(_numpy(a) for a in (Bm, s, d, M)),
                                     threads, **tol)
        trace.count("certify.rejected", sum(not c.ok for c in certs))
    return certs


def _device(device, *arrays) -> torch.device:
    if device is not None:
        return torch.device(device)
    for a in arrays:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a.device
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def _certify_on_host(Bm, s, d, M, threads, **tol) -> list[OTCertificate]:
    B = np.shape(M)[0]
    if threads is not None and threads > 1 and B > 1:
        with cf.ThreadPoolExecutor(max_workers=threads) as pool:
            return list(pool.map(
                lambda i: certify_ot_basis(Bm[i], s[i], d[i], M[i], **tol),
                range(B)))
    return [certify_ot_basis(Bm[i], s[i], d[i], M[i], **tol)
            for i in range(B)]


def _certify_on_card(Bm, s, d, M, device, feas_tol,
                     rcost_tol) -> list[OTCertificate]:
    """The kernel's verdicts as certificates, each ``x`` its tree flows
    scattered into zeros on the host, the instances in parallel (the
    scatter releases the interpreter lock, and the zero pages it touches
    cost more than the kernel)."""
    B, S, D = M.shape
    if B == 0:
        return []
    status, n_arcs, nums, arcs, flows = kernel.certify_batch_cuda(
        Bm, s, d, M, device)

    def vertex(b):
        x = np.zeros(S * D)
        if status[b] == kernel.TREE:
            x[arcs[b]] = flows[b]
        return x.reshape(S, D)

    certs = []
    for b, x in enumerate(_pool().map(vertex, range(B))):
        if status[b] == kernel.COUNT:
            certs.append(_refused(x, f"basis has {n_arcs[b]} arcs, "
                                     f"want {S + D - 1}"))
        elif status[b] == kernel.CYCLE:
            certs.append(_refused(x, "tree solve failed: the basis arcs "
                                     "hold a cycle"))
        else:
            feas, min_flow, min_rcost, obj = map(float, nums[b])
            certs.append(_verdict(x, obj, feas, min_flow, min_rcost,
                                  feas_tol, rcost_tol))
    return certs


_POOL = None


def _pool():
    """The threads that build the certified vertices, made at first use."""
    global _POOL
    if _POOL is None:
        _POOL = cf.ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            thread_name_prefix="scx-certify")
    return _POOL
