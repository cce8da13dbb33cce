"""PDHG chunks on a sparse constraint matrix, behind an operator.

The JAX package runs its restarted PDHG cores (``solvers/pdhg.py::
_pdhg_core`` and ``_pdhg_core_halpern``) on a BCOO A, and its arc-list MCF
PDHG (``solvers/pdhg_mcf.py``) on an incidence operator: only ``A @ x``
and ``A.T @ y`` change, and the products run outside any Pallas kernel.
This module is the port's counterpart: two operators with ``@`` and
``.T`` (``CSROperator``: A and its transpose as CSR tensors, the sparse
product a library call; ``IncidenceOperator``: a node-arc incidence
matrix applied by gathers and ``index_add_``), and the two iteration
chunks over any such operator (``sparse_pdhg_chunk``,
``sparse_halpern_chunk``), the iterations of the JAX ``one_iter``s as
tensor code with no host read.  The dense route keeps its kernels
(``ops/pdhg_chunk.py``); nothing here calls them or their plain versions.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch


class _Transposed:
    """A.T of an operator, as ``op.T``."""

    def __init__(self, op):
        self._op = op
        self.shape = (op.shape[1], op.shape[0])
        self.dtype = op.dtype
        self.device = op.device

    def __matmul__(self, y):
        return self._op.rmatvec(y)

    @property
    def T(self):
        return self._op


class CSROperator:
    """A sparse (m, n) matrix on a device: A and A' as CSR tensors with
    int32 indices, so that both products are row-parallel sparse
    products."""

    def __init__(self, rows, cols, data, shape, dtype, device):
        import scipy.sparse as ssp

        m, n = shape
        A = ssp.csr_matrix((np.asarray(data, np.float64),
                            (np.asarray(rows), np.asarray(cols))),
                           shape=shape)
        A.sort_indices()
        self.shape = (m, n)
        self.dtype = dtype
        self.device = torch.device(device)
        self._A = self._csr(A, dtype)
        self._AT = self._csr(A.T.tocsr(), dtype)

    def _csr(self, A, dtype):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # CSR is beta
            return torch.sparse_csr_tensor(
                torch.as_tensor(A.indptr, dtype=torch.int32),
                torch.as_tensor(A.indices, dtype=torch.int32),
                torch.as_tensor(A.data, dtype=dtype), size=A.shape,
                check_invariants=False).to(self.device)

    def __matmul__(self, x):
        return self._A @ x

    def rmatvec(self, y):
        return self._AT @ y

    @property
    def T(self):
        return _Transposed(self)


class IncidenceOperator:
    """The node-arc incidence matrix of a network with m nodes: +1 at the
    head, -1 at the tail of every arc (b is net inflow, as in
    ``models.MinCostFlow``).  A x sums arc values into nodes with two
    ``index_add_``s (atomic on CUDA, so the float sums' order varies
    between runs); A' y is a difference of two gathers.  Node and arc
    vectors stay in the instance's own order."""

    def __init__(self, tails, heads, m: int, dtype, device):
        self.device = torch.device(device)
        self._tails = torch.as_tensor(np.asarray(tails), dtype=torch.int64,
                                      device=self.device)
        self._heads = torch.as_tensor(np.asarray(heads), dtype=torch.int64,
                                      device=self.device)
        self.shape = (m, self._tails.numel())
        self.dtype = dtype

    def __matmul__(self, x):
        z = torch.zeros(self.shape[0], dtype=x.dtype, device=x.device)
        return (z.index_add(0, self._heads, x)
                - z.index_add(0, self._tails, x))

    def rmatvec(self, y):
        return y[self._heads] - y[self._tails]

    @property
    def T(self):
        return _Transposed(self)


def sparse_pdhg_chunk(A, b, c, l, u, is_eq, x, y, Ax, xs, ys, wsum, eta,
                      omega, k, opnorm, chunk: int):
    """``chunk`` iterations of adaptive-step PDLP PDHG (the JAX
    ``_pdhg_core.one_iter``) on an operator A; ``k`` is the global
    iteration count (the step schedule's index is k + 2).  Every input
    but ``k`` and ``chunk`` is a tensor on A's device.  Returns
    (x, y, Ax, xs, ys, wsum, eta)."""
    lo, hi = 1e-10 / opnorm, 1e10 / opnorm
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for i in range(chunk):
        tau = eta / omega
        sigma = eta * omega
        x_c = torch.minimum(torch.maximum(x - tau * (c - A.T @ y), l), u)
        Ax_c = A @ x_c
        y_t = y + sigma * (b - (2.0 * Ax_c - Ax))
        y_c = torch.where(is_eq, y_t, torch.clamp(y_t, max=0.0))
        dx = x_c - x
        dy = y_c - y
        curv = torch.abs(dy @ (Ax_c - Ax))
        nz = omega * (dx @ dx) + (dy @ dy) / omega
        eta_bar = torch.where(curv > 0, nz / (2.0 * curv), hi)
        accept = eta <= eta_bar
        ks = float(k + i + 2)
        eta_next = torch.minimum((1.0 - ks ** -0.3) * eta_bar,
                                 (1.0 + ks ** -0.6) * eta)
        eta_next = torch.minimum(torch.maximum(eta_next, lo), hi)
        x = torch.where(accept, x_c, x)
        y = torch.where(accept, y_c, y)
        Ax = torch.where(accept, Ax_c, Ax)
        w = torch.where(accept, eta, zero)
        xs = xs + w * x
        ys = ys + w * y
        wsum = wsum + w
        eta = eta_next
    return x, y, Ax, xs, ys, wsum, eta


def sparse_halpern_chunk(A, b, c, l, u, is_eq, x, y, Ax, xa, ya, Axa,
                         omega, k, step, chunk: int):
    """``chunk`` iterations of reflected-Halpern PDHG with a fixed step
    (the JAX ``_pdhg_core_halpern.one_iter``) on an operator A; ``k``
    (a tensor) counts the iterations since the last restart.  Returns
    (x, y, Ax, k)."""
    tau = step / omega
    sigma = step * omega
    for _ in range(chunk):
        x_t = torch.minimum(torch.maximum(x - tau * (c - A.T @ y), l), u)
        Ax_t = A @ x_t
        y_t0 = y + sigma * (b - (2.0 * Ax_t - Ax))
        y_t = torch.where(is_eq, y_t0, torch.clamp(y_t0, max=0.0))
        lam = (k + 1.0) / (k + 2.0)
        x = lam * (2.0 * x_t - x) + (1.0 - lam) * xa
        y = lam * (2.0 * y_t - y) + (1.0 - lam) * ya
        Ax = lam * (2.0 * Ax_t - Ax) + (1.0 - lam) * Axa
        k = k + 1.0
    return x, y, Ax, k
