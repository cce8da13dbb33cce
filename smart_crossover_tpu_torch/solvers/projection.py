"""Null-space projection kernels:  v  ->  (I - Y'(YY')^+ Y) v.

Port of ``smart_crossover_tpu/solvers/projection.py``.  ``apply_projector``,
``apply_projector_with_free`` and ``projector_residual`` are host copies
(scipy CG / MINRES under a 1-thread BLAS limit), used by the perturbation
crossover on sparse LP data.  The JAX module's ``apply_projector_jax`` (a
``jax.scipy`` CG on a dense Y) becomes ``apply_projector_torch``: the same
CG on ``Y Y'`` in torch, on the CUDA card by default.  Its products stay
``torch.matmul``, as the JAX package computes them outside any Pallas
kernel.  The mesh-sharded projector (``parallel/projector.py``) runs
the same CG on its all-reduced operator.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from smart_crossover_tpu_torch.config import resolve_device, to_device
from smart_crossover_tpu_torch.utils.threads import single_thread_blas as \
    _single_thread_blas


# --------------------------------------------------------------------------
# host (scipy) path
# --------------------------------------------------------------------------
# Both Krylov projectors run under a 1-thread BLAS limit: each CG/MINRES
# iteration is a couple of sparse matvecs (scipy, unthreaded) plus thin
# BLAS1 ddots/axpys where threaded OpenBLAS pays its pool sync per call —
# ~12 ms vs ~7 us per 100k ddot measured on a 4-core host, i.e. tens of
# seconds over a 1000-iteration solve.
@_single_thread_blas
def apply_projector(Y, v, tol: float = 1e-8, max_iter: int = 1000) -> np.ndarray:
    """Project v onto the null space of Y via CG on YY' (host, sparse)."""
    Y = sp.csr_matrix(Y)
    v = np.asarray(v, dtype=np.float64)
    Yv = Y @ v
    m = Y.shape[0]

    def mv(z):
        return Y @ (Y.T @ z)

    op = spla.LinearOperator((m, m), matvec=mv, dtype=np.float64)
    z, _ = spla.cg(op, Yv, rtol=tol, maxiter=max_iter)
    return v - Y.T @ z


@_single_thread_blas
def apply_projector_with_free(Y, v, A_f, tol: float = 1e-6,
                              max_iter: int = 2000) -> np.ndarray:
    """Least-squares projection with unpenalised free columns.

    Solves  min ||x - v||^2  s.t.  Y x + A_f f = 0  (f unconstrained), the
    same problem the reference poses to Gurobi's QP barrier
    (lp_methods/algorithms.py:240-265).  KKT elimination gives the symmetric
    system  [[YY', A_f], [A_f', 0]] [lam; g] = [Yv; 0]  solved matrix-free
    with MINRES; then  x = v - Y' lam.
    """
    Y = sp.csr_matrix(Y)
    A_f = sp.csr_matrix(A_f)
    v = np.asarray(v, dtype=np.float64)
    m = Y.shape[0]
    k = A_f.shape[1]

    def mv(w):
        lam, g = w[:m], w[m:]
        top = Y @ (Y.T @ lam) + A_f @ g
        bot = A_f.T @ lam
        return np.concatenate([top, bot])

    op = spla.LinearOperator((m + k, m + k), matvec=mv, dtype=np.float64)
    rhs = np.concatenate([Y @ v, np.zeros(k)])
    w, _ = spla.minres(op, rhs, rtol=tol, maxiter=max_iter)
    return v - Y.T @ w[:m]


# --------------------------------------------------------------------------
# torch path (dense Y on the card: the counterpart of apply_projector_jax)
# --------------------------------------------------------------------------
def _cg_normal(Y: torch.Tensor, rhs: torch.Tensor, tol: float,
               max_iter: int, block: int = 32, mv=None):
    """CG on (Y Y') z = rhs, from z = 0, with the stopping rule of
    ``jax.scipy.sparse.linalg.cg``: a lane stops once r.r <= tol^2 rhs.rhs
    (``atol`` 0) or after ``max_iter`` iterations.

    Y is (m, n) or (B, m, n) and rhs (m,) or (B, m): each leading index is
    a lane.  ``mv`` is the operator z -> Y Y' z (default: the product on
    Y; the sharded projector passes its all-reduced one).  The host reads
    the stopping test once per ``block`` iterations; within a block a
    stopped lane's update is masked out, so every lane ends at the
    iteration a per-iteration check would stop it at.  Returns (z,
    iterations per lane)."""
    if mv is None:
        def mv(w):
            return (Y @ (Y.mT @ w.unsqueeze(-1))).squeeze(-1)

    def dot(a, b):
        return (a * b).sum(-1)

    z = torch.zeros_like(rhs)
    r = rhs.clone()
    p = r.clone()
    gamma = dot(r, r)
    atol2 = tol * tol * dot(rhs, rhs)
    k = torch.zeros_like(gamma, dtype=torch.int64)
    while True:
        for _ in range(block):
            on = (gamma > atol2) & (k < max_iter)
            Ap = mv(p)
            alpha = torch.where(on, gamma / dot(p, Ap), 0.0)
            z = z + alpha.unsqueeze(-1) * p
            r_ = r - alpha.unsqueeze(-1) * Ap
            gamma_ = dot(r_, r_)
            beta = torch.where(on, gamma_ / gamma, 0.0)
            p = torch.where(on.unsqueeze(-1), r_ + beta.unsqueeze(-1) * p, p)
            r = torch.where(on.unsqueeze(-1), r_, r)
            gamma = torch.where(on, gamma_, gamma)
            k = k + on.to(torch.int64)
        if not bool(((gamma > atol2) & (k < max_iter)).any()):
            return z, k


def apply_projector_torch(Y, v, tol: float = 1e-8, max_iter: int = 1000,
                          device=None) -> torch.Tensor:
    """Project v onto null(Y) for a dense Y by CG on Y Y'.

    Y: (m, n) numpy array or tensor (a leading batch axis is allowed, with
    v (B, n)); a scipy sparse Y raises, so a caller densifies it knowingly.
    ``device``: Y's device if Y is a tensor, else the CUDA card (without
    one that default raises); float32 on the card, the input's dtype on the
    CPU.  Returns v - Y' z as a tensor on that device."""
    if sp.issparse(Y):
        raise TypeError("apply_projector_torch takes a dense Y; pass "
                        "Y.toarray() (or use the host apply_projector)")
    dev = resolve_device(device, Y)
    Yt = to_device(Y, dev)
    vt = to_device(v, dev, Yt.dtype)
    Yv = (Yt @ vt.unsqueeze(-1)).squeeze(-1)
    z, _ = _cg_normal(Yt, Yv, tol, max_iter)
    return vt - (Yt.mT @ z.unsqueeze(-1)).squeeze(-1)


def projector_residual(Y, x) -> float:
    """||Y x|| — how far x is from the null space (certificate helper)."""
    Y = sp.csr_matrix(Y)
    return float(np.linalg.norm(Y @ np.asarray(x)))
