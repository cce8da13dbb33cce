"""Infeasibility / unboundedness certificates (Farkas rays).

Host copy of ``smart_crossover_tpu/solvers/rays.py``; only the import paths
differ (the port may not import the JAX package).

The reference inherits INFEASIBLE/UNBOUNDED statuses — and, implicitly,
their Farkas certificates — from the vendor solvers (status plumbing at
reference solver_caller/caller.py:164-179).  The in-house IPM can only
*suspect* infeasibility or unboundedness from diverging iterates, and PDHG
not even that.  This module turns suspicion into proof:

* ``extract_farkas``  solves the *elastic* feasibility LP

      min 1's⁺ + 1's⁻   s.t.  A x + s⁺ − s⁻ = b,  l ≤ x ≤ u,  s ≥ 0

  exactly with the host simplex.  Its optimum is 0 iff the system is
  feasible; when positive, the dual optimal y IS a Farkas ray: with
  z = Aᵀy, LP duality gives  bᵀy − Σ_j sup_{l_j ≤ t ≤ u_j} z_j t  equal to
  the elastic optimum > 0, which is precisely the Farkas-lemma witness that
  {Ax = b, l ≤ x ≤ u} is empty.

* ``extract_ray`` finds a recession direction by solving

      min cᵀd   s.t.  A d = 0,  d ∈ box(recession cone ∩ [−1, 1]ⁿ)

  (d_j ≥ 0 where l_j is finite, d_j ≤ 0 where u_j is finite, d_j = 0 where
  both are).  The box makes it bounded; a negative optimum is an improving
  ray.  Combined with a feasible point from the elastic LP this certifies
  UNBOUNDED (unboundedness requires feasibility, not just a ray).

Both certificates are *verified* independently of how they were produced
(``verify_farkas`` / ``verify_ray``) — the acceptance oracle never trusts
the extraction.  Everything runs on the host in f64: certificates are
exactness-critical, off the device by design.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp


def _as_csr(A) -> sp.csr_matrix:
    return sp.csr_matrix(A).astype(np.float64)


def verify_farkas(A, b, l, u, y, tol: float = 1e-7) -> float:
    """Return the certified infeasibility margin of the Farkas ray ``y``
    (positive = proof that {Ax = b, l ≤ x ≤ u} is empty), normalised by the
    data scale.  The margin is

        bᵀy − Σ_j sup_{l_j ≤ t ≤ u_j} (Aᵀy)_j t

    with the convention that an infinite supremum (z_j > tol where u_j = ∞,
    or z_j < −tol where l_j = −∞) voids the certificate (−inf)."""
    A = _as_csr(A)
    b = np.asarray(b, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = A.T @ y
    scale = (1.0 + np.abs(b).max(initial=0.0)) * (
        1.0 + np.abs(y).max(initial=0.0))
    # sign feasibility of z against the infinite bounds
    bad_up = (~np.isfinite(u)) & (z > tol * scale)
    bad_lo = (~np.isfinite(l)) & (z < -tol * scale)
    if np.any(bad_up) or np.any(bad_lo):
        return -np.inf
    zc = np.where(np.isfinite(u), z, np.minimum(z, 0.0))
    zc = np.where(np.isfinite(l), zc, np.maximum(zc, 0.0))
    sup = np.where(zc > 0, zc * np.where(np.isfinite(u), u, 0.0),
                   zc * np.where(np.isfinite(l), l, 0.0))
    return float((b @ y - sup.sum()) / scale)


def verify_ray(A, c, l, u, d, tol: float = 1e-7) -> float:
    """Return the certified improvement rate −cᵀd of the recession ray ``d``
    (positive = proof of dual infeasibility: the objective is unbounded on
    any feasible set with this recession direction), normalised; −inf when
    d is not a recession direction (Ad ≠ 0 or a bound blocks it)."""
    A = _as_csr(A)
    c = np.asarray(c, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)
    dmax = np.abs(d).max(initial=0.0)
    if dmax <= 0:
        return -np.inf
    d = d / dmax
    resid = np.abs(A @ d).max(initial=0.0)
    Ascale = 1.0 + (np.abs(A.data).max(initial=0.0) if A.nnz else 0.0)
    if resid > tol * Ascale:
        return -np.inf
    if np.any(np.isfinite(l) & (d < -tol)) or np.any(
            np.isfinite(u) & (d > tol)):
        return -np.inf
    cscale = 1.0 + np.abs(c).max(initial=0.0)
    return float(-(c @ d) / cscale)


@dataclass
class RayCertificate:
    """Outcome of exact feasibility/boundedness classification."""

    status: str                       # 'FEASIBLE' | 'INFEASIBLE' | 'UNBOUNDED'
    farkas_ray: Optional[np.ndarray] = None   # dual ray proving infeasibility
    unbounded_ray: Optional[np.ndarray] = None  # primal recession direction
    feasible_x: Optional[np.ndarray] = None   # witness point when FEASIBLE
    margin: float = 0.0               # verified certificate margin


def extract_farkas(A, b, l, u, tol: float = 1e-8,
                   max_iter: int = 200_000) -> RayCertificate:
    """Exact feasibility test of {Ax = b, l ≤ x ≤ u} via the elastic LP.

    Returns FEASIBLE with a witness point, or INFEASIBLE with a verified
    Farkas ray (the elastic LP's dual optimal)."""
    from smart_crossover_tpu_torch.solvers.simplex import primal_simplex

    A = _as_csr(A)
    m, n = A.shape
    b = np.asarray(b, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    # elastic columns: +e_i and −e_i per row, cost 1, bounds [0, ∞)
    E = sp.hstack([sp.eye(m), -sp.eye(m)], format="csr")
    A_el = sp.hstack([A, E], format="csr")
    c_el = np.concatenate([np.zeros(n), np.ones(2 * m)])
    l_el = np.concatenate([l, np.zeros(2 * m)])
    u_el = np.concatenate([u, np.full(2 * m, np.inf)])
    res = primal_simplex(A_el, b, c_el, l_el, u_el, max_iter=max_iter,
                         pricing="devex")
    if res.status != "OPTIMAL":   # elastic LP is always feasible & bounded
        raise RuntimeError(
            f"elastic feasibility LP did not solve: {res.status}")
    scale = 1.0 + np.abs(b).max(initial=0.0)
    if res.obj_val <= tol * scale:
        return RayCertificate(status="FEASIBLE", feasible_x=res.x[:n].copy())
    margin = verify_farkas(A, b, l, u, res.y, tol=tol)
    if margin <= 0:
        raise RuntimeError(
            "elastic LP positive but Farkas ray failed verification "
            f"(margin={margin:.3e}) — numerical inconsistency")
    return RayCertificate(status="INFEASIBLE", farkas_ray=res.y.copy(),
                          margin=margin)


def extract_ray(A, c, l, u, tol: float = 1e-8,
                max_iter: int = 200_000) -> Optional[np.ndarray]:
    """Find a verified improving recession direction of
    min cᵀx s.t. Ax = b, l ≤ x ≤ u (any b), or None when none exists.

    The recession cone is boxed to [−1, 1]ⁿ so the search LP is bounded."""
    from smart_crossover_tpu_torch.solvers.simplex import primal_simplex

    A = _as_csr(A)
    m, n = A.shape
    c = np.asarray(c, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    lo = np.where(np.isfinite(l), 0.0, -1.0)
    hi = np.where(np.isfinite(u), 0.0, 1.0)
    if np.all(lo == 0.0) and np.all(hi == 0.0):
        return None   # recession cone is {0}
    res = primal_simplex(A, np.zeros(m), c, lo, hi, max_iter=max_iter,
                         pricing="devex")
    if res.status != "OPTIMAL":   # d=0 feasible, box-bounded ⇒ must solve
        raise RuntimeError(f"recession-ray LP did not solve: {res.status}")
    cscale = 1.0 + np.abs(c).max(initial=0.0)
    if res.obj_val >= -tol * cscale:
        return None
    d = res.x.copy()
    if verify_ray(A, c, l, u, d, tol=tol) <= 0:
        raise RuntimeError("improving direction failed ray verification — "
                           "numerical inconsistency")
    return d


def classify_lp(A, b, c, l, u, tol: float = 1e-8,
                max_iter: int = 200_000) -> RayCertificate:
    """Exactly classify min cᵀx s.t. Ax = b, l ≤ x ≤ u as FEASIBLE (bounded),
    INFEASIBLE (with Farkas ray) or UNBOUNDED (with feasible witness AND
    recession ray — both conditions, per the definition)."""
    cert = extract_farkas(A, b, l, u, tol=tol, max_iter=max_iter)
    if cert.status == "INFEASIBLE":
        return cert
    d = extract_ray(A, c, l, u, tol=tol, max_iter=max_iter)
    if d is None:
        return cert
    return RayCertificate(status="UNBOUNDED", unbounded_ray=d,
                          feasible_x=cert.feasible_x,
                          margin=verify_ray(A, c, l, u, d, tol=tol))
