"""Mehrotra predictor-corrector interior-point method for LP.

In-house replacement for the vendor barrier solves the reference delegates to
(``method='barrier'`` through solver_caller; e.g. reference
lp_methods/algorithms.py:38-40).  Solves

    min c'x   s.t.  A x = b,   l <= x <= u

with any mix of finite/infinite bounds and free variables, via normal
equations ``A D A' dy = r`` factorised with sparse LU on the host in float64
(the accuracy-critical path; the TPU carries the first-order engines).

Returns a genuinely *interior* iterate (strictly inside the bounds wherever
they are finite), which is what the crossover algorithms consume as x_bar.

Host copy of ``smart_crossover_tpu/solvers/ipm.py``; only the import paths
differ.  The opt-in device formation of the normal equations
(``solvers/ne_offload.py``) forms them on a CUDA card where the JAX
package formed them on a TPU.
"""
from __future__ import annotations

import datetime
import time
from dataclasses import dataclass

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla

try:
    from threadpoolctl import threadpool_limits as _tp_limits
except ImportError:  # pragma: no cover - threadpoolctl ships with scipy
    import contextlib

    def _tp_limits(*_a, **_k):
        return contextlib.nullcontext()

# Normal-equation matrices A D A' of LPs with even moderately dense rows
# fill in completely; factoring a (near-)dense SPD matrix with sparse LU is
# ~20x slower than LAPACK Cholesky at m=1500 (measured: 1.0s vs 0.05s), so
# route dense-enough systems to dpotrf.
_DENSE_NE_CUT = 0.2     # nnz(M)/m^2 above which the dense path is used
_DENSE_NE_MAX_M = 11585  # dense m x m memory cap (~1 GB f64)

# Above this row count, node-arc incidence A routes the normal equations to
# the tree-preconditioned PCG (solvers/laplacian.py) instead of a direct
# factorisation: graph Laplacians fill in catastrophically under generic
# orderings (STATUS.md #3) while the spanning-forest preconditioner tracks
# the IPM scaling.  Below it, direct factorisation is already fast.
_NE_PCG_MIN_M = 2000

import os as _os

_IPM_DEBUG = bool(_os.environ.get("SCX_IPM_DEBUG"))


def _scaled(A, d):
    """Column-scaled copy A @ diag(d) without a sparse matmat (csr only)."""
    W = A.copy()
    W.data = W.data * d[W.indices]
    return W


def _ext_residual(A_csr, nz_rows, x, b):
    """Extended-precision sparse residual ``b - A x`` (80-bit longdouble
    accumulation on x86).  The IPM endgame's primal residual is a
    cancellation of O(1) terms down to ~1e-8 and below; f64 accumulation
    noise (nnz_row * eps * |A||x| ~ 1e-13..1e-12) then contaminates the
    Newton right-hand side exactly when the degenerate-face correction
    needs its direction most (STATUS.md #0, VERDICT r2 item 8).  Cost is
    a few times one SpMV — negligible next to the factorisation."""
    prod = A_csr.data.astype(np.longdouble) \
        * x.astype(np.longdouble)[A_csr.indices]
    acc = np.zeros(A_csr.shape[0], dtype=np.longdouble)
    nz = nz_rows    # boolean nonempty-row mask (precomputed by caller)
    starts = A_csr.indptr[:-1][nz]
    if starts.size:
        acc[nz] = np.add.reduceat(prod, starts)
    return np.asarray(b.astype(np.longdouble) - acc, dtype=np.float64)


def _factor_spd(M, reg, force_dense: bool = False):
    """Factor the SPD normal-equations product M (+ reg I), dense or sparse
    by density.  The dense path adds the regularisation on the dense
    diagonal directly, skipping the 9M-nnz sparse tocsc/add round-trips
    that otherwise cost as much as the factorisation itself.

    ``force_dense`` routes to dense LAPACK regardless of fill: callers
    with WIDE multi-RHS solves (the bordered free-variable path applies
    M^-1 to the whole border every iteration) need BLAS3 dpotrs —
    SuperLU backsolves one RHS at a time and is ~10x slower there even
    when the factor itself is sparse.

    Accepts a scipy sparse matrix or a dense ndarray (e.g. the device-
    formed product from solvers/ne_offload.py).

    Returns ``solve(rhs)`` accepting a vector or matrix right-hand side.
    """
    m = M.shape[0]
    dense_in = isinstance(M, np.ndarray)
    if m <= _DENSE_NE_MAX_M and (dense_in or force_dense
                                 or M.nnz > _DENSE_NE_CUT * m * m):
        # All dense LAPACK here runs under a 1-thread BLAS limit: on shared
        # small hosts OpenBLAS's thread synchronisation costs 50-70x at
        # m~400 (343 ms vs 5 ms per dpotrf, measured) and still 5x at
        # m=3000, so single-threaded is uniformly faster for our sizes.
        Md0 = M if dense_in else M.toarray()
        # Network/transportation rows are linearly dependent (rank m-1), so
        # M is often PSD-singular: retry Cholesky with a stronger shift
        # before degrading to dense LU; never fall back to sparse LU here —
        # factoring a 50%-dense matrix as sparse is ~100x slower.
        with _tp_limits(limits=1, user_api="blas"):
            for shift in (reg, 1e-10 * (1.0 + float(Md0.diagonal().max()))):
                Md = Md0.copy()
                Md[np.diag_indices_from(Md)] += shift
                try:
                    cho = sla.cho_factor(Md, lower=True, overwrite_a=True,
                                         check_finite=False)

                    def _solve_cho(rhs, _cho=cho):
                        # wide multi-RHS solves are BLAS3 (dpotrs) and DO
                        # profit from threads; the 1-thread limit is only
                        # for the sync-dominated thin solves
                        if getattr(rhs, "ndim", 1) > 1 and rhs.shape[1] >= 64:
                            return sla.cho_solve(_cho, rhs,
                                                 check_finite=False)
                        with _tp_limits(limits=1, user_api="blas"):
                            return sla.cho_solve(_cho, rhs,
                                                 check_finite=False)

                    return _solve_cho
                except sla.LinAlgError:
                    continue
            Md = Md0
            Md[np.diag_indices_from(Md)] += reg
            lu_piv = sla.lu_factor(Md, check_finite=False)
            if np.abs(np.diag(lu_piv[0])).min() > 1e-300:

                def _solve_lu(rhs, _lu=lu_piv):
                    with _tp_limits(limits=1, user_api="blas"):
                        return sla.lu_solve(_lu, rhs, check_finite=False)

                return _solve_lu
    if dense_in:   # dense fell through every LAPACK attempt: sparsify
        M = sp.csr_matrix(M)
    lu = spla.splu((M + reg * sp.eye(m)).tocsc())
    return lu.solve


@dataclass
class IPMResult:
    x: np.ndarray
    y: np.ndarray
    zl: np.ndarray
    zu: np.ndarray
    obj_val: float
    iter_count: int
    status: str
    runtime: datetime.timedelta


def ipm_solve(A, b, c, l, u,
              tol: float = 1e-8,
              max_iter: int = 200,
              verbose: bool = False,
              x0=None, y0=None, zl0=None, zu0=None) -> IPMResult:
    """Solve the bounded-variable LP with Mehrotra predictor-corrector.

    ``x0``/``y0`` optionally warm-start the iterate: slacks are initialised
    from x0 pushed strictly interior and the dual pair is split from the
    dual residual at y0, both floored at a fraction of their average
    magnitude (a cold Mehrotra start otherwise).  Warm starts help most
    when the LP is a restriction or perturbation of one already solved
    near its optimal face, e.g. the perturbation-crossover subproblems.

    Passing the FULL primal-dual state (``x0, y0, zl0, zu0``) continues
    from it essentially as-is (only a strict-interior floor is applied):
    this is the refinement path for an already-centered interior iterate,
    e.g. the f32 device IPM's final point (solvers/ipm_fleet.py) — the
    magnitude-based re-splitting above would destroy its centrality.
    """
    t0 = time.perf_counter()
    A = sp.csr_matrix(A).astype(np.float64)
    m, n = A.shape
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)

    # presolve: eliminate fixed columns (l == u) so slacks stay positive
    fixed = np.isfinite(l) & np.isfinite(u) & (u - l <= 1e-14)
    if np.any(fixed):
        x_fix = l[fixed].copy()
        keep = ~fixed
        obj_shift = float(c[fixed] @ x_fix)
        res = ipm_solve(A[:, keep], b - A[:, fixed] @ x_fix, c[keep],
                        l[keep], u[keep], tol=tol, max_iter=max_iter,
                        verbose=verbose,
                        x0=None if x0 is None else np.asarray(x0)[keep],
                        y0=y0,
                        zl0=None if zl0 is None else np.asarray(zl0)[keep],
                        zu0=None if zu0 is None else np.asarray(zu0)[keep])
        x_full = np.empty(n)
        x_full[keep] = res.x
        x_full[fixed] = x_fix
        zl_full = np.zeros(n)
        zu_full = np.zeros(n)
        zl_full[keep] = res.zl
        zu_full[keep] = res.zu
        return IPMResult(x=x_full, y=res.y, zl=zl_full, zu=zu_full,
                         obj_val=res.obj_val + obj_shift,
                         iter_count=res.iter_count, status=res.status,
                         runtime=res.runtime)

    has_l = np.isfinite(l)
    has_u = np.isfinite(u)
    free = ~has_l & ~has_u
    # Free variables make the scaling matrix singular; a SMALL free set
    # goes through the bordered normal equations (symmetric elimination
    # of the skinny A_F border).  A WIDE free set breaks that path:
    # solveM(A_F) is an (m, f) multi-RHS back-solve per iteration
    # (f ~ 2000 free columns at optLP scale = ~10 min/iteration through
    # SuperLU, observed), and M = A_N D A_N' is structurally singular
    # when rows are covered only by free columns.  Wide sets instead stay
    # inside the plain normal equations with the capped scaling
    # d_free = d_cap (a primal proximal regularisation, Saunders) — the
    # same mechanism the endgame d-cap uses; the model error it
    # introduces is absorbed by the KKT-level refinement passes.
    wide_free = int(free.sum()) > 128
    use_augmented = bool(np.any(free)) and not wide_free

    AT = A.T.tocsr()

    # --- starting point -----------------------------------------------------
    # For boxed variables the slack pair must satisfy p + q = u - l exactly;
    # start at the midpoint.  One-sided slacks start at a comfortable 1.
    x = np.zeros(n)
    both = has_l & has_u
    x[both] = 0.5 * (l[both] + u[both])
    only_l = has_l & ~has_u
    x[only_l] = l[only_l] + 1.0
    only_u = has_u & ~has_l
    x[only_u] = u[only_u] - 1.0

    p = np.where(has_l, x - l, 1.0)   # slack to lower
    q = np.where(has_u, u - x, 1.0)   # slack to upper
    zl = np.where(has_l, 1.0 + np.abs(c), 0.0)
    zu = np.where(has_u, 1.0 + np.abs(c), 0.0)
    y = np.zeros(m)
    if x0 is not None and not np.all(np.isfinite(np.asarray(x0))):
        x0 = None   # a diverged warm start must not poison the solve
    if y0 is not None and not np.all(np.isfinite(np.asarray(y0))):
        y0 = None
    full_state = (x0 is not None and y0 is not None
                  and zl0 is not None and zu0 is not None
                  and np.all(np.isfinite(np.asarray(zl0)))
                  and np.all(np.isfinite(np.asarray(zu0))))
    if full_state:
        # continue a centered interior iterate: keep its geometry, only
        # enforce strict interiority (an f32 device iterate can sit at
        # ~1e-8 from a bound, which is fine; exact zeros are not).  Clamp
        # INTO the box first — an iterate slightly outside a bound would
        # otherwise initialise p + q > u - l, a violation the ratio tests
        # never repair
        x0 = np.asarray(x0, dtype=np.float64)
        x0 = np.clip(x0, np.where(has_l, l + 1e-12, -np.inf),
                     np.where(has_u, u - 1e-12, np.inf))
        p = np.where(has_l, np.maximum(x0 - l, 1e-12), 1.0)
        q = np.where(has_u, np.maximum(u - x0, 1e-12), 1.0)
        x = np.where(free, x0, x)
        y = np.asarray(y0, dtype=np.float64).copy()
        zl = np.where(has_l, np.maximum(np.asarray(zl0, np.float64),
                                        1e-12), 0.0)
        zu = np.where(has_u, np.maximum(np.asarray(zu0, np.float64),
                                        1e-12), 0.0)
    elif x0 is not None:
        x0 = np.asarray(x0, dtype=np.float64)
        p_w = np.where(has_l, x0 - l, 1.0)
        q_w = np.where(has_u, u - x0, 1.0)
        # push strictly interior: floor at a fraction of the mean slack
        fl_p = max(1e-8, 1e-2 * float(np.mean(np.abs(p_w[has_l])))
                   if np.any(has_l) else 1.0)
        fl_q = max(1e-8, 1e-2 * float(np.mean(np.abs(q_w[has_u])))
                   if np.any(has_u) else 1.0)
        p = np.where(has_l, np.maximum(p_w, fl_p), 1.0)
        q = np.where(has_u, np.maximum(q_w, fl_q), 1.0)
        x = np.where(free, x0, x)
    if (not full_state) and y0 is not None and np.asarray(y0).shape == (m,):
        y = np.asarray(y0, dtype=np.float64).copy()
        rd0 = c - AT @ y
        fl_z = max(1e-8, 1e-2 * float(np.mean(np.abs(rd0))))
        zl = np.where(has_l, np.maximum(rd0, fl_z), 0.0)
        zu = np.where(has_u, np.maximum(-rd0, fl_z), 0.0)

    bnorm = 1.0 + np.linalg.norm(b)
    cnorm = 1.0 + np.linalg.norm(c)

    # device offload of the dense normal-equations formation (opt-in;
    # see solvers/ne_offload.py for the accuracy/eligibility contract)
    from smart_crossover_tpu_torch.solvers.ne_offload import maybe_device_ne

    device_ne = maybe_device_ne(A)

    # network detection for the tree-PCG normal-equations path (large MCF)
    net_struct = None
    pcg_failed = False
    d_cap = 1e10   # tightened adaptively on PCG breakdown (see below)
    if not use_augmented and m >= _NE_PCG_MIN_M:
        from smart_crossover_tpu_torch.solvers.laplacian import analyze_network

        net_struct = analyze_network(A)
    A_sq = A.copy()
    A_sq.data = A_sq.data ** 2   # diag(A D A') = A_sq @ d, without forming M

    # cached-symbolic factorizer for the sparse normal equations: M's
    # pattern is iteration-invariant, so ordering/bandwidth analysis and
    # scatter maps are computed once (solvers/ne_factor.py)
    ne_fact = None

    def _factor_ne(M, reg):
        nonlocal ne_fact
        # cached-symbolic path for SPARSE normal equations; dense-filling
        # systems (nnz > cut) go to _factor_spd's LAPACK path while they
        # fit the dense memory cap
        if sp.issparse(M) and M.shape[0] > 4096 \
                and (M.nnz <= _DENSE_NE_CUT * M.shape[0] ** 2
                     or M.shape[0] > _DENSE_NE_MAX_M):
            if ne_fact is None:
                from smart_crossover_tpu_torch.solvers.ne_factor import (
                    NEFactorizer,
                )

                ne_fact = NEFactorizer(M)
            return ne_fact.factor(M, reg)
        return None

    status = "ITERATION_LIMIT"
    it = 0
    best = None
    best_score = np.inf
    mu_prev = np.inf
    stall_run = 0
    rows_rep = None        # nonempty-row masks, built lazily for the
    rows_rep_T = None      # extended-precision endgame residuals
    for it in range(1, max_iter + 1):
        # recover x from slacks for residuals (keep x as primary where free)
        x = np.where(has_l, l + p, np.where(has_u, u - q, x))

        if mu_prev < 1e-6:
            # endgame: 80-bit residual accumulation (see _ext_residual)
            if rows_rep is None:
                rows_rep = np.diff(A.indptr) > 0
                rows_rep_T = np.diff(AT.indptr) > 0
            r_p = _ext_residual(A, rows_rep, x, b)
            r_d = _ext_residual(AT, rows_rep_T, y, c) - zl + zu
        else:
            r_p = b - A @ x
            r_d = c - AT @ y - zl + zu
        n_comp = int(has_l.sum() + has_u.sum())
        gap = (p @ zl + q @ zu) if n_comp else 0.0
        mu = gap / max(n_comp, 1)

        primal_inf = np.linalg.norm(r_p) / bnorm
        dual_inf = np.linalg.norm(r_d) / cnorm
        pobj = c @ x
        dobj = float(b @ y + l[has_l] @ zl[has_l] - u[has_u] @ zu[has_u])
        rel_gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
        if verbose:
            print(f"ipm it={it} mu={mu:.2e} pinf={primal_inf:.2e} "
                  f"dinf={dual_inf:.2e} gap={rel_gap:.2e}")
        score = max(primal_inf, dual_inf, rel_gap)
        if score < best_score:
            best_score = score
            best = (x.copy(), y.copy(), zl.copy(), zu.copy(),
                    primal_inf, dual_inf, rel_gap)
        if primal_inf < tol and dual_inf < tol and rel_gap < tol:
            status = "OPTIMAL"
            break
        # stall: complementarity at machine precision and no longer
        # improving -> stop and return the best iterate seen
        # (post-convergence Mehrotra steps only pollute the duals)
        stall_run = stall_run + 1 if (mu > 0.5 * mu_prev
                                      and mu < 1e-11) else 0
        mu_prev = mu
        if stall_run >= 4:
            status = "STALLED"
            break
        if not np.isfinite(mu) or mu > 1e30 or primal_inf > 1e14:
            status = "NUMERICAL_ERROR"
            break
        xscale = float(np.abs(x).max(initial=0.0))
        if xscale > 1e12 and primal_inf < 1e-4:
            status = "UNBOUNDED"   # primal iterates diverge while feasible
            break
        if np.abs(y).max(initial=0.0) > 1e12 and dual_inf < 1e-4:
            status = "INFEASIBLE"  # dual iterates diverge while dual feasible
            break

        # scaling Dinv = Zl/P + Zu/Q (zero on free variables)
        dinv = (np.where(has_l, zl / p, 0.0)
                + np.where(has_u, zu / q, 0.0))

        # Endgame scaling cap for the DIRECT/bordered paths, mirroring the
        # tree-PCG path's d_cap: once mu < 1e-6 the raw spread in d reaches
        # ~1e14 and the back-substitution dx = d (A'dy - rhs) cancels
        # catastrophically on the large-d components — observed as primal
        # drift 1e-12 -> 3e-8 over the last 10 iterations at m=30k.  The
        # cap is a primal proximal regularisation (Saunders); the KKT-level
        # refinement loop absorbs the model error it introduces.
        # (wide_free pins the cap throughout: free columns ride the NE at
        # d = cap, and refinement contraction needs kappa*eps << 1)
        d_direct_cap = 1e10 if (mu_prev < 1e-6 or wide_free) else 1e14

        # Endgame back-substitution in 80-bit: dx = d (A'dy - rhs_x) with
        # d ~ 1e10 amplifies the f64 rounding of (A'dy - rhs_x) to an
        # absolute step error ~ d * eps ~ 1e-6 — the pinf floor observed
        # at m=30k (1e-12 -> 1e-8 drift).  longdouble accumulation moves
        # the floor down by ~2^11 for the cost of one extended SpMV per
        # back-solve (~ms), the same trick as _ext_residual.
        if mu_prev < 1e-6:
            if rows_rep_T is None:
                rows_rep = np.diff(A.indptr) > 0
                rows_rep_T = np.diff(AT.indptr) > 0

            def _atd(dy_, rhs_x_, _rT=rows_rep_T):
                return -_ext_residual(AT, _rT, dy_, rhs_x_)
        else:
            def _atd(dy_, rhs_x_):
                return AT @ dy_ - rhs_x_

        if use_augmented:
            # Bordered normal equations: eliminate the non-free variables
            # into M = A_N D_N A_N' and keep the (few) free columns as a
            # skinny border — far less fill than the full augmented KKT:
            #   [[M, A_F], [A_F', -delta I]] [dy; dxF] = [rhs1; rhs_F]
            nonfree = ~free
            d_nf = np.where(nonfree, 1.0 / np.maximum(dinv, 1e-14), 0.0)
            d_nf = np.minimum(d_nf, d_direct_cap)
            if device_ne is not None and mu > 1e-6:
                M = device_ne.form(d_nf)        # f64 GEMM on the card
            else:
                M = _scaled(A, d_nf) @ AT
            reg = 1e-12 * (1.0 + M.diagonal().max())
            A_F = A[:, free].tocsc()
            f = A_F.shape[1]
            free_idx = np.where(free)[0]
            # Block elimination on the skinny border: factor the SPD block M
            # once (dense Cholesky when filled-in), then a small f x f Schur
            # complement handles the free columns.  Falls back to a sparse
            # LU of the whole bordered matrix when M alone is (numerically)
            # singular, e.g. A_N rank-deficient without the free columns.
            try:
                # factorizer path: reg=0 — it applies tiny RELATIVE shifts
                # internally; a diag.max()-scaled scalar shift would cap the
                # KKT refinement contraction at reg/lambda_min (~0.85/pass
                # observed) and stall pinf at ~1e-8
                solveM = _factor_ne(M, 0.0)
                if solveM is None:
                    solveM = _factor_spd(
                        M, reg,
                        force_dense=(f >= 64 and m <= _DENSE_NE_MAX_M))
                AFd = A_F.toarray() if f else np.zeros((m, 0))
                Z = solveM(AFd) if f else np.zeros((m, 0))
                if f:
                    S = -1e-10 * np.eye(f) - AFd.T @ Z
                    S_lu = sla.lu_factor(S, check_finite=False)
                    # a zero U-pivot passes lu_factor but NaNs at solve time
                    u_diag = np.abs(np.diag(S_lu[0]))
                    if not (np.all(np.isfinite(Z))
                            and np.all(np.isfinite(S_lu[0]))
                            and u_diag.min() > 1e-300):
                        raise RuntimeError("singular normal-equations block")

                def kkt_solve(rhs_x, rp):
                    rhs1 = rp + A @ (d_nf * rhs_x)
                    dy = solveM(rhs1)
                    if f:
                        dxF = sla.lu_solve(S_lu,
                                           rhs_x[free_idx] - AFd.T @ dy,
                                           check_finite=False)
                        dy = dy - Z @ dxF
                    dx = d_nf * _atd(dy, rhs_x)
                    if f:
                        dx[free_idx] = dxF
                    return dx, dy
            except RuntimeError:
                K = sp.bmat([[M + reg * sp.eye(m), A_F],
                             [A_F.T, -1e-10 * sp.eye(f)]], format="csc")
                lu = spla.splu(K, permc_spec="MMD_AT_PLUS_A")

                def kkt_solve(rhs_x, rp):
                    rhs1 = rp + A @ (d_nf * rhs_x)
                    rhs2 = rhs_x[free_idx]
                    sol = lu.solve(np.concatenate([rhs1, rhs2]))
                    dy = sol[:m]
                    dxF = sol[m:]
                    dx = d_nf * _atd(dy, rhs_x)
                    dx[free_idx] = dxF
                    return dx, dy
        else:
            d = 1.0 / np.maximum(dinv, 1e-14)
            # In the iterative (PCG) path a 1e14 spread in d amplifies f64
            # roundoff past the 1e-8 primal target (the normal-equations rhs
            # mixes components ~1e6x apart); capping the scaling acts as a
            # primal proximal regularisation (Saunders) and restores the
            # attainable accuracy floor.  The direct path keeps the looser
            # cap — the factorisation absorbs the spread.
            d = np.minimum(d, d_cap if (net_struct is not None
                                        and not pcg_failed)
                           else d_direct_cap)
            solveM = None
            if net_struct is not None and not pcg_failed:
                from smart_crossover_tpu_torch.solvers.laplacian import (
                    make_tree_pcg_ne_solver,
                )

                diag_M = A_sq @ d
                reg = 1e-12 * (1.0 + float(diag_M.max(initial=0.0)))
                # NO regularisation inside the PCG operator: with d capped
                # at 1e10 the diagonal max makes a diag-scaled reg ~1e-1,
                # which injects reg*|dy| of primal error into every step
                # (measured: the exact NEAR_OPTIMAL plateau of VERDICT item
                # 3's repro).  Singularity is handled by explicit component
                # grounding instead.  reg stays for the direct fallback.
                pcg_solve = make_tree_pcg_ne_solver(
                    net_struct, A, AT, d, 0.0,
                    abs_tol=1e-2 * tol * bnorm)
                _direct: list = []

                def solveM(rhs_y, _pcg=pcg_solve, _d=d, _reg=reg):
                    nonlocal pcg_failed
                    if not pcg_failed:
                        try:
                            return _pcg(rhs_y)
                        except RuntimeError:
                            if m > 4000:
                                # a direct factorisation of a big graph
                                # Laplacian is the fill-in blowup this path
                                # exists to avoid; surface the breakdown and
                                # let the loop return the best iterate
                                raise
                            pcg_failed = True   # direct for the rest of solve
                    if not _direct:
                        _direct.append(
                            _factor_spd(_scaled(A, _d) @ AT, _reg))
                    return _direct[0](rhs_y)
            if solveM is None:
                if device_ne is not None and mu > 1e-6:
                    ADAt = device_ne.form(d)    # f64 GEMM on the card
                else:
                    ADAt = _scaled(A, d) @ AT
                reg = 1e-12 * (1.0 + ADAt.diagonal().max())
                reg_eff = reg
                try:
                    base_solve = _factor_ne(ADAt, 0.0)
                    if base_solve is None:
                        base_solve = _factor_spd(ADAt, reg)
                    else:
                        reg_eff = 0.0   # factorizer shifts are relative/tiny
                except RuntimeError:
                    base_solve = _factor_spd(ADAt, 1e-6)

                def solveM(rhs_y, _s=base_solve, _M=ADAt, _reg=reg_eff):
                    # one step of f64 iterative refinement: closes most of
                    # the conditioning gap on banded/staircase instances
                    # (STATUS.md #6, VERDICT.md item 8) for one extra
                    # back-solve on the existing factorisation
                    dy = _s(rhs_y)
                    r = rhs_y - (_M @ dy + _reg * dy)
                    rn = np.linalg.norm(r)
                    if np.isfinite(rn) and rn > 1e-14 * (
                            1.0 + np.linalg.norm(rhs_y)):
                        dy = dy + _s(r)
                    return dy

            iterative_ne = net_struct is not None and not pcg_failed

            def kkt_solve(rhs_x, rp):
                rhs_y = rp + A @ (d * rhs_x)
                dy = solveM(rhs_y)
                dx = d * _atd(dy, rhs_x)
                if iterative_ne:
                    # KKT-level refinement: the NE rhs mixes components up
                    # to ~1e6x the primal scale, so even a tight PCG solve
                    # leaves A dx != rp by more than the 1e-8 target.  The
                    # correction system has the SMALL residual as its rhs,
                    # where the same relative tolerance is plenty.
                    # loop: each pass cuts the error by the PCG tolerance;
                    # skipped while the step error is drowned by the current
                    # primal residual anyway (early iterations)
                    for _ in range(3):
                        rp_err = rp - A @ dx
                        rn = np.linalg.norm(rp_err)
                        if rn <= (1e-13 * bnorm
                                  + 1e-4 * np.linalg.norm(rp)):
                            break
                        dy_e = solveM(rp_err)
                        dx_e = d * _atd(dy_e, 0.0 * rhs_x)
                        if np.linalg.norm(rp_err - A @ dx_e) >= rn:
                            break   # no longer improving (f64 floor)
                        dx = dx + dx_e
                        dy = dy + dy_e
                    if _IPM_DEBUG:
                        print(f"   kkt: |rp_err|={np.linalg.norm(rp - A @ dx):.2e}"
                              f" |rp|={np.linalg.norm(rp):.2e}"
                              f" |dx|={np.abs(dx).max():.2e}")
                return dx, dy

        # KKT-level primal refinement for the DIRECT paths (the tree-PCG
        # path refines inside its own kkt_solve): near the boundary the
        # d-scaled back-substitution loses ~1e-7 of A dx = rp to
        # cancellation with d spreads ~1e14, observed as late-iteration
        # primal-infeasibility DRIFT (pinf 1e-9 -> 6e-7 while mu -> 1e-14
        # on a 3000x12000 sparse LP).  The correction re-solves with the
        # small residual as rhs on the EXISTING factorisation.
        if use_augmented or not (net_struct is not None and not pcg_failed):
            kkt_base = kkt_solve
            zero_rhs = np.zeros(n)

            def kkt_solve(rhs_x, rp, _inner=kkt_base, _z=zero_rhs):
                dx, dy = _inner(rhs_x, rp)
                for _pass in range(3):
                    rp_err = rp - A @ dx
                    rn = np.linalg.norm(rp_err)
                    if rn <= 1e-13 * bnorm + 1e-4 * np.linalg.norm(rp):
                        break
                    dx_e, dy_e = _inner(_z, rp_err)
                    rn2 = np.linalg.norm(rp_err - A @ dx_e)
                    if _IPM_DEBUG:
                        print(f"   kkt-ref pass={_pass} rn={rn:.3e} "
                              f"rn2={rn2:.3e} |rp|={np.linalg.norm(rp):.3e}")
                    if rn2 >= rn:
                        break   # no longer improving (f64 floor)
                    dx = dx + dx_e
                    dy = dy + dy_e
                return dx, dy

        def solve_newton(rp, rd, rcl, rcu):
            """Solve the reduced Newton system.

            dx satisfies: A dx = rp;
            dz from complementarity: P dzl + Zl dp = rcl, dp = dx;
                                     Q dzu + Zu dq = rcu, dq = -dx.
            Eliminating: A' dy - (Zl/P + Zu/Q) dx = rhs_x
            """
            rhs_x = rd - np.where(has_l, rcl / p, 0.0) \
                       + np.where(has_u, rcu / q, 0.0)
            dx, dy = kkt_solve(rhs_x, rp)
            dzl = np.where(has_l, (rcl - zl * dx) / p, 0.0)
            dzu = np.where(has_u, (rcu + zu * dx) / q, 0.0)
            return dx, dy, dzl, dzu

        # --- affine (predictor) step ---
        rcl_aff = np.where(has_l, -p * zl, 0.0)
        rcu_aff = np.where(has_u, -q * zu, 0.0)
        try:
            dx_a, dy_a, dzl_a, dzu_a = solve_newton(
                r_p, r_d, rcl_aff, rcu_aff)
        except RuntimeError:
            # tree-PCG breakdown on an extreme scaling spread: tighten the
            # cap (a stronger proximal regularisation narrows the numerical
            # range) and redo the iteration; give up only when the cap is
            # too tight to make progress anyway
            if d_cap > 1e6:
                d_cap /= 100.0
                continue
            status = "STALLED"
            break

        def max_step(v, dv, mask):
            neg = mask & (dv < 0)
            if not np.any(neg):
                return 1.0
            return min(1.0, float(np.min(-v[neg] / dv[neg])))

        ap_aff = min(max_step(p, dx_a, has_l), max_step(q, -dx_a, has_u))
        ad_aff = min(max_step(zl, dzl_a, has_l), max_step(zu, dzu_a, has_u))

        gap_aff = ((p + ap_aff * np.where(has_l, dx_a, 0.0)) @
                   (zl + ad_aff * dzl_a)
                   + (q - ap_aff * np.where(has_u, dx_a, 0.0)) @
                   (zu + ad_aff * dzu_a)) if n_comp else 0.0
        sigma = (gap_aff / gap) ** 3 if gap > 0 else 0.0
        sigma = min(max(sigma, 0.0), 1.0)

        # --- corrector step ---
        rcl = np.where(has_l, sigma * mu - p * zl
                       - np.where(has_l, dx_a, 0.0) * dzl_a, 0.0)
        rcu = np.where(has_u, sigma * mu - q * zu
                       + np.where(has_u, dx_a, 0.0) * dzu_a, 0.0)
        try:
            dx, dy, dzl, dzu = solve_newton(r_p, r_d, rcl, rcu)
        except RuntimeError:
            if d_cap > 1e6:
                d_cap /= 100.0
                continue
            status = "STALLED"
            break

        ap = 0.9995 * min(max_step(p, dx, has_l), max_step(q, -dx, has_u))
        ad = 0.9995 * min(max_step(zl, dzl, has_l), max_step(zu, dzu, has_u))
        ap = min(ap, 1.0)
        ad = min(ad, 1.0)

        # --- Gondzio multiple centrality correctors ---
        # Extra back-solves on the SAME factorisation that push outlying
        # complementarity products back toward the central path; accepted
        # only when they enlarge both step lengths.  Factorisation is the
        # per-iteration cost, so fewer iterations = direct wall-clock win.
        for _ in range(2):
            if ap > 0.95 and ad > 0.95:
                break
            tp = min(ap + 0.3, 1.0)
            td = min(ad + 0.3, 1.0)
            p_t = np.where(has_l, p + tp * dx, p)
            q_t = np.where(has_u, q - tp * dx, q)
            zl_t = zl + td * dzl
            zu_t = zu + td * dzu
            mu_t = ((p_t @ zl_t + q_t @ zu_t) / n_comp) if n_comp else 0.0
            vl = p_t * zl_t
            vu = q_t * zu_t
            tgt_l = np.clip(vl, 0.1 * mu_t, 10.0 * mu_t)
            tgt_u = np.clip(vu, 0.1 * mu_t, 10.0 * mu_t)
            ccl = np.where(has_l, tgt_l - vl, 0.0)
            ccu = np.where(has_u, tgt_u - vu, 0.0)
            try:
                cdx, cdy, cdzl, cdzu = solve_newton(
                    np.zeros(m), np.zeros(n), ccl, ccu)
            except RuntimeError:
                break   # corrector is optional; keep the accepted direction
            dx2, dy2 = dx + cdx, dy + cdy
            dzl2, dzu2 = dzl + cdzl, dzu + cdzu
            ap2 = 0.9995 * min(max_step(p, dx2, has_l),
                               max_step(q, -dx2, has_u))
            ad2 = 0.9995 * min(max_step(zl, dzl2, has_l),
                               max_step(zu, dzu2, has_u))
            ap2, ad2 = min(ap2, 1.0), min(ad2, 1.0)
            if ap2 >= ap + 0.03 and ad2 >= ad + 0.03:
                dx, dy, dzl, dzu = dx2, dy2, dzl2, dzu2
                ap, ad = ap2, ad2
            else:
                break

        x = x + ap * dx
        p = np.where(has_l, p + ap * dx, p)
        q = np.where(has_u, q - ap * dx, q)
        y = y + ad * dy
        zl = zl + ad * dzl
        zu = zu + ad * dzu
        # keep strictly interior
        p = np.where(has_l, np.maximum(p, 1e-14), p)
        q = np.where(has_u, np.maximum(q, 1e-14), q)
        zl = np.where(has_l, np.maximum(zl, 1e-14), 0.0)
        zu = np.where(has_u, np.maximum(zu, 1e-14), 0.0)

        if ap < 1e-10 and ad < 1e-10:
            status = "STALLED"
            break

    x = np.where(has_l, l + p, np.where(has_u, u - q, x))
    # prefer the best iterate seen: late Mehrotra steps near machine
    # precision can degrade the duals below what was already achieved
    if best is not None:
        cur_score = max(np.linalg.norm(b - A @ x) / bnorm,
                        np.linalg.norm(c - AT @ y - zl + zu) / cnorm)
        if best_score < cur_score:
            x, y, zl, zu, _, _, _ = best
        if status in ("STALLED", "ITERATION_LIMIT"):
            # grade the final iterate (restored OR current-best) honestly
            f_pinf = np.linalg.norm(b - A @ x) / bnorm
            f_dinf = np.linalg.norm(c - AT @ y - zl + zu) / cnorm
            f_pobj = float(c @ x)
            f_dobj = float(b @ y + l[has_l] @ zl[has_l]
                           - u[has_u] @ zu[has_u])
            f_gap = abs(f_pobj - f_dobj) / (1.0 + abs(f_pobj) + abs(f_dobj))
            if f_pinf < tol and f_dinf < tol and f_gap < tol:
                status = "OPTIMAL"
            elif (f_pinf < 100 * tol and f_dinf < 100 * tol
                    and f_gap < 100 * tol):
                # machine-precision plateau within 100x of the target:
                # honest label; the crossover consumers accept it (the
                # final simplex certifies exactness regardless)
                status = "NEAR_OPTIMAL"
    runtime = datetime.timedelta(seconds=time.perf_counter() - t0)
    return IPMResult(x=x, y=y, zl=zl, zu=zu, obj_val=float(c @ x),
                     iter_count=it, status=status, runtime=runtime)


def ipm_general_lp(lp, tol: float = 1e-8, max_iter: int = 200,
                   x0=None, y0=None) -> IPMResult:
    """Barrier-solve a GeneralLP by slack augmentation; returns the result in
    the ORIGINAL variable space (slacks stripped), with y over the rows."""
    A_std = lp.get_standard_A()
    c_std = lp.get_standard_c()
    l_std, u_std = lp.get_standard_bounds()
    x0_std = None
    if x0 is not None and np.asarray(x0).shape == (lp.n,):
        x0_std = lp.get_standard_x(np.asarray(x0, dtype=np.float64))
    res = ipm_solve(A_std, lp.b, c_std, l_std, u_std, tol=tol,
                    max_iter=max_iter, x0=x0_std, y0=y0)
    n = lp.n
    return IPMResult(x=res.x[:n], y=res.y, zl=res.zl[:n], zu=res.zu[:n],
                     obj_val=float(lp.c @ res.x[:n]),
                     iter_count=res.iter_count, status=res.status,
                     runtime=res.runtime)
