"""Restarted PDHG (PDLP-style) first-order LP solver.

Port of ``smart_crossover_tpu/solvers/pdhg.py``: ``PDHGResult``,
``estimate_opnorm``, ``_ruiz_equilibrate`` (host numpy, dense and sparse),
``_pdhg_core`` (adaptive steps + averaging restarts), ``_pdhg_core_halpern``
(restarted reflected Halpern), ``_pdhg_core_scipy`` (the host scipy mirror
of the adaptive core), ``_active_set_polish`` (host scipy), ``pdhg_solve``
and ``pdhg_general_lp``.  Solves

    min c'x  s.t.  A_eq x = b_eq,  A_le x <= b_le,  l <= x <= u.

The JAX cores are ``lax.while_loop``s under ``jit``; here the outer loop is
Python: one chunk of ``check_every`` iterations per step, then the restart
test, the KKT scores and the primal-weight update as tensor ops, and one
host read per chunk for the loop condition.  On a dense A the chunk is a
kernel wrapper of ``ops/pdhg_chunk.py`` (the CUDA kernel on a CUDA tensor,
its plain version on the CPU).  On a sparse A (a scipy sparse matrix, the
JAX package's BCOO) the cores take an operator (``ops/pdhg_sparse.py``: A
and A' as CSR tensors) and its tensor-code chunks, except where the JAX
package runs its host mirror: the adaptive mode on the CPU runs
``_pdhg_core_scipy``.
"""
from __future__ import annotations

import datetime
import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as ssp
import torch

from smart_crossover_tpu_torch.config import (
    device_float,
    resolve_device,
    use_kernel,
)
from smart_crossover_tpu_torch.ops.pdhg_chunk import (
    halpern_chunk,
    halpern_chunk_plain,
    pdhg_chunk,
    pdhg_chunk_plain,
)
from smart_crossover_tpu_torch.ops.pdhg_sparse import (
    CSROperator,
    sparse_halpern_chunk,
    sparse_pdhg_chunk,
)


@dataclass
class PDHGResult:
    x: np.ndarray
    y: np.ndarray
    obj_val: float
    iter_count: int
    status: str
    runtime: datetime.timedelta
    primal_residual: float
    dual_residual: float
    gap: float


def estimate_opnorm(A, iters: int = 50, seed: int = 0):
    """Power iteration for ||A||_2 from a seeded Gaussian start (a
    ``torch.Generator`` on the CPU: other numbers than ``jax.random``); A
    is a dense tensor or an ``ops/pdhg_sparse.py`` operator."""
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(A.shape[1], generator=gen, dtype=torch.float64)
    v = v.to(device=A.device, dtype=A.dtype)
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = A.T @ (A @ v)
        v = w / (torch.linalg.norm(w) + 1e-30)
    return torch.sqrt(torch.linalg.norm(A.T @ (A @ v)))


def _kkt_score(A, b, c, l, u, is_eq, bscale, cscale, x, y):
    """Normalised (primal residual, dual residual, gap) of (x, y)."""
    r = A @ x - b
    pviol = torch.where(is_eq, r, torch.clamp(r, min=0.0))
    pres = torch.linalg.norm(pviol) / bscale
    rc = c - A.T @ y
    fin_l = torch.isfinite(l)
    fin_u = torch.isfinite(u)
    lo_ok = fin_l & (x <= l + 1e-12)
    up_ok = fin_u & (x >= u - 1e-12)
    dviol = torch.where(lo_ok, torch.clamp(rc, max=0.0),
                        torch.where(up_ok, torch.clamp(rc, min=0.0), rc))
    dres = torch.linalg.norm(dviol) / cscale
    ly = torch.where(fin_l, l, 0.0)
    uy = torch.where(fin_u, u, 0.0)
    rc_pos = torch.clamp(rc, min=0.0) * fin_l
    rc_neg = torch.clamp(rc, max=0.0) * fin_u
    dual_obj = b @ y + ly @ rc_pos + uy @ rc_neg
    pobj = c @ x
    gap = torch.abs(pobj - dual_obj) / (1.0 + torch.abs(pobj)
                                        + torch.abs(dual_obj))
    return pres, dres, gap


def _restart_rule(score, score_lr, score_prev, cnt, it, check_every,
                  restart_period, done):
    """PDLP restart criteria: sufficient or necessary decay of the score,
    or an artificial restart once the window reaches
    max(restart_period, 0.36 * elapsed iterations)."""
    sufficient = score <= 0.2 * score_lr
    necessary = (score <= 0.8 * score_lr) & (score > score_prev)
    artificial = cnt >= max(restart_period, int(0.36 * (it + check_every)))
    return sufficient | necessary | artificial | done


def _omega_update(restart, cand_x, cand_y, x_lr, y_lr, omega):
    """Primal weight toward the closed window's dual/primal movement."""
    dx_move = torch.linalg.norm(cand_x - x_lr)
    dy_move = torch.linalg.norm(cand_y - y_lr)
    valid = restart & (dx_move > 1e-12) & (dy_move > 1e-12)
    log_ratio = torch.log(torch.where(valid, dy_move / dx_move, 1.0))
    omega = torch.where(valid,
                        torch.exp(0.5 * log_ratio + 0.5 * torch.log(omega)),
                        omega)
    return torch.clamp(omega, 1e-4, 1e4)


def _pdhg_core(A, b, c, l, u, is_eq, opnorm, x0, y0, max_iters: int,
               check_every: int, restart_period: int, tol: float,
               plain: bool = False):
    """Core loop with PDLP-style adaptive restarts and primal weight (see
    the JAX ``_pdhg_core``).  The chunk gets the GLOBAL iteration count as
    its schedule index.  A is a dense tensor (the chunk kernel, or with
    ``plain`` its plain version) or a sparse operator
    (``sparse_pdhg_chunk``).  Returns (x, y, iters, converged)."""
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    inf = torch.full((), float("inf"), dtype=A.dtype, device=A.device)
    bscale = 1.0 + torch.linalg.norm(b)
    cscale = 1.0 + torch.linalg.norm(c)
    eqf = is_eq.to(A.dtype)
    x, y = x0, y0
    Ax = A @ x0
    xs, ys, wsum = torch.zeros_like(x0), torch.zeros_like(y0), zero
    cnt = torch.zeros((), dtype=torch.int64, device=A.device)
    it = 0
    x_lr, y_lr = x0, y0
    score_lr = score_prev = best_score = inf
    best_x, best_y = x0, y0
    omega = torch.ones((), dtype=A.dtype, device=A.device)
    eta = 0.9 / opnorm
    done = torch.zeros((), dtype=torch.bool, device=A.device)
    chunk_fn = pdhg_chunk_plain if plain else pdhg_chunk
    while it < max_iters:
        if isinstance(A, torch.Tensor):
            x, y, Ax, xs, ys, wsum, eta = chunk_fn(
                A, b, c, l, u, eqf, x, y, Ax, xs, ys, wsum, eta, omega, it,
                opnorm, chunk=check_every)
        else:
            x, y, Ax, xs, ys, wsum, eta = sparse_pdhg_chunk(
                A, b, c, l, u, is_eq, x, y, Ax, xs, ys, wsum, eta, omega,
                it, opnorm, check_every)
        cnt = cnt + check_every
        pos = wsum > 0
        safe_w = torch.where(pos, wsum, 1.0)
        x_avg = torch.where(pos, xs / safe_w, x)
        y_avg = torch.where(pos, ys / safe_w, y)
        pres_c, dres_c, gap_c = _kkt_score(A, b, c, l, u, is_eq, bscale,
                                           cscale, x, y)
        pres_a, dres_a, gap_a = _kkt_score(A, b, c, l, u, is_eq, bscale,
                                           cscale, x_avg, y_avg)
        score_c = pres_c + dres_c + gap_c
        score_a = pres_a + dres_a + gap_a
        use_avg = score_a < score_c
        cand_x = torch.where(use_avg, x_avg, x)
        cand_y = torch.where(use_avg, y_avg, y)
        score = torch.minimum(score_a, score_c)
        pres = torch.where(use_avg, pres_a, pres_c)
        dres = torch.where(use_avg, dres_a, dres_c)
        gap = torch.where(use_avg, gap_a, gap_c)
        improved = score < best_score
        best_x = torch.where(improved, cand_x, best_x)
        best_y = torch.where(improved, cand_y, best_y)
        best_score = torch.minimum(score, best_score)
        done = (pres < tol) & (dres < tol) & (gap < tol)
        restart = _restart_rule(score, score_lr, score_prev, cnt, it,
                                check_every, restart_period, done)
        omega = _omega_update(restart, cand_x, cand_y, x_lr, y_lr, omega)
        x = torch.where(restart, cand_x, x)
        y = torch.where(restart, cand_y, y)
        Ax = torch.where(restart, A @ x, Ax)
        xs = torch.where(restart, 0.0, xs)
        ys = torch.where(restart, 0.0, ys)
        wsum = torch.where(restart, 0.0, wsum)
        cnt = torch.where(restart, 0, cnt)
        x_lr = torch.where(restart, x, x_lr)
        y_lr = torch.where(restart, y, y_lr)
        score_lr = torch.where(restart, score, score_lr)
        score_prev = score
        it += check_every
        if bool(done):
            break
    # converged -> the converging restart point; iteration-limited -> the
    # best iterate seen
    x = torch.where(done, x, best_x)
    y = torch.where(done, y, best_y)
    return x, y, it, bool(done)


def _pdhg_core_halpern(A, b, c, l, u, is_eq, opnorm, x0, y0,
                       max_iters: int, check_every: int,
                       restart_period: int, tol: float, plain: bool = False):
    """Restarted reflected-Halpern PDHG (r2HPDHG; see the JAX
    ``_pdhg_core_halpern``).  The chunk gets the iterations since the last
    restart (cnt) as its Halpern index; the anchors move only at a
    restart.  A is a dense tensor (the chunk kernel) or a sparse operator
    (``sparse_halpern_chunk``); ``plain`` as for ``_pdhg_core``.  Returns
    (x, y, iters, converged)."""
    inf = torch.full((), float("inf"), dtype=A.dtype, device=A.device)
    bscale = 1.0 + torch.linalg.norm(b)
    cscale = 1.0 + torch.linalg.norm(c)
    eqf = is_eq.to(A.dtype)
    step = 0.99 / opnorm
    Ax0 = A @ x0
    x, y, Ax = x0, y0, Ax0
    xa, ya, Axa = x0, y0, Ax0
    cnt = torch.zeros((), dtype=torch.int64, device=A.device)
    it = 0
    x_lr, y_lr = x0, y0
    score_lr = score_prev = best_score = inf
    best_x, best_y = x0, y0
    omega = torch.ones((), dtype=A.dtype, device=A.device)
    done = torch.zeros((), dtype=torch.bool, device=A.device)
    chunk_fn = halpern_chunk_plain if plain else halpern_chunk
    while it < max_iters:
        if isinstance(A, torch.Tensor):
            x, y, Ax, _ = chunk_fn(A, b, c, l, u, eqf, x, y, Ax, xa, ya,
                                   Axa, omega, cnt.to(A.dtype), step,
                                   chunk=check_every)
        else:
            x, y, Ax, _ = sparse_halpern_chunk(
                A, b, c, l, u, is_eq, x, y, Ax, xa, ya, Axa, omega,
                cnt.to(A.dtype), step, check_every)
        cnt = cnt + check_every
        # the restart/output candidate is T(z), the PDHG image of the
        # Halpern iterate
        tau = step / omega
        sigma = step * omega
        x_c = torch.minimum(torch.maximum(x - tau * (c - A.T @ y), l), u)
        Ax_c = A @ x_c
        y_t = y + sigma * (b - (2.0 * Ax_c - Ax))
        y_c = torch.where(is_eq, y_t, torch.clamp(y_t, max=0.0))
        pres, dres, gap = _kkt_score(A, b, c, l, u, is_eq, bscale, cscale,
                                     x_c, y_c)
        kkt = pres + dres + gap
        improved = kkt < best_score
        best_x = torch.where(improved, x_c, best_x)
        best_y = torch.where(improved, y_c, best_y)
        best_score = torch.minimum(kkt, best_score)
        done = (pres < tol) & (dres < tol) & (gap < tol)
        # r2HPDHG restarts on the fixed-point residual ||z - T(z)||_omega
        score = torch.sqrt(omega * torch.sum((x_c - x) ** 2)
                           + torch.sum((y_c - y) ** 2) / omega)
        restart = _restart_rule(score, score_lr, score_prev, cnt, it,
                                check_every, restart_period, done)
        omega = _omega_update(restart, x_c, y_c, x_lr, y_lr, omega)
        # restart: jump to T(z) and re-anchor there; cnt (the Halpern
        # index) starts again at 0
        x = torch.where(restart, x_c, x)
        y = torch.where(restart, y_c, y)
        Ax = torch.where(restart, Ax_c, Ax)
        xa = torch.where(restart, x_c, xa)
        ya = torch.where(restart, y_c, ya)
        Axa = torch.where(restart, Ax_c, Axa)
        cnt = torch.where(restart, 0, cnt)
        x_lr = torch.where(restart, x_c, x_lr)
        y_lr = torch.where(restart, y_c, y_lr)
        score_lr = torch.where(restart, score, score_lr)
        score_prev = score
        it += check_every
        if bool(done):
            break
    x = torch.where(done, x, best_x)
    y = torch.where(done, y, best_y)
    return x, y, it, bool(done)


def _pdhg_core_scipy(A_csr, b, c, l, u, is_eq, opnorm, x0, y0,
                     max_iters: int, check_every: int,
                     restart_period: int, tol: float):
    """Host scipy-sparse mirror of _pdhg_core (adaptive mode), which the
    JAX package runs for a sparse A on its CPU backend: same math and
    restart logic as the core; numpy f64 throughout.  Returns (x, y,
    iters, converged) as numpy arrays and Python scalars."""
    A = ssp.csr_matrix(A_csr)
    AT = A.T.tocsr()
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    l = np.asarray(l, np.float64)
    u = np.asarray(u, np.float64)
    is_eq = np.asarray(is_eq, bool)
    opnorm = float(opnorm)
    bscale = 1.0 + np.linalg.norm(b)
    cscale = 1.0 + np.linalg.norm(c)
    fin_l = np.isfinite(l)
    fin_u = np.isfinite(u)
    ly = np.where(fin_l, l, 0.0)
    uy = np.where(fin_u, u, 0.0)

    def proj_x(x):
        return np.clip(x, l, u)

    def proj_y(y):
        return np.where(is_eq, y, np.minimum(y, 0.0))

    def kkt_score(x, y):
        r = A @ x - b
        pres = np.linalg.norm(np.where(is_eq, r, np.maximum(r, 0.0))) \
            / bscale
        rc = c - AT @ y
        lo_ok = fin_l & (x <= l + 1e-12)
        up_ok = fin_u & (x >= u - 1e-12)
        dviol = np.where(lo_ok, np.minimum(rc, 0.0),
                         np.where(up_ok, np.maximum(rc, 0.0), rc))
        dres = np.linalg.norm(dviol) / cscale
        dual_obj = b @ y + ly @ (np.maximum(rc, 0.0) * fin_l) \
            + uy @ (np.minimum(rc, 0.0) * fin_u)
        pobj = c @ x
        gap = abs(pobj - dual_obj) / (1.0 + abs(pobj) + abs(dual_obj))
        return pres, dres, gap

    x = proj_x(np.asarray(x0, np.float64).copy())
    y = np.asarray(y0, np.float64).copy()
    Ax = A @ x
    xs = np.zeros_like(x)
    ys = np.zeros_like(y)
    wsum = 0.0
    eta = 0.9 / opnorm
    omega = 1.0
    cnt = 0
    it = 0
    x_lr, y_lr = x.copy(), y.copy()
    score_lr = score_prev = np.inf
    best_x, best_y, best_score = x.copy(), y.copy(), np.inf
    done = False
    while it < max_iters and not done:
        for _ in range(check_every):
            tau = eta / omega
            sigma = eta * omega
            x_c = proj_x(x - tau * (c - AT @ y))
            Ax_c = A @ x_c
            y_c = proj_y(y + sigma * (b - (2.0 * Ax_c - Ax)))
            dx = x_c - x
            dy = y_c - y
            curv = abs(dy @ (Ax_c - Ax))
            nz = omega * (dx @ dx) + (dy @ dy) / omega
            eta_bar = nz / (2.0 * curv) if curv > 0 else 1e10 / opnorm
            k1 = it + 2.0
            if eta <= eta_bar:
                x, y, Ax = x_c, y_c, Ax_c
                xs += eta * x
                ys += eta * y
                wsum += eta
            eta = min((1.0 - k1 ** -0.3) * eta_bar,
                      (1.0 + k1 ** -0.6) * eta)
            eta = min(max(eta, 1e-10 / opnorm), 1e10 / opnorm)
            it += 1
        cnt += check_every
        x_avg = xs / wsum if wsum > 0 else x
        y_avg = ys / wsum if wsum > 0 else y
        pres_c, dres_c, gap_c = kkt_score(x, y)
        pres_a, dres_a, gap_a = kkt_score(x_avg, y_avg)
        if pres_a + dres_a + gap_a < pres_c + dres_c + gap_c:
            cand_x, cand_y = x_avg, y_avg
            pres, dres, gap = pres_a, dres_a, gap_a
        else:
            cand_x, cand_y = x, y
            pres, dres, gap = pres_c, dres_c, gap_c
        score = pres + dres + gap
        if score < best_score:
            best_x, best_y, best_score = cand_x.copy(), cand_y.copy(), score
        done = pres < tol and dres < tol and gap < tol
        sufficient = score <= 0.2 * score_lr
        necessary = score <= 0.8 * score_lr and score > score_prev
        artificial = cnt >= max(restart_period, int(0.36 * it))
        if sufficient or necessary or artificial or done:
            dx_move = np.linalg.norm(cand_x - x_lr)
            dy_move = np.linalg.norm(cand_y - y_lr)
            if dx_move > 1e-12 and dy_move > 1e-12:
                omega = float(np.exp(0.5 * np.log(dy_move / dx_move)
                                     + 0.5 * np.log(omega)))
                omega = min(max(omega, 1e-4), 1e4)
            x, y = cand_x.copy(), cand_y.copy()
            Ax = A @ x
            xs[:] = 0.0
            ys[:] = 0.0
            wsum = 0.0
            cnt = 0
            x_lr, y_lr = x.copy(), y.copy()
            score_lr = score
        score_prev = score
    if not done:
        x, y = best_x, best_y
    return x, y, it, done


def _ruiz_equilibrate(A, iters: int = 10):
    """Ruiz diagonal equilibration (host f64): returns (R, C) with R A C
    well scaled.  A is a dense array or a scipy sparse matrix (the JAX
    package's BCOO branch: the same passes over the nonzeros)."""
    if ssp.issparse(A):
        coo = A.tocoo()
        rows, cols = coo.row, coo.col
        data = np.asarray(coo.data, dtype=np.float64)
        m, n = A.shape
        R = np.ones(m)
        C = np.ones(n)
        for _ in range(iters):
            v = np.abs(data) * R[rows] * C[cols]
            rmax = np.zeros(m)
            np.maximum.at(rmax, rows, v)
            R /= np.where(rmax > 0, np.sqrt(rmax), 1.0)
            v = np.abs(data) * R[rows] * C[cols]
            cmax = np.zeros(n)
            np.maximum.at(cmax, cols, v)
            C /= np.where(cmax > 0, np.sqrt(cmax), 1.0)
        return R, C
    An = np.abs(np.asarray(A, dtype=np.float64))
    m, n = An.shape
    R = np.ones(m)
    C = np.ones(n)
    for _ in range(iters):
        rmax = (An * R[:, None] * C[None, :]).max(axis=1)
        R /= np.where(rmax > 0, np.sqrt(rmax), 1.0)
        cmax = (An * R[:, None] * C[None, :]).max(axis=0)
        C /= np.where(cmax > 0, np.sqrt(cmax), 1.0)
    return R, C


def _active_set_polish(A_sp, b, c, l, u, eq, x, y):
    """Active-set Newton polish (the analog of PDLP's feasibility
    polishing): a stalled PDHG tail leaves tiny KKT violations whose decay
    rate is set by the LP's sharpness constant — but by then the active set
    is usually IDENTIFIED, so one least-squares solve per side removes them:

    * primal: snap at-bound variables exactly to their bounds, then add the
      minimum-norm interior correction restoring A x = b on active rows;
    * dual: re-solve y from the interior (basic-ish) columns' stationarity
      c_I = A_Iᵀ y in least squares, zeroing inactive '<='-row duals.

    Both are matrix-free LSMR solves on host f64.  The caller accepts the
    polished pair only if the verified KKT score improves, so a wrong
    active-set guess degrades nothing."""
    import scipy.sparse.linalg as spla

    from scipy.optimize import lsq_linear

    m, n = A_sp.shape
    scale = 1e-6 * (1.0 + np.abs(x).max(initial=0.0))
    at_l = np.isfinite(l) & (x - l <= scale)
    at_u = np.isfinite(u) & (u - x <= scale) & ~at_l
    interior = ~at_l & ~at_u
    # '<=' rows with (numerically) zero dual are inactive: slack stays basic
    yscale = 1e-8 * (1.0 + np.abs(y).max(initial=0.0))
    active_row = eq | (y < -yscale)
    A_act = A_sp[active_row].tocsc()
    b_act = b[active_row]
    cscale = 1.0 + np.abs(c).max(initial=0.0)
    bscale = 1.0 + np.abs(b).max(initial=0.0)

    def primal_fit(at_l_t, at_u_t, interior_t):
        """Snap bound variables and redistribute the active-row residual
        over the interior columns WITHIN their bounds (bounded LSQ — an
        unbounded correction can be infeasible exactly when the tentative
        eviction is wrong).  Returns (x_t, residual_norm)."""
        x_t = x.copy()
        x_t[at_l_t] = l[at_l_t]
        x_t[at_u_t] = u[at_u_t]
        idx = np.where(interior_t)[0]
        if idx.size and active_row.any():
            r = b_act - A_act @ x_t
            fit = lsq_linear(A_act[:, idx], r,
                             bounds=(l[idx] - x_t[idx], u[idx] - x_t[idx]),
                             method="trf", lsq_solver="lsmr",
                             lsmr_tol=1e-14, max_iter=30)
            x_t[idx] += fit.x
        return x_t, float(np.linalg.norm(b_act - A_act @ x_t))

    # dual side with active-set refinement: an over-included interior column
    # (one the optimum actually parks at a bound, but the FOM left slightly
    # inside) makes c_I = A_Iᵀ y inconsistent and smears ~equal residual
    # over every column.  Evict the worst violator to the bound its
    # reduced-cost sign implies — but commit only when the bounded primal
    # redistribution stays feasible (a wrong eviction shows up there).
    y_act = y[active_row].astype(np.float64)
    banned = np.zeros(n, dtype=bool)
    for _ in range(8):
        idx_i = np.where(interior)[0]
        if idx_i.size == 0:
            break
        A_ai = A_act[:, idx_i]
        y_act = spla.lsmr(A_ai.T, c[idx_i], atol=1e-14, btol=1e-14,
                          maxiter=500, x0=y_act)[0]
        rc_i = c[idx_i] - A_ai.T @ y_act
        evict = -1
        for j_rel in np.argsort(-np.abs(rc_i))[:4]:
            if abs(rc_i[j_rel]) <= 1e-12 * cscale:
                break
            j = idx_i[j_rel]
            if banned[j]:
                continue
            if rc_i[j_rel] > 0 and np.isfinite(l[j]):
                evict, to_lower = j, True
                break
            if rc_i[j_rel] < 0 and np.isfinite(u[j]):
                evict, to_lower = j, False
                break
        if evict < 0:
            break
        at_l_t, at_u_t = at_l.copy(), at_u.copy()
        (at_l_t if to_lower else at_u_t)[evict] = True
        interior_t = interior.copy()
        interior_t[evict] = False
        x_t, resid = primal_fit(at_l_t, at_u_t, interior_t)
        if resid <= 1e-9 * bscale:
            at_l, at_u, interior = at_l_t, at_u_t, interior_t
        else:
            banned[evict] = True   # infeasible eviction: keep it interior

    y_p = np.zeros(m)
    y_p[active_row] = y_act
    # keep '<=' duals sign-feasible
    y_p = np.where(eq, y_p, np.minimum(y_p, 0.0))
    x_p, _ = primal_fit(at_l, at_u, interior)
    return x_p, y_p


def _host_kkt(A_host, b_h, c_h, ln, un, eq, xv, yv):
    """(primal residual, dual residual, gap) on the host in f64."""
    r = A_host @ xv - b_h
    pres = float(np.linalg.norm(np.where(eq, r, np.maximum(r, 0.0)))
                 / (1.0 + np.linalg.norm(b_h)))
    rc = c_h - A_host.T @ yv
    lo_ok = np.isfinite(ln) & (xv <= ln + 1e-10)
    up_ok = np.isfinite(un) & (xv >= un - 1e-10)
    dviol = np.where(lo_ok, np.minimum(rc, 0.0),
                     np.where(up_ok, np.maximum(rc, 0.0), rc))
    dres = float(np.linalg.norm(dviol) / (1.0 + np.linalg.norm(c_h)))
    dual_obj = float(b_h @ yv
                     + np.where(np.isfinite(ln), ln, 0.0)
                     @ (np.maximum(rc, 0.0) * np.isfinite(ln))
                     + np.where(np.isfinite(un), un, 0.0)
                     @ (np.minimum(rc, 0.0) * np.isfinite(un)))
    pobj_s = float(c_h @ xv)
    gap = abs(pobj_s - dual_obj) / (1.0 + abs(pobj_s) + abs(dual_obj))
    return pres, dres, gap


def _host(v):
    """A numpy view of an array or tensor (None stays None)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return None if v is None else np.asarray(v)


def _host_sparse(A):
    """A sparse A (scipy, or a sparse tensor) as a scipy COO matrix, or
    None for a dense A."""
    if ssp.issparse(A):
        return A.tocoo()
    if isinstance(A, torch.Tensor) and A.layout != torch.strided:
        A = A.detach().cpu().to_sparse_coo().coalesce()
        rows, cols = A.indices().numpy()
        return ssp.coo_matrix((A.values().numpy(), (rows, cols)),
                              shape=tuple(A.shape))
    return None


def _scipy_opnorm(A_sp, n: int) -> float:
    """The JAX package's host power iteration for ||A||_2 (50 rounds from
    a numpy Gaussian start, seed 0), run where the host core runs."""
    v = np.random.default_rng(0).standard_normal(n)
    v /= np.linalg.norm(v)
    AT_sp = A_sp.T.tocsr()
    for _ in range(50):
        w = AT_sp @ (A_sp @ v)
        v = w / (np.linalg.norm(w) + 1e-30)
    return float(np.sqrt(np.linalg.norm(AT_sp @ (A_sp @ v))))


def pdhg_solve(A, b, c, l, u, sense=None,
               tol: float = 1e-6,
               max_iters: int = 100_000,
               restart_period: int = 200,
               x0=None, y0=None, rescale: bool = True,
               polish: bool = True,
               use_pallas: bool | None = None,
               mode: str = "adaptive", *,
               device=None) -> PDHGResult:
    """Solve an LP with restarted PDHG (Ruiz-equilibrated by default).

    Args:
        A: (m, n) dense numpy array or tensor, or a sparse matrix (scipy
            sparse, or a sparse tensor; the JAX package's BCOO).
        sense: length-m array of '='/'<' (None = all equality).
        mode: 'adaptive' (PDLP adaptive step sizes + averaging restarts)
            or 'halpern' (restarted reflected-Halpern acceleration).
        use_pallas: on a dense A, the choice between the chunk kernel and
            its plain version (``config.use_kernel``): None takes the
            kernel on a CUDA card, True raises elsewhere, False runs the
            plain version.  A sparse A has no kernel and ignores it.
        device: where the iterations run (default: A's device if A is a
            tensor, else the CUDA card; without one that default raises).
            On CUDA the iterations run in float32: on a dense A every
            chunk of 64 iterations is one launch of the hand-written
            kernel, on a sparse A a chunk of sparse products and vector
            updates.  With ``device="cpu"`` they run in A's dtype: the
            dense kernel's plain version, or for a sparse A the host
            scipy core (adaptive, as the JAX package on its CPU backend)
            or the sparse tensor chunks (halpern).

    Returns a ``PDHGResult`` with x, y unscaled to the original problem;
    the residuals are measured on the host in f64 in the scaled space.
    """
    t0 = time.perf_counter()
    if mode not in ("adaptive", "halpern"):
        raise ValueError(f"pdhg_solve: unknown mode {mode!r}")
    dev = resolve_device(device, A)
    A_coo = _host_sparse(A)
    plain = A_coo is None and not use_kernel(use_pallas, dev)
    A_in = A_coo if A_coo is not None else _host(A)
    b, c, l, u, x0, y0 = (_host(v) for v in (b, c, l, u, x0, y0))
    dtype = device_float(dev, torch.float32 if A_in.dtype == np.float32
                         else torch.float64)
    m, n = A_in.shape
    c_in = np.asarray(c, dtype=np.float64)

    R = C = None
    A_np = A_in
    if rescale:
        R, C = _ruiz_equilibrate(A_in)
        if A_coo is not None:
            A_np = ssp.coo_matrix(
                (A_coo.data * R[A_coo.row] * C[A_coo.col],
                 (A_coo.row, A_coo.col)), shape=(m, n))
        else:
            A_np = A_in * R[:, None] * C[None, :]
        b = np.asarray(b, dtype=np.float64) * R
        c = np.asarray(c, dtype=np.float64) * C
        with np.errstate(invalid="ignore"):
            l = np.asarray(l, dtype=np.float64) / C
            u = np.asarray(u, dtype=np.float64) / C
        if x0 is not None:
            x0 = np.asarray(x0, dtype=np.float64) / C
        if y0 is not None:
            y0 = np.asarray(y0, dtype=np.float64) / R

    def dev_t(v):
        return torch.as_tensor(v).to(device=dev, dtype=dtype).contiguous()

    b, c, l, u = dev_t(b), dev_t(c), dev_t(l), dev_t(u)
    if sense is None:
        is_eq = torch.ones(m, dtype=torch.bool, device=dev)
    else:
        is_eq = torch.as_tensor(np.asarray(sense) == "=", device=dev)
    x0 = torch.clamp(torch.zeros(n, dtype=dtype, device=dev), l, u) \
        if x0 is None else dev_t(x0)
    y0 = torch.zeros(m, dtype=dtype, device=dev) if y0 is None \
        else dev_t(y0)
    check_every = min(64, restart_period)
    core_kw = dict(max_iters=max_iters, check_every=check_every,
                   restart_period=restart_period, tol=tol)

    if A_coo is not None:
        # the scaled nonzeros in the device dtype: what the device holds
        # and what the host residuals below are measured on
        data = torch.as_tensor(A_np.data).to(dtype).double().numpy()
        A_host = ssp.csr_matrix((data, (A_np.row, A_np.col)), shape=(m, n))
        h64 = [v.double().cpu().numpy() for v in (b, c, l, u, x0, y0)]
        if mode == "adaptive" and dev.type == "cpu":
            # the JAX package's route for a sparse A on its CPU backend
            x, y, iters, done = _pdhg_core_scipy(
                A_host, *h64[:4], is_eq.cpu().numpy(),
                _scipy_opnorm(A_host, n), *h64[4:], **core_kw)
        else:
            op = CSROperator(A_np.row, A_np.col, data, (m, n), dtype, dev)
            core = _pdhg_core_halpern if mode == "halpern" else _pdhg_core
            x, y, iters, done = core(op, b, c, l, u, is_eq,
                                     estimate_opnorm(op), x0, y0, **core_kw)
            x = x.double().cpu().numpy()
            y = y.double().cpu().numpy()
    else:
        At = dev_t(A_np)
        core = _pdhg_core_halpern if mode == "halpern" else _pdhg_core
        x, y, iters, done = core(At, b, c, l, u, is_eq, estimate_opnorm(At),
                                 x0, y0, plain=plain, **core_kw)
        x = x.double().cpu().numpy()
        y = y.double().cpu().numpy()
        A_host = ssp.csr_matrix(At.double().cpu().numpy())
    # residuals below are measured in the (well-conditioned) scaled space;
    # the returned x, y, obj_val are unscaled to the original problem
    x_out = x * C if rescale else x
    y_out = y * R if rescale else y

    # final residuals (host f64, scaled space — the space the core measured)
    b_h = b.double().cpu().numpy()
    c_h = c.double().cpu().numpy()
    ln = l.double().cpu().numpy()
    un = u.double().cpu().numpy()
    eq = is_eq.cpu().numpy()

    pres, dres, gap = _host_kkt(A_host, b_h, c_h, ln, un, eq, x, y)
    if polish and max(pres, dres, gap) > 1e-14:
        try:
            x_p, y_p = _active_set_polish(A_host, b_h, c_h, ln, un, eq, x, y)
            p2, d2, g2 = _host_kkt(A_host, b_h, c_h, ln, un, eq, x_p, y_p)
            if max(p2, d2, g2) < max(pres, dres, gap):
                x, y = x_p, y_p
                pres, dres, gap = p2, d2, g2
                x_out = x * C if rescale else x
                y_out = y * R if rescale else y
        except Exception:   # polish is best-effort; the FOM pair stands
            pass
    done = bool(done) or max(pres, dres, gap) < tol
    obj = float(c_in @ x_out)
    status = "OPTIMAL" if done else "ITERATION_LIMIT"
    return PDHGResult(x=x_out, y=y_out, obj_val=obj, iter_count=int(iters),
                      status=status,
                      runtime=datetime.timedelta(
                          seconds=time.perf_counter() - t0),
                      primal_residual=pres, dual_residual=dres,
                      gap=gap)


def pdhg_general_lp(lp, tol: float = 1e-6, max_iters: int = 100_000,
                    x0=None, y0=None, sparse: bool | None = None,
                    mode: str = "adaptive", *, device=None) -> PDHGResult:
    """PDHG on a GeneralLP.  ``sparse=True`` keeps A sparse (the JAX
    package's BCOO route: a CSR operator on the card); the default picks
    sparse for big, sparse instances (m n > 1e6 and nnz < 0.1 m n), else
    A runs dense (K3 or K4 on the card).  ``device`` as for
    ``pdhg_solve``."""
    A_sp = ssp.csr_matrix(lp.A)
    if sparse is None:
        sparse = (A_sp.shape[0] * A_sp.shape[1] > 1_000_000
                  and A_sp.nnz < 0.1 * A_sp.shape[0] * A_sp.shape[1])
    A = A_sp if sparse else np.asarray(A_sp.todense())
    return pdhg_solve(A, lp.b, lp.c, lp.l, lp.u, sense=lp.sense, tol=tol,
                      max_iters=max_iters, x0=x0, y0=y0, mode=mode,
                      device=device)
