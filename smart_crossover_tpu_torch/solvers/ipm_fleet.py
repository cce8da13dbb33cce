"""Fleet barrier solve: device batched IPM + host f64 refinement.

Port of ``smart_crossover_tpu/solvers/ipm_fleet.py``.  The device stage
(``solvers/ipm_batched.py``) runs the whole Mehrotra predictor-corrector
for a BATCH of dense LPs on the card: the normal-equations products
``A D A'`` are one batched matmul and the factorisations one batched
Cholesky.  In float32 the device iterates stall around mu ~ 1e-5 (the
normal equations square the condition number), so each instance is
finished on the host: a few warm-started f64 Mehrotra steps, vectorised
over the fleet (``ipm_endgame_batched``, a copy of the JAX package's host
code), with ``solvers/ipm.py`` for the rare straggler.

For one large LP (``ipm_big``) the endgame can keep its normal equations on
the device (``solvers/ne_device.py``): the policy ``SCX_DEVICE_ENDGAME``
(``0`` off, ``1`` on, ``auto`` when the device stage ran on a CUDA card and
m*n >= 4,000,000) is the JAX package's, with its TPU test read as CUDA.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from smart_crossover_tpu_torch.config import device_float, resolve_device
from smart_crossover_tpu_torch.solvers.ipm import (
    IPMResult,
    _tp_limits,
    ipm_solve,
)
from smart_crossover_tpu_torch.solvers.ipm_batched import ipm_dense_batched
from smart_crossover_tpu_torch.solvers.pdhg import _host

#: telemetry from the most recent single-big-LP device endgame
#: (solvers/ne_device.py stats dict), None when the exact path ran
last_ne_stats: dict | None = None
#: instances of the most recent ``ipm_fleet`` call that the batched
#: endgame left unconverged and the host ``ipm_solve`` finished
last_stragglers: int = 0
#: iterations of the most recent endgame that formed A D A' on the host
last_host_forms: int = 0


def _thread_map(work, B, threads=None):
    """Run ``work(i0, i1)`` over batch chunks on a thread pool, one BLAS
    thread per worker: numpy's 3-D matmul/inv walk the batch in a single
    C loop, so neither the loop nor (on a shared host) the per-slice BLAS
    threading parallelises — chunked threads do."""
    if threads is None:
        threads = min(max(os.cpu_count() or 1, 1), 8)
    chunks = min(threads, B)
    if chunks <= 1:
        work(0, B)
        return
    bounds = np.linspace(0, B, chunks + 1).astype(int)
    with cf.ThreadPoolExecutor(max_workers=chunks) as pool:
        list(pool.map(lambda i: work(bounds[i], bounds[i + 1]),
                      range(chunks)))


def _bmm(X, Y):
    """Threaded batched matmul X @ Y over the leading axis.

    Small batches (the single-big-LP path, B=1) skip the per-chunk
    1-thread BLAS limit — there the parallelism must come from BLAS
    itself, not the chunk pool."""
    B = X.shape[0]
    out = np.empty((B, X.shape[1], Y.shape[2]), dtype=np.float64)
    if B <= 2:
        np.matmul(X, Y, out=out)
        return out

    def work(i0, i1):
        with _tp_limits(limits=1, user_api="blas"):
            np.matmul(X[i0:i1], Y[i0:i1], out=out[i0:i1])

    _thread_map(work, B)
    return out


def _binv(M):
    """Threaded batched inverse over the leading axis (see _bmm re B<=2)."""
    B = M.shape[0]
    if B <= 2:
        return np.linalg.inv(M)
    out = np.empty_like(M)

    def work(i0, i1):
        with _tp_limits(limits=1, user_api="blas"):
            out[i0:i1] = np.linalg.inv(M[i0:i1])

    _thread_map(work, B)
    return out


def ipm_endgame_batched(A, b, c, l, u, x0, y0, zl0, zu0,
                        tol: float = 1e-8, max_iters: int = 30,
                        ne_device=None):
    """Batched f64 Mehrotra endgame on the HOST, vectorised over the fleet.

    The device stage hands over a centered interior point per instance at
    f32 accuracy (mu ~ 1e-4..1e-6); this drives every instance to the f64
    KKT tolerance with BATCHED dense linear algebra — one (B, m, n) GEMM
    for the normal equations and one stacked factor-solve per step — so
    the endgame rides multithreaded BLAS3 instead of a per-instance
    Python loop.  Same math as solvers/ipm_batched.py::ipm_dense (which
    mirrors solvers/ipm.py); a one-sided column's infinite bound gets the
    same wide box, and a free column, unboxed, gets the scaling cap
    d = 1e10 (the host IPM's ``d_free``), where the JAX package boxes it
    too (ROADMAP 3.12).

    Returns (x, y, zl, zu, converged, iters_used).
    """
    A = np.asarray(A, dtype=np.float64)
    B, m, n = A.shape
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    # the JAX package's wide box on a one-sided column's infinite bound; a
    # free column stays unboxed, its slacks and duals drop out (x = lv + p
    # with lv = 0, q = -x) and its scaling sits at the cap.  Without free
    # columns each where() below takes its first branch
    free = ~np.isfinite(l) & ~np.isfinite(u)
    bnd = ~free
    scale = 1.0 + np.maximum(np.abs(b).max(axis=1), 1.0)   # (B,)
    wide = (1e6 * scale)[:, None]
    l = np.where(np.isfinite(l) | free, l, -wide)
    u = np.where(np.isfinite(u) | free, u, wide)
    lv, uv = np.where(bnd, l, 0.0), np.where(bnd, u, 0.0)
    n_bounds = 2 * bnd.sum(axis=1)                          # (B,)
    has_free = free.any(axis=1)                             # (B,)
    l_full = lv.copy()  # pre-compaction copy; recovers x = lv + p at exit

    def per(v, s):
        """v / s on the boxed columns, else 0."""
        return np.where(bnd, v / np.where(bnd, s, 1.0), 0.0)

    floor = 1e-12
    # clamp the handoff INTO the box first: an f32 device iterate can sit
    # ~1e-7 outside a bound, and flooring p and q independently would then
    # bake in p + q > u - l — a bound violation no later step removes
    # (the ratio test keeps both slacks positive, not their sum fixed)
    x0c = np.clip(np.asarray(x0, np.float64), np.where(bnd, l + floor, -np.inf),
                  np.where(bnd, u - floor, np.inf))
    p = np.where(bnd, np.maximum(x0c - lv, floor), x0c)
    q = np.where(bnd, np.maximum(uv - x0c, floor), -x0c)
    zl = np.where(bnd, np.maximum(np.asarray(zl0, np.float64), floor), 0.0)
    zu = np.where(bnd, np.maximum(np.asarray(zu0, np.float64), floor), 0.0)
    y = np.asarray(y0, np.float64).copy()

    bnorm = 1.0 + np.linalg.norm(b, axis=1)                # (B,)
    cnorm = 1.0 + np.linalg.norm(c, axis=1)
    AT = A.transpose(0, 2, 1)
    eye = np.eye(m)[None]

    def residuals():
        x = lv + p
        pres = np.linalg.norm(b - (A @ x[..., None])[..., 0],
                              axis=1) / bnorm
        dres = np.linalg.norm(c - (AT @ y[..., None])[..., 0]
                              - zl + zu, axis=1) / cnorm
        pobj = np.einsum("bn,bn->b", c, x)
        dobj = (np.einsum("bm,bm->b", b, y)
                + np.einsum("bn,bn->b", lv, zl)
                - np.einsum("bn,bn->b", uv, zu))
        relgap = np.abs(pobj - dobj) / (1 + np.abs(pobj) + np.abs(dobj))
        return pres, dres, relgap

    def max_step(v, dv):
        neg = dv < 0
        r = np.where(neg, -v / np.where(neg, dv, -1.0), np.inf)
        return np.minimum(1.0, r.min(axis=1))              # (B,)

    def pq_step(dx):
        """The primal ratio test over the boxed columns."""
        return np.minimum(max_step(p, np.where(bnd, dx, 0.0)),
                          max_step(q, np.where(bnd, -dx, 0.0)))

    conv = np.zeros(B, dtype=bool)
    iters_used = np.zeros(B, dtype=np.int64)
    # once the f32 preconditioner fails a solve, it stays dead: the KKT
    # residual (hence the conditioning) only worsens for it from there,
    # and each doomed retry costs a device factor + a stalled CG before
    # the exact path runs anyway
    ne_dead = False
    host_forms = 0      # iterations that formed A D A' on the host
    # final-state stores; active-set compaction below slices the working
    # arrays down as instances converge, so finished state is scattered
    # back here by global index
    P, Q, ZL, ZU, Y = p.copy(), q.copy(), zl.copy(), zu.copy(), y.copy()
    idx = np.arange(B)
    for _ in range(max_iters):
        pres, dres, relgap = residuals()
        done_sub = (pres < tol) & (dres < tol) & (relgap < tol)
        for arr_g, arr in ((P, p), (Q, q), (ZL, zl), (ZU, zu), (Y, y)):
            arr_g[idx] = arr
        conv[idx] = done_sub
        act = ~done_sub
        if not act.any():
            break
        iters_used[idx[act]] += 1
        if not act.all():
            # compact: drop converged instances from every working array
            idx = idx[act]
            p, q, zl, zu, y = p[act], q[act], zl[act], zu[act], y[act]
            A, AT, b, c, lv, uv = (A[act], AT[act], b[act], c[act],
                                   lv[act], uv[act])
            bnd = bnd[act]
            n_bounds, has_free = n_bounds[act], has_free[act]
            bnorm, cnorm = bnorm[act], cnorm[act]

        x = lv + p
        r_p = b - (A @ x[..., None])[..., 0]
        r_d = c - (AT @ y[..., None])[..., 0] - zl + zu
        gap = np.einsum("bn,bn->b", p, zl) + np.einsum("bn,bn->b", q, zu)
        mu = gap / n_bounds

        # clip the scaling like the host path (ipm.py d_cap): a handful of
        # degenerate columns must not make the whole batch singular
        d = 1.0 / np.maximum(per(zl, p) + per(zu, q), 1e-10)
        d = np.minimum(d, 1e10)
        # ne_state carries the (lazily formed) exact host factorisation —
        # when the device-f32 path below handles every solve of this
        # iteration, the 2 m^2 n GEMM + O(m^3) inverse are never paid
        ne_state: dict = {}

        def ensure_exact():
            nonlocal host_forms
            if "inv" in ne_state or "cho" in ne_state:
                return
            host_forms += 1
            ADA = _bmm(A * d[:, None, :], AT)
            # PER-INSTANCE regularisation, RELATIVE to the diagonal
            # scale: with d capped at 1e10 the diagonal reaches ~1e12+,
            # and any reg proportional to trace/diag-sum is O(1e2..1e3)
            # — large enough that iterative refinement contracts only by
            # reg/lambda_min per pass and ~14% of the fleet stalls at 30
            # iterations (the round-3 Amdahl hole: every straggler pays
            # a full host IPM re-solve).  A 1e-14-relative shift is
            # below the factorisation's own backward error and keeps
            # refinement contracting.  With free columns (at the cap
            # from the first iteration) a shift relative to the largest
            # diagonal swamps the rows of small diagonal and the primal
            # residual stops contracting near 1e-8: those instances shift
            # each row relative to its own diagonal (the host IPM's
            # relative shifts, ROADMAP 3.12).  reg is (B, m), one shift
            # per row.
            if "reg" in ne_state:   # fixed by the device path already
                reg = ne_state["reg"]
            else:
                diag_max = np.einsum("bii->b", np.abs(ADA)) / m \
                    + np.abs(ADA).max(axis=(1, 2))
                reg = np.where(has_free[:, None],
                               1e-14 * (1.0 + np.einsum("bii->bi", ADA)),
                               1e-14 * (1.0 + diag_max)[:, None])
            ADA = ADA + reg[:, :, None] * eye
            # ONE batched inverse per iteration, shared by the
            # predictor, corrector, and Gondzio solves (np.linalg.solve
            # would refactor for each, and per-instance scipy cho_factor
            # loops drown in OpenBLAS per-call sync).  The inverse-apply
            # loses ~cond*eps digits, so every solve gets
            # iterative-refinement passes — with f64 eps that contracts
            # as long as cond(ADA) << 1e16.
            ne_state["ADA"] = ADA
            if ADA.shape[0] == 1:
                # single instance: a Cholesky factor costs m^3/3 flops
                # vs the inverse's ~2 m^3 and solves just as fast
                import scipy.linalg as sla
                try:
                    ne_state["cho"] = sla.cho_factor(ADA[0])
                except np.linalg.LinAlgError:
                    ne_state["inv"] = _binv(ADA)
            else:
                ne_state["inv"] = _binv(ADA)

        def exact_solve(rhs):
            ensure_exact()
            ADA = ne_state["ADA"]
            if "cho" in ne_state:
                import scipy.linalg as sla
                dy_ = sla.cho_solve(ne_state["cho"], rhs[0])[None]
                for _ in range(2):
                    r_ = rhs - (ADA @ dy_[..., None])[..., 0]
                    dy_ = dy_ + sla.cho_solve(ne_state["cho"], r_[0])[None]
                return dy_
            ADAinv = ne_state["inv"]
            dy_ = (ADAinv @ rhs[..., None])[..., 0]
            for _ in range(2):
                r_ = rhs - (ADA @ dy_[..., None])[..., 0]
                dy_ = dy_ + (ADAinv @ r_[..., None])[..., 0]
            return dy_

        use_dev = ne_device is not None and p.shape[0] == 1 and not ne_dead
        if use_dev:
            try:
                diag_ne = ne_device.factor(d[0])
            except FloatingPointError:
                use_dev = False
                ne_dead = True
        if use_dev:
            # for SPD M the largest element sits on the diagonal, so the
            # diag-based reg equals the exact path's trace/max formula
            if has_free[0]:
                reg1 = 1e-14 * (1.0 + diag_ne)
            else:
                reg1 = 1e-14 * (1.0 + diag_ne.mean() + diag_ne.max())
            ne_state["reg"] = np.broadcast_to(reg1, (1, m))
            A0, AT0, d0 = A[0], AT[0], d[0]
            # inexact-Newton forcing term: a Newton direction only needs
            # accuracy proportional to the residual it is about to
            # remove — mid-endgame solves at res ~1e-4 are fine at 1e-6
            # relative, which saves CG iterations AND rescues solves the
            # f32 preconditioner can't push to 1e-11 (each such rescue
            # avoids a full exact host GEMM+factor fallback).  The true
            # KKT residuals are recomputed every iteration, so inexact
            # directions can never produce a false OPTIMAL.
            res_now = float(max(pres[0], dres[0], relgap[0]))
            eta = min(1e-7, max(1e-11, 1e-2 * res_now))

            def ne_matvec(v):
                return A0 @ (d0 * (AT0 @ v)) + reg1 * v

            def batch_solve(rhs, corrector=False):
                nonlocal ne_dead
                if ("cho" not in ne_state and "inv" not in ne_state
                        and not ne_dead):
                    dy_, ok = ne_device.solve(rhs[0], ne_matvec,
                                              rel_tol=eta, reg=reg1)
                    if ok:
                        return dy_[None]
                    if (corrector and ne_device.f64
                            and np.isfinite(ne_device.stats["fails"][-1][
                                "best_res"])):
                        # a centrality corrector whose f64 device solve
                        # missed its tolerance keeps its direction: it is
                        # taken only where both step lengths grow, and
                        # the exact path would form A D A' on the host for
                        # it (16-18 s at 10,000 x 36,975 on the card
                        # machine, once in every iteration there; the JAX
                        # module falls back, ROADMAP 3.13)
                        return dy_[None]
                    if not ne_device.f64:
                        # f32-preconditioner stalls are monotone in mu:
                        # exact path from here on, all iters.  f64 direct
                        # failures are per-factor (breakdown at this d),
                        # so the next iteration may retry.
                        ne_dead = True
                return exact_solve(rhs)
        else:
            def batch_solve(rhs, corrector=False):
                return exact_solve(rhs)

        def newton(rp, rd, rcl, rcu):
            rhs_x = rd - per(rcl, p) + per(rcu, q)
            rhs_y = rp + (A @ (d * rhs_x)[..., None])[..., 0]
            return rhs_x, rhs_y

        rcl_a = -p * zl
        rcu_a = -q * zu
        rhs_x_a, rhs_y_a = newton(r_p, r_d, rcl_a, rcu_a)
        dy_a = batch_solve(rhs_y_a)
        dx_a = d * ((AT @ dy_a[..., None])[..., 0] - rhs_x_a)
        dzl_a = per(rcl_a - zl * dx_a, p)
        dzu_a = per(rcu_a + zu * dx_a, q)

        ap = pq_step(dx_a)
        ad = np.minimum(max_step(zl, dzl_a), max_step(zu, dzu_a))
        gap_aff = (np.einsum("bn,bn->b", p + ap[:, None] * dx_a,
                             zl + ad[:, None] * dzl_a)
                   + np.einsum("bn,bn->b", q - ap[:, None] * dx_a,
                               zu + ad[:, None] * dzu_a))
        sigma = np.clip((gap_aff / np.maximum(gap, 1e-300)) ** 3, 0.0, 1.0)

        rcl = sigma[:, None] * mu[:, None] - p * zl - dx_a * dzl_a
        rcu = sigma[:, None] * mu[:, None] - q * zu + dx_a * dzu_a
        rhs_x_c, rhs_y_c = newton(r_p, r_d, rcl, rcu)
        dy = batch_solve(rhs_y_c)
        dx = d * ((AT @ dy[..., None])[..., 0] - rhs_x_c)
        dzl = per(rcl - zl * dx, p)
        dzu = per(rcu + zu * dx, q)

        ap = 0.9995 * pq_step(dx)
        ad = 0.9995 * np.minimum(max_step(zl, dzl), max_step(zu, dzu))

        # Gondzio multiple centrality correctors (batched): extra
        # back-solves that push outlying complementarity products toward
        # the central path, accepted per instance only when BOTH step
        # lengths grow — blocked steps are what strands r_p while mu
        # collapses (mirrors ipm.py's scalar loop)
        for _ in range(2):
            need = (ap < 0.95) | (ad < 0.95)
            if not need.any():
                break
            tp = np.minimum(ap + 0.3, 1.0)[:, None]
            td = np.minimum(ad + 0.3, 1.0)[:, None]
            p_t = p + tp * dx
            q_t = q - tp * dx
            zl_t = zl + td * dzl
            zu_t = zu + td * dzu
            mu_t = ((np.einsum("bn,bn->b", p_t, zl_t)
                     + np.einsum("bn,bn->b", q_t, zu_t)) / n_bounds)[:, None]
            vl = p_t * zl_t
            vu = q_t * zu_t
            ccl = np.where(bnd, np.clip(vl, 0.1 * mu_t, 10.0 * mu_t) - vl, 0.0)
            ccu = np.where(bnd, np.clip(vu, 0.1 * mu_t, 10.0 * mu_t) - vu, 0.0)
            rhs_x_cc = -per(ccl, p) + per(ccu, q)
            rhs_y_cc = (A @ (d * rhs_x_cc)[..., None])[..., 0]
            cdy = batch_solve(rhs_y_cc, corrector=True)
            cdx = d * ((AT @ cdy[..., None])[..., 0] - rhs_x_cc)
            cdzl = per(ccl - zl * cdx, p)
            cdzu = per(ccu + zu * cdx, q)
            dx2 = dx + cdx
            dy2 = dy + cdy
            dzl2 = dzl + cdzl
            dzu2 = dzu + cdzu
            ap2 = 0.9995 * pq_step(dx2)
            ad2 = 0.9995 * np.minimum(max_step(zl, dzl2),
                                      max_step(zu, dzu2))
            ok = (need & (ap2 >= ap) & (ad2 >= ad))[:, None]
            dx = np.where(ok, dx2, dx)
            dy = np.where(ok, dy2, dy)
            dzl = np.where(ok, dzl2, dzl)
            dzu = np.where(ok, dzu2, dzu)
            ap = np.where(ok[:, 0], ap2, ap)
            ad = np.where(ok[:, 0], ad2, ad)

        ap = ap[:, None]
        ad = ad[:, None]
        p = np.where(bnd, np.maximum(p + ap * dx, 1e-300), p + ap * dx)
        q = np.where(bnd, np.maximum(q - ap * dx, 1e-300), q - ap * dx)
        y = y + ad * dy
        zl = np.where(bnd, np.maximum(zl + ad * dzl, 1e-300), 0.0)
        zu = np.where(bnd, np.maximum(zu + ad * dzu, 1e-300), 0.0)
    else:
        pres, dres, relgap = residuals()
        for arr_g, arr in ((P, p), (Q, q), (ZL, zl), (ZU, zu), (Y, y)):
            arr_g[idx] = arr
        conv[idx] = (pres < tol) & (dres < tol) & (relgap < tol)

    global last_host_forms
    last_host_forms = host_forms
    return l_full + P, Y, ZL, ZU, conv, iters_used


def _device_stage_on_mesh(mesh, A, b, c, l, u, **kw):
    """``ipm_dense_batched`` sharded over a mesh (``parallel/mesh.py``) as
    the JAX package shards it, every output all-gathered.  With fewer
    instances than the 'model' width (> 1, dividing n) the columns are
    split: each rank holds A's (m, n/p) slab, the (m, m) normal equations
    are all-reduced and replicated, and so is the loop state.  Otherwise
    the batch is split over the 'batch' axis, each rank running its slice
    with no collective until the gather."""
    B, m, n = A.shape
    model = dict(mesh.shape).get("model", 1)
    if B < model and model > 1 and n % model == 0:
        lo, hi = mesh.slice("model", n)
        out = ipm_dense_batched(
            A[:, :, lo:hi], b, c[:, lo:hi], l[:, lo:hi], u[:, lo:hi],
            device=mesh.device,
            col_reduce=lambda t, op: mesh.all_reduce(t, op, "model"), **kw)
        for k in ("x", "zl", "zu"):
            out[k] = mesh.gather(out[k], "model", dim=1)
        return out
    lo, hi = mesh.slice("batch", B)
    out = ipm_dense_batched(*(a[lo:hi] for a in (A, b, c, l, u)),
                            device=mesh.device, **kw)
    return {k: mesh.gather(v, "batch") for k, v in out.items()}


def ipm_big(A, b, c, l, u, tol: float = 1e-8,
            device_tol: float = 1e-5, max_device_iters: int = 60,
            max_refine_iters: int = 30, mesh=None, *, device=None):
    """Barrier-solve ONE large dense LP with the fleet machinery at B=1.

    The m^2 n normal-equations GEMM dominates a dense barrier solve at
    m >= 5000: a host f64 IPM pays it every iteration, here the device
    stage carries the bulk iterations and the host (or, through
    ``SCX_DEVICE_ENDGAME``, the device normal equations) only the endgame.
    ``mesh`` and ``device`` as in ``ipm_fleet``: with a 'model' axis wider
    than 1 that divides n, the device stage splits A's columns over it.

    Returns an IPMResult with ``device_s``, ``endgame_s``, ``device_iters``
    and ``endgame_iters`` attached.
    """
    t0 = time.perf_counter()
    res = ipm_fleet(A[None], b[None], c[None], l[None], u[None], tol=tol,
                    device_tol=device_tol,
                    max_device_iters=max_device_iters,
                    max_refine_iters=max_refine_iters, mesh=mesh,
                    device=device)
    import datetime

    x, y = res.x[0], res.y[0]
    out = IPMResult(
        x=x, y=y, zl=np.zeros_like(x), zu=np.zeros_like(x),
        obj_val=float(res.obj[0]),
        iter_count=int(res.device_iters[0] + res.refine_iters[0]),
        status=res.status[0],
        runtime=datetime.timedelta(seconds=time.perf_counter() - t0))
    # stage split for benchmarking
    out.device_s = res.device_s
    out.endgame_s = res.endgame_s
    out.device_iters = int(res.device_iters[0])
    out.endgame_iters = int(res.refine_iters[0])
    return out


@dataclass
class FleetResult:
    x: np.ndarray            # (B, n) refined primal iterates
    y: np.ndarray            # (B, m) refined duals
    obj: np.ndarray          # (B,)
    status: list[str]        # per-instance host IPM status
    device_iters: np.ndarray     # (B,) device Mehrotra iterations
    refine_iters: np.ndarray     # (B,) host f64 endgame iterations
    device_converged: np.ndarray  # (B,) bool, device-side tol reached
    device_s: float = 0.0        # wall seconds in the device bulk stage
    endgame_s: float = 0.0       # wall seconds in the host f64 endgame


def ipm_fleet(A, b, c, l, u, tol: float = 1e-8,
              device_tol: float = 1e-5, max_device_iters: int = 60,
              max_refine_iters: int = 30, threads: int | None = None,
              refine: bool = True, mesh=None, *, device=None) -> FleetResult:
    """Barrier-solve a fleet of dense equality-form LPs to f64 accuracy.

    Args:
        A: (B, m, n) dense; b: (B, m); c, l, u: (B, n); numpy arrays or
            tensors.
        tol: final (host, f64) KKT tolerance.
        device_tol: target for the device stage; in float32 anything below
            ~1e-5 just burns iterations.
        refine: set False to skip the host stage (device iterates only).
        mesh: an optional ``parallel.make_mesh`` mesh; every rank calls
            with the same full fleet.  The device stage is then sharded
            over it (``_device_stage_on_mesh``: the batch over 'batch', B
            divisible by its width, or, for B below the 'model' width, A's
            columns over 'model') and gathered; every rank runs the host
            endgame on the whole fleet and returns the same result.
        device: where the device stage runs (default: the mesh's device,
            else A's device if A is a tensor, else the CUDA card; without
            one that default raises): float32 on a card, float64 on the
            CPU.

    Returns:
        FleetResult; ``status[i] == 'OPTIMAL'`` means instance i passed
        the full f64 KKT test at ``tol``.
    """
    dev = mesh.device if mesh is not None and device is None \
        else resolve_device(device, A)
    A, b, c, l, u = (np.asarray(_host(v), dtype=np.float64)
                     for v in (A, b, c, l, u))
    B, m, n = A.shape

    t_dev0 = time.perf_counter()
    f64 = device_float(dev) == torch.float64
    # f32 hand-off sweet spot (the JAX package's measurement): land at
    # mu ~ 1e-4 centred; driving f32 deeper leaves ~1e-4 primal residuals
    # the f64 endgame then pays 20+ iterations to unwind
    mu_exit = 0.0 if f64 else 1e-4
    kw = dict(tol=device_tol, max_iters=max_device_iters, mu_exit=mu_exit)
    if mesh is not None:
        dev_out = _device_stage_on_mesh(mesh, A, b, c, l, u, **kw)
    else:
        dev_out = ipm_dense_batched(A, b, c, l, u, device=dev, **kw)
    x_dev, y_dev, zl_dev, zu_dev = (
        dev_out[k].double().cpu().numpy() for k in ("x", "y", "zl", "zu"))
    dev_iters = dev_out["iters"].cpu().numpy().astype(np.int64)
    dev_conv = dev_out["converged"].cpu().numpy().astype(bool)
    device_s = time.perf_counter() - t_dev0

    x_out = x_dev.copy()
    y_out = y_dev.copy()
    obj = np.einsum("bn,bn->b", c, x_out)
    status = ["DEVICE_ONLY"] * B
    refine_iters = np.zeros(B, dtype=np.int64)
    if not refine:
        return FleetResult(x_out, y_out, obj, status, dev_iters,
                           refine_iters, dev_conv, device_s, 0.0)

    # batched f64 endgame: one BLAS3 sweep drives the whole fleet to tol
    t_end0 = time.perf_counter()
    # single-big-LP endgame assist: the normal equations on the device
    # (solvers/ne_device.py; exact host fallback inside on a failed solve)
    ne_dev = None
    policy = os.environ.get("SCX_DEVICE_ENDGAME", "auto")
    if B == 1 and policy != "0" and (
            policy == "1" or (dev.type == "cuda" and m * n >= 4_000_000)):
        from smart_crossover_tpu_torch.solvers import ne_device

        ne_dev = ne_device.DeviceNE(A[0], device=dev)
    x_r, y_r, zl_r, zu_r, conv, refine_iters = ipm_endgame_batched(
        A, b, c, l, u, x_dev, y_dev, zl_dev, zu_dev, tol=tol,
        max_iters=max_refine_iters, ne_device=ne_dev)
    global last_ne_stats, last_stragglers    # bench/test telemetry
    last_ne_stats = dict(ne_dev.stats) if ne_dev is not None else None
    x_out = x_r
    y_out = y_r
    obj = np.einsum("bn,bn->b", c, x_out)
    status = ["OPTIMAL" if ok else "ENDGAME_STALLED" for ok in conv]

    # stragglers (rare: ill-conditioned instances the batched endgame
    # couldn't finish) go through the full regularised host IPM
    stragglers = np.flatnonzero(~conv)
    last_stragglers = int(stragglers.size)

    def one(i: int) -> None:
        res: IPMResult = ipm_solve(A[i], b[i], c[i], l[i], u[i], tol=tol,
                                   max_iter=200,
                                   x0=x_dev[i], y0=y_dev[i],
                                   zl0=zl_dev[i], zu0=zu_dev[i])
        x_out[i] = res.x
        y_out[i] = res.y
        obj[i] = res.obj_val
        status[i] = res.status
        refine_iters[i] += res.iter_count

    if stragglers.size:
        if threads is None:
            threads = min(max(os.cpu_count() or 1, 1), 8)
        if threads > 1 and stragglers.size > 1:
            with cf.ThreadPoolExecutor(max_workers=threads) as pool:
                list(pool.map(one, stragglers))
        else:
            for i in stragglers:
                one(i)
    return FleetResult(x_out, y_out, obj, status, dev_iters,
                       refine_iters, dev_conv, device_s,
                       time.perf_counter() - t_end0)
