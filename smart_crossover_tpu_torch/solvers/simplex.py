"""Bounded-variable revised primal simplex (host, float64).

Host copy of ``smart_crossover_tpu/solvers/simplex.py`` (numpy / scipy,
no device code), kept line for line so that ``tests/test_torch_simplex.py``
can hold it to the original bit for bit.

In-house replacement for the vendor simplex finishers the reference calls
(``method='primal_simplex'/'simplex'`` through solver_caller, e.g. the final
warm-started solve of the perturbation crossover, reference
lp_methods/algorithms.py:69-74).  Capabilities:

* general bounds (finite / infinite / free / fixed) on every column;
* warm start from an arbitrary variable-status vector; the basis is repaired
  into a nonsingular one via structural matching + numeric fallback, with
  internal fixed-at-zero artificial columns always available;
* composite phase-1 (minimise total bound violation) entered automatically
  when the warm basis is primal infeasible — this doubles as the framework's
  *crossover from an interior point* for general LP: classify variables at
  bounds, propose the support as basic, let repair + phase-1/2 pivot to an
  optimal vertex;
* Devex or Dantzig pricing with a Bland's-rule fallback on long degenerate
  runs; sparse LU with product-form (eta) updates, refactorised on overflow
  or tiny pivots, with periodic hygiene resolves bounding float drift.
"""
from __future__ import annotations

import datetime
import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
from scipy.sparse.csgraph import maximum_bipartite_matching

# the pivot loop is all BLAS1 (eta-sweep ddot/axpy): threaded OpenBLAS
# pays pool sync per call — ~0.2 s/pivot at optLP scale (utils/threads.py)
from smart_crossover_tpu_torch.utils.threads import single_thread_blas as \
    _single_thread_blas

ST_BASIC = 0
ST_LOWER = -1
ST_UPPER = -2
ST_FREE = -3  # superbasic / nonbasic free at current value (we pin to 0)


class _BasisFactor:
    """Basis factorisation with product-form (eta) updates.

    A sparse LU of B is computed at refactorisation points; between them,
    pivots append eta vectors (B_k = B_0 E_1 ... E_k), so each pivot costs an
    O(m * #etas) eta sweep instead of a fresh factorisation.  Refactors on
    eta-file overflow or a tiny pivot element (stability guard).
    """

    def __init__(self, Aext, basic, max_etas: int = 64):
        self.Aext = Aext
        self.max_etas = max_etas
        self.refactor(basic)

    def refactor(self, basic) -> None:
        self.lu = spla.splu(self.Aext[:, basic].tocsc(), permc_spec="COLAMD")
        self.etas: list[tuple[int, np.ndarray, float]] = []

    def update(self, basic, pos: int, v: np.ndarray) -> None:
        """Register the exchange: column `pos` of B replaced by a_e, with
        v = B_prev^{-1} a_e already computed by the caller."""
        vr = v[pos]
        if (len(self.etas) >= self.max_etas
                or abs(vr) < 1e-8 * (1.0 + np.abs(v).max())):
            self.refactor(basic)
            return
        self.etas.append((pos, v.copy(), float(vr)))

    def solve(self, rhs, trans: str = "N") -> np.ndarray:
        if trans == "N":
            z = self.lu.solve(rhs)
            for r, v, vr in self.etas:
                zr = z[r] / vr
                z = z - v * zr
                z[r] = zr
            return z
        w = np.asarray(rhs, dtype=np.float64).copy()
        for r, v, vr in reversed(self.etas):
            w[r] = (w[r] - v @ w + vr * w[r]) / vr
        return self.lu.solve(w, trans="T")


def _dense_col(Acsc, j, m):
    """Column j of a csc matrix as a dense vector, no sparse-object churn
    (a scipy `A[:, j].todense()` builds a full sparse matrix per call —
    ~30% of the pivot loop's Python time at 30k pivots, profiled)."""
    out = np.zeros(m)
    s, e = Acsc.indptr[j], Acsc.indptr[j + 1]
    out[Acsc.indices[s:e]] = Acsc.data[s:e]
    return out


def _sanitize_vstatus(st: np.ndarray, l: np.ndarray, u: np.ndarray
                      ) -> np.ndarray:
    """Coerce an arbitrary status vector into valid {0,-1,-2,-3} codes
    consistent with the bounds (garbage codes become at-a-finite-bound)."""
    st = st.copy()
    invalid = ~np.isin(st, (ST_BASIC, ST_LOWER, ST_UPPER, ST_FREE))
    st[invalid] = ST_LOWER
    bad_up = (st == ST_UPPER) & ~np.isfinite(u)
    st[bad_up] = np.where(np.isfinite(l[bad_up]), ST_LOWER, ST_FREE)
    bad_lo = (st == ST_LOWER) & ~np.isfinite(l)
    st[bad_lo] = np.where(np.isfinite(u[bad_lo]), ST_UPPER, ST_FREE)
    bad_free = (st == ST_FREE) & (np.isfinite(l) | np.isfinite(u))
    st[bad_free] = np.where(np.isfinite(l[bad_free]), ST_LOWER, ST_UPPER)
    return st


@dataclass
class SimplexResult:
    x: np.ndarray
    y: np.ndarray
    obj_val: float
    vstatus: np.ndarray          # statuses over the input columns
    rcost: np.ndarray
    iter_count: int
    status: str
    runtime: datetime.timedelta
    row_basic: np.ndarray        # True where an artificial (row logical) is basic
    fallback: bool = False       # dual_simplex only: primal finisher was used


@_single_thread_blas
def primal_simplex(A, b, c, l, u,
                   vstatus: np.ndarray | None = None,
                   max_iter: int = 200_000,
                   tol: float = 1e-9,
                   feas_tol: float = 1e-9,
                   time_limit: float | None = None,
                   pricing: str = "dantzig") -> SimplexResult:
    """Solve  min c'x  s.t.  A x = b, l <= x <= u  from a warm status vector.

    ``pricing='devex'`` enables Devex reference weights (the practical
    steepest-edge approximation behind the reference's simplexPricing='SE'
    option) — usually fewer pivots at one extra BTRAN per pivot.
    """
    t0 = time.perf_counter()
    A = sp.csc_matrix(A).astype(np.float64)
    m, n = A.shape
    b = np.asarray(b, dtype=np.float64)
    c0 = np.asarray(c, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)

    # extended problem: artificial columns (identity), fixed at 0
    Aext = sp.hstack([A, sp.eye(m, format="csc")]).tocsc()
    AextT = Aext.T.tocsr()
    next_l = np.concatenate([l, np.zeros(m)])
    next_u = np.concatenate([u, np.zeros(m)])
    cext = np.concatenate([c0, np.zeros(m)])
    N = n + m

    if vstatus is None:
        st = np.full(N, ST_LOWER, dtype=np.int8)
        st[~np.isfinite(next_l) & np.isfinite(next_u)] = ST_UPPER
        st[~np.isfinite(next_l) & ~np.isfinite(next_u)] = ST_FREE
        st[n:] = ST_BASIC  # all-artificial start
    else:
        st = np.full(N, ST_LOWER, dtype=np.int8)
        st[:n] = _sanitize_vstatus(np.asarray(vstatus, dtype=np.int8), l, u)

    basic = _repair_basis(Aext, np.where(st == ST_BASIC)[0], m, n)
    st[st == ST_BASIC] = ST_LOWER  # demoted candidates fall to a bound
    demoted = (st == ST_LOWER) & ~np.isfinite(next_l)
    st[demoted & np.isfinite(next_u)] = ST_UPPER
    st[demoted & ~np.isfinite(next_u)] = ST_FREE
    st[basic] = ST_BASIC

    # nonbasic values
    def nonbasic_values(st):
        xv = np.zeros(N)
        at_l = st == ST_LOWER
        at_u = st == ST_UPPER
        xv[at_l] = next_l[at_l]
        xv[at_u] = next_u[at_u]
        return xv  # ST_FREE pinned at 0

    x = nonbasic_values(st)

    lu = _BasisFactor(Aext, basic)
    x[basic] = 0.0
    x[basic] = lu.solve(b - Aext @ x)

    fixed_cols = np.isfinite(next_l) & np.isfinite(next_u) & (next_l == next_u)
    devex = pricing == "devex"
    dw = np.ones(N)  # Devex reference weights

    it = 0
    degen_run = 0
    phase = 1
    result_status = "OPTIMAL"

    while True:
        if it >= max_iter:
            result_status = "ITERATION_LIMIT"
            break
        if (time_limit is not None and it % 64 == 0
                and time.perf_counter() - t0 > time_limit):
            result_status = "TIME_LIMIT"
            break
        xb = x[basic]
        lb = next_l[basic]
        ub = next_u[basic]
        below = xb < lb - feas_tol
        above = xb > ub + feas_tol
        infeas = (np.where(below, lb - xb, 0.0)
                  + np.where(above, xb - ub, 0.0)).sum()

        if infeas > feas_tol:
            phase = 1
            cb = np.where(below, -1.0, np.where(above, 1.0, 0.0))
        else:
            phase = 2
            cb = cext[basic]

        y = lu.solve(cb, trans="T")
        rc = (cext if phase == 2 else np.zeros(N)) - AextT @ y
        rc[basic] = 0.0

        at_l = st == ST_LOWER
        at_u = st == ST_UPPER
        at_f = st == ST_FREE
        viol = np.where(at_l & (rc < -tol), -rc, 0.0)
        viol += np.where(at_u & (rc > tol), rc, 0.0)
        viol += np.where(at_f, np.abs(rc) * (np.abs(rc) > tol), 0.0)
        viol[fixed_cols] = 0.0  # l == u: a bound flip can never improve

        if degen_run > m + 200:
            cand = np.nonzero(viol > 0)[0]
            e = int(cand[0]) if cand.size else -1
        elif devex:
            score = np.where(viol > 0, viol * viol / dw, 0.0)
            e = int(np.argmax(score))
            if score[e] <= 0:
                e = -1
        else:
            e = int(np.argmax(viol))
            if viol[e] <= 0:
                e = -1
        if e < 0:
            if phase == 1:
                result_status = "INFEASIBLE"
            break
        it += 1

        # direction: entering variable moves up (+1) from lower/free with
        # rc < 0, down (-1) from upper/free with rc > 0
        if st[e] == ST_LOWER or (st[e] == ST_FREE and rc[e] < 0):
            d_e = 1.0
        else:
            d_e = -1.0

        # basic direction: B dxB = -A_e * d_e
        a_e = _dense_col(Aext, e, m)
        dxb = lu.solve(-a_e * d_e)

        # ratio test (phase-1 aware: infeasible basics block at the bound
        # they are approaching, feasible basics at their usual bounds)
        theta = np.inf
        leave_pos = -1
        leave_to = ST_LOWER
        # entering variable's own range
        e_range = next_u[e] - next_l[e]
        if np.isfinite(e_range):
            theta = e_range
            leave_to = ST_UPPER if d_e > 0 else ST_LOWER
        # vectorised blocking-bound selection (phase-1 aware):
        #   rising basics block at their lower bound if below it, else upper;
        #   falling basics block at their upper bound if above it, else lower;
        #   moving further out of bounds never blocks (handled by cost slope).
        cand = np.abs(dxb) > 1e-11
        rising = dxb > 0
        bound = np.full(xb.size, np.nan)
        to_arr = np.zeros(xb.size, dtype=np.int8)
        sel = rising & below
        bound[sel] = lb[sel]
        to_arr[sel] = ST_LOWER
        sel = rising & ~below & ~above & np.isfinite(ub)
        bound[sel] = ub[sel]
        to_arr[sel] = ST_UPPER
        sel = ~rising & above
        bound[sel] = ub[sel]
        to_arr[sel] = ST_UPPER
        sel = ~rising & ~above & ~below & np.isfinite(lb)
        bound[sel] = lb[sel]
        to_arr[sel] = ST_LOWER
        ok = cand & ~np.isnan(bound)
        ratios = np.full(xb.size, np.inf)
        ratios[ok] = np.maximum((bound[ok] - xb[ok]) / dxb[ok], 0.0)
        k = int(np.argmin(ratios)) if xb.size else -1
        if k >= 0 and degen_run > m + 200:
            # Bland mode: break leaving ties by smallest variable index too —
            # smallest-index entering alone does not guarantee termination
            tied = np.nonzero(ratios <= ratios[k])[0]
            k = int(tied[np.argmin(basic[tied])])
        if k >= 0 and ratios[k] < theta - 1e-12:
            theta = ratios[k]
            leave_pos = k
            leave_to = int(to_arr[k])
        if not np.isfinite(theta):
            result_status = "UNBOUNDED" if phase == 2 else "INFEASIBLE"
            break
        theta = max(theta, 0.0)
        degen_run = degen_run + 1 if theta <= 1e-12 else 0

        # apply step
        x[e] += d_e * theta
        x[basic] = xb + theta * dxb

        if leave_pos < 0:
            st[e] = leave_to  # bound flip
        else:
            leaving = basic[leave_pos]
            st[e] = ST_BASIC
            st[leaving] = leave_to
            x[leaving] = next_l[leaving] if leave_to == ST_LOWER else next_u[leaving]
            if not np.isfinite(x[leaving]):
                x[leaving] = 0.0
                st[leaving] = ST_FREE
            if devex:
                # Devex update: weights of nonbasics grow with their pivot-row
                # magnitude relative to the entering column's
                rho = lu.solve(
                    np.eye(1, m, leave_pos, dtype=np.float64).ravel(),
                    trans="T")
                alpha = AextT @ rho
                ae_piv = dxb[leave_pos]
                if abs(ae_piv) > 1e-12:
                    ratio2 = (alpha / ae_piv) ** 2
                    dw = np.maximum(dw, ratio2 * dw[e])
                    dw[e] = max(dw[e], 1.0)
                if np.max(dw) > 1e8:
                    dw[:] = 1.0  # periodic reset for stability
            basic[leave_pos] = e
            # product-form update: v = B^{-1} a_e = -dxb / d_e
            v_eta = -dxb / d_e
            try:
                lu.update(basic, leave_pos, v_eta)
            except RuntimeError:
                # singular after swap: undo, demote entering to bound
                basic[leave_pos] = leaving
                st[leaving] = ST_BASIC
                st[e] = ST_LOWER if np.isfinite(next_l[e]) else ST_FREE
                x[e] = next_l[e] if np.isfinite(next_l[e]) else 0.0
                lu.refactor(basic)
            # periodic hygiene resolve (the incremental x update is exact up
            # to float drift; a fresh solve every few pivots bounds it)
            if it % 8 == 0 or not lu.etas:
                nb = st != ST_BASIC
                x_nb = np.where(nb, x, 0.0)
                x[basic] = lu.solve(b - Aext @ x_nb)

    # final duals / reduced costs w.r.t. the REAL objective
    y = lu.solve(cext[basic], trans="T")
    rc_full = cext - AextT @ y
    obj = float(cext @ x)

    vstatus_out = st[:n].copy()
    row_basic = np.zeros(m, dtype=bool)
    art_basic = basic[basic >= n] - n
    row_basic[art_basic] = True

    runtime = datetime.timedelta(seconds=time.perf_counter() - t0)
    return SimplexResult(x=x[:n], y=y, obj_val=obj,
                         vstatus=vstatus_out, rcost=rc_full[:n],
                         iter_count=it, status=result_status,
                         runtime=runtime, row_basic=row_basic)


def _repair_basis(Aext: sp.csc_matrix, candidates: np.ndarray, m: int, n: int
                  ) -> np.ndarray:
    """Build a nonsingular m-column basis preferring ``candidates``.

    Structural maximum matching selects an independent-looking subset; rows
    left unmatched get their artificial column.  A numeric LU check guards
    against structurally-fine-but-numerically-singular picks, falling back to
    the all-artificial basis (phase 1 then repairs feasibility).
    """
    candidates = np.asarray(candidates, dtype=np.int64)
    if candidates.size:
        sub = Aext[:, candidates].tocsc()
        match = maximum_bipartite_matching(sub, perm_type="row")
        # match[j] = row matched to candidate column j (or -1)
        chosen = candidates[match >= 0]
        matched_rows = match[match >= 0]
    else:
        chosen = np.array([], dtype=np.int64)
        matched_rows = np.array([], dtype=np.int64)
    row_cover = np.zeros(m, dtype=bool)
    row_cover[matched_rows] = True
    fill = np.where(~row_cover)[0] + n
    basic = np.concatenate([chosen, fill]).astype(np.int64)
    assert basic.size == m
    try:
        lu = spla.splu(Aext[:, basic].tocsc(), permc_spec="COLAMD")
        # numeric sanity: solve against a random rhs and check residual
        rng = np.random.default_rng(0)
        t = rng.standard_normal(m)
        res = Aext[:, basic] @ lu.solve(t) - t
        if np.linalg.norm(res) <= 1e-6 * (1.0 + np.linalg.norm(t)):
            return basic
    except RuntimeError:
        pass
    return np.arange(n, n + m, dtype=np.int64)  # all-artificial fallback


@_single_thread_blas
def dual_simplex(A, b, c, l, u,
                 vstatus: np.ndarray,
                 max_iter: int = 200_000,
                 tol: float = 1e-9,
                 feas_tol: float = 1e-9) -> SimplexResult:
    """Bounded-variable dual simplex.

    Starts from a status vector and restores primal feasibility by driving
    out bound-violating basics — the classic tool for re-solving after RHS
    or bound changes from a previously optimal basis.  A start that is not
    dual feasible is repaired in place (bound flips for boxed columns, then
    artificial opposite bounds at big-M distance for the rest — the
    bound-shift dual phase-1), so the dual engine runs even from arbitrary
    warm starts; a warm-started primal finisher only kicks in if an
    artificial bound is still active at the end (reference capability:
    vendor dual simplex warm starts, solver_caller/caller.py:199-201).
    """
    t0 = time.perf_counter()
    A = sp.csc_matrix(A).astype(np.float64)
    m, n = A.shape
    b = np.asarray(b, dtype=np.float64)
    c0 = np.asarray(c, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)

    Aext = sp.hstack([A, sp.eye(m, format="csc")]).tocsc()
    AextT = Aext.T.tocsr()
    next_l = np.concatenate([l, np.zeros(m)])
    next_u = np.concatenate([u, np.zeros(m)])
    cext = np.concatenate([c0, np.zeros(m)])
    N = n + m

    st = np.full(N, ST_LOWER, dtype=np.int8)
    st[:n] = _sanitize_vstatus(np.asarray(vstatus, dtype=np.int8), l, u)

    basic = _repair_basis(Aext, np.where(st == ST_BASIC)[0], m, n)
    st[st == ST_BASIC] = ST_LOWER
    demoted = (st == ST_LOWER) & ~np.isfinite(next_l)
    st[demoted & np.isfinite(next_u)] = ST_UPPER
    st[demoted & ~np.isfinite(next_u)] = ST_FREE
    st[basic] = ST_BASIC
    fixed_cols = np.isfinite(next_l) & np.isfinite(next_u) & (next_l == next_u)

    x = np.zeros(N)
    x[st == ST_LOWER] = next_l[st == ST_LOWER]
    x[st == ST_UPPER] = next_u[st == ST_UPPER]
    lu = _BasisFactor(Aext, basic)
    x[basic] = 0.0
    x[basic] = lu.solve(b - Aext @ x)

    # dual feasibility restoration on the warm start.  Wrong-sign reduced
    # costs are repaired in place instead of bailing to the primal engine:
    # boxed nonbasics flip to their other bound (rc unchanged, instantly
    # dual-feasible there), and offenders without an opposite finite bound
    # get a temporary artificial bound at big-M distance (the classic
    # bound-shift dual phase-1).  If any artificial bound is still active
    # at the end, the run falls back to a warm-started primal solve.
    y = lu.solve(cext[basic], trans="T")
    rc = cext - Aext.T @ y
    rc[basic] = 0.0
    art_l = np.zeros(N, dtype=bool)   # artificially-added lower bounds
    art_u = np.zeros(N, dtype=bool)   # artificially-added upper bounds
    big = 0.0
    bad_l = (st == ST_LOWER) & ~fixed_cols & (rc < -1e-7)
    bad_u = (st == ST_UPPER) & ~fixed_cols & (rc > 1e-7)
    bad_f = (st == ST_FREE) & (np.abs(rc) > 1e-7)
    if np.any(bad_l | bad_u | bad_f):
        # 1) bound flips for boxed columns
        flip_lu = bad_l & np.isfinite(next_u)
        flip_ul = bad_u & np.isfinite(next_l)
        st[flip_lu] = ST_UPPER
        x[flip_lu] = next_u[flip_lu]
        st[flip_ul] = ST_LOWER
        x[flip_ul] = next_l[flip_ul]
        # 2) artificial opposite bounds for the rest
        finite_x = x[np.isfinite(x)]
        big = 1e7 * max(1.0, np.abs(b).max(initial=0.0),
                        np.abs(finite_x).max(initial=0.0))
        rest_l = bad_l & ~np.isfinite(next_u)
        rest_u = bad_u & ~np.isfinite(next_l)
        if np.any(rest_l):
            next_u[rest_l] = next_l[rest_l] + big
            st[rest_l] = ST_UPPER
            x[rest_l] = next_u[rest_l]
            art_u |= rest_l
        if np.any(rest_u):
            next_l[rest_u] = next_u[rest_u] - big
            st[rest_u] = ST_LOWER
            x[rest_u] = next_l[rest_u]
            art_l |= rest_u
        if np.any(bad_f):
            next_l[bad_f] = -big
            next_u[bad_f] = big
            go_lower = bad_f & (rc > 0)
            st[go_lower] = ST_LOWER
            x[go_lower] = -big
            go_upper = bad_f & (rc < 0)
            st[go_upper] = ST_UPPER
            x[go_upper] = big
            art_l |= bad_f
            art_u |= bad_f
        x_nb = np.where(st != ST_BASIC, x, 0.0)
        x[basic] = lu.solve(b - Aext @ x_nb)

    it = 0
    result_status = "OPTIMAL"
    drw = np.ones(m)   # dual-Devex row reference weights
    escalations = 0

    def _escalate() -> bool:
        """Pure-dual artificial-bound continuation (Koberstein-style):
        widen every artificial bound geometrically and let the dual loop
        continue.  The basis stays dual feasible (reduced costs are
        untouched); nonbasics resting on a widened bound jump with it,
        which re-creates primal infeasibility — exactly the dual
        simplex's restart condition.  Returns False once the escalation
        budget is spent (the primal fallback then handles the residue)."""
        nonlocal escalations, big
        if escalations >= 3 or not (np.any(art_l) or np.any(art_u)):
            return False
        escalations += 1
        widen = 999.0 * big
        big *= 1000.0
        next_u[art_u] += widen
        next_l[art_l] -= widen
        on_au = art_u & (st == ST_UPPER)
        on_al = art_l & (st == ST_LOWER)
        x[on_au] = next_u[on_au]
        x[on_al] = next_l[on_al]
        x_nb_ = np.where(st != ST_BASIC, x, 0.0)
        x[basic] = lu.solve(b - Aext @ x_nb_)
        return True

    while True:
        if it >= max_iter:
            result_status = "ITERATION_LIMIT"
            break
        xb = x[basic]
        lb = next_l[basic]
        ub = next_u[basic]
        below = np.where(np.isfinite(lb), lb - xb, -np.inf)
        above = np.where(np.isfinite(ub), xb - ub, -np.inf)
        viol = np.maximum(below, above)
        # dual-Devex row choice: largest scaled squared infeasibility
        score = np.where(viol > feas_tol, viol * viol / drw, -np.inf)
        r = int(np.argmax(score))
        if viol[r] <= feas_tol:
            # surrogate optimum; if an artificial bound is active, widen
            # it and continue dual (never hand a clean dual run to primal)
            art_active = ((art_u & (st == ST_UPPER))
                          | (art_l & (st == ST_LOWER)))
            if np.any(art_active):
                if _escalate():
                    continue
                # escalation budget spent (big ~ 1e16): a column still
                # resting on an artificial bound with a strictly improving
                # reduced cost certifies an unbounded ray — classify
                # directly, no primal needed
                imp = ((art_u & (st == ST_UPPER) & (rc < -1e-7))
                       | (art_l & (st == ST_LOWER) & (rc > 1e-7)))
                if np.any(imp):
                    result_status = "UNBOUNDED"
                    break
            break  # primal feasible + dual feasible -> optimal
        it += 1
        to_lower = below[r] >= above[r]
        sigma = -1.0 if to_lower else 1.0   # sign of needed change... see below
        # rho = B^{-T} e_r ; alpha_j = a_j' rho
        e_r = np.zeros(m)
        e_r[r] = 1.0
        rho = lu.solve(e_r, trans="T")
        alpha = AextT @ rho
        # leaving basic must move toward its violated bound:
        #   xB[r] changes by -alpha_j * d_j * t for entering j moving d_j
        # need change > 0 when below lower (to_lower), < 0 when above upper
        need = 1.0 if to_lower else -1.0
        at_l = (st == ST_LOWER) & ~fixed_cols
        at_u = (st == ST_UPPER) & ~fixed_cols
        at_f = st == ST_FREE
        # candidate direction d_j: +1 from lower/free, -1 from upper/free
        cand_l = at_l & (-alpha * need > tol)          # d=+1
        cand_u = at_u & (alpha * need > tol)           # d=-1
        cand_f = at_f & (np.abs(alpha) > tol)
        cand = cand_l | cand_u | cand_f
        if not np.any(cand):
            # an INFEASIBLE verdict under artificial bounds only certifies
            # the RESTRICTED problem; widen the restriction and continue
            if _escalate():
                it -= 1
                continue
            result_status = "INFEASIBLE"
            break
        # bound-flipping dual ratio test (BFRT).  Candidates are visited in
        # increasing |rc_j/alpha_j| (the dual step at which rc_j changes
        # sign).  A boxed candidate whose flip capacity |alpha_j|*range_j is
        # smaller than the remaining row infeasibility flips to its other
        # bound — dual-legal precisely because the eventual dual step
        # exceeds its ratio, flipping its rc sign too.  The first candidate
        # that covers the remaining infeasibility enters the basis.
        # (Flipping only the min-ratio candidate WITHOUT the dual update,
        # as a naive "entering hits its own bound" rule does, leaves it
        # dual-infeasible at the new bound and two-cycles.)
        cand_idx = np.flatnonzero(cand)
        order = cand_idx[np.argsort(np.abs(rc[cand_idx])
                                    / np.abs(alpha[cand_idx]))]
        target = lb[r] if to_lower else ub[r]
        delta = abs(target - xb[r])
        e = -1
        n_flip = 0
        flipped = []
        for j in order:
            cap = abs(alpha[j]) * (next_u[j] - next_l[j])
            if np.isfinite(cap) and cap < delta - 1e-12:
                if st[j] == ST_LOWER:
                    st[j] = ST_UPPER
                    x[j] = next_u[j]
                else:
                    st[j] = ST_LOWER
                    x[j] = next_l[j]
                delta -= cap
                n_flip += 1
                flipped.append(int(j))
            else:
                e = int(j)
                break
        if e < 0:
            # every candidate's capacity exhausted and infeasibility
            # remains: dual unbounded along rho -> primal infeasible.
            # Under artificial bounds this only certifies the restriction:
            # revert this iteration's flips (no dual step was taken, so
            # they would be dual-infeasible at their new bound), widen
            # the artificial bounds, and continue the dual loop.
            if (np.any(art_l) or np.any(art_u)) and escalations < 3:
                for j in flipped:
                    if st[j] == ST_UPPER:
                        st[j] = ST_LOWER
                        x[j] = next_l[j]
                    else:
                        st[j] = ST_UPPER
                        x[j] = next_u[j]
                _escalate()
                it -= 1
                continue
            result_status = "INFEASIBLE"
            break
        if n_flip:
            x_nb = np.where(st != ST_BASIC, x, 0.0)
            x[basic] = lu.solve(b - Aext @ x_nb)
            xb = x[basic]
        d_e = 1.0 if (cand_l[e] or (cand_f[e] and -alpha[e] * need > 0)) \
            else -1.0
        # step length from the (post-flip) leaving variable's violation
        t_step = (target - xb[r]) / (-alpha[e] * d_e)
        t_step = max(t_step, 0.0)

        dxb = lu.solve(-_dense_col(Aext, e, m) * d_e)
        x[e] += d_e * t_step
        x[basic] = xb + t_step * dxb

        leaving = basic[r]
        st[leaving] = ST_LOWER if to_lower else ST_UPPER
        x[leaving] = target
        st[e] = ST_BASIC
        basic[r] = e
        # dual-Devex weight update from the pivot column direction
        ae_piv = dxb[r]
        if abs(ae_piv) > 1e-12:
            ratio2 = (dxb / ae_piv) ** 2
            drw = np.maximum(drw, ratio2 * drw[r])
            drw[r] = max(drw[r], 1.0)
            if drw.max() > 1e8:
                drw[:] = 1.0
        v_eta = -dxb / d_e
        try:
            lu.update(basic, r, v_eta)
        except RuntimeError:
            lu.refactor(basic)
        nb = st != ST_BASIC
        x_nb = np.where(nb, x, 0.0)
        x[basic] = lu.solve(b - Aext @ x_nb)
        y = lu.solve(cext[basic], trans="T")
        rc = cext - AextT @ y
        rc[basic] = 0.0

    if np.any(art_l) or np.any(art_u):
        # an artificial bound still "active" (a column resting on it) means
        # the boxed surrogate's optimum is not the true optimum; likewise an
        # INFEASIBLE verdict only certifies the RESTRICTED problem.  Both
        # cases finish with a warm-started primal solve from the current
        # basis (usually very close to optimal).
        art_active = ((art_u & (st == ST_UPPER))
                      | (art_l & (st == ST_LOWER)))
        if (np.any(art_active) and result_status == "OPTIMAL") \
                or result_status not in ("OPTIMAL", "UNBOUNDED"):
            res = primal_simplex(A, b, c0, l, u, vstatus=st[:n],
                                 max_iter=max_iter, tol=tol,
                                 feas_tol=feas_tol)
            res.iter_count += it
            res.fallback = True
            res.runtime = datetime.timedelta(
                seconds=time.perf_counter() - t0)
            return res

    y = lu.solve(cext[basic], trans="T")
    rc_full = cext - AextT @ y
    vstatus_out = st[:n].copy()
    row_basic = np.zeros(m, dtype=bool)
    row_basic[basic[basic >= n] - n] = True
    runtime = datetime.timedelta(seconds=time.perf_counter() - t0)
    return SimplexResult(x=x[:n], y=y, obj_val=float(cext @ x),
                         vstatus=vstatus_out, rcost=rc_full[:n],
                         iter_count=it, status=result_status,
                         runtime=runtime, row_basic=row_basic)
