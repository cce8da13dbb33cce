"""General-LP benchmark instance generation ("optLP"-style).

Host copy of ``smart_crossover_tpu/data/lp_gen.py``; only the import paths
differ (the port may not import the JAX package).

The reference's LP experiments run on the Plato/MIPLIB "optLP" set of
presolved .mps instances (data/README.md:12-23).  With no download path in
this environment, this module generates structurally similar instances —
sparse, mixed '='/'<' rows, some free and boxed variables, feasible and
bounded by construction — and can write them as .mps files for the
perturbation-crossover scripts.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.sparse as sp

from smart_crossover_tpu_torch.models import GeneralLP


def random_sparse_lp(m: int = 120, n: int = 400, density: float = 0.02,
                     frac_ineq: float = 0.4, frac_free: float = 0.05,
                     frac_boxed: float = 0.5, seed: int = 0,
                     name: str | None = None) -> GeneralLP:
    """Sparse LP, primal feasible (interior x0 exists) and dual bounded."""
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, random_state=rng.integers(2**31),
                  format="csr")
    A = A + sp.diags(np.ones(min(m, n)), shape=(m, n))  # structural cover
    A = A.tocsr()
    A.data = rng.standard_normal(A.nnz)

    l = np.zeros(n)
    u = np.full(n, np.inf)
    boxed = rng.uniform(size=n) < frac_boxed
    u[boxed] = rng.uniform(1.0, 5.0, boxed.sum())
    free = rng.uniform(size=n) < frac_free
    l[free], u[free] = -np.inf, np.inf

    # interior feasible point within the (finite) bounds
    x0 = np.where(np.isfinite(u), rng.uniform(0.25, 0.75, n) *
                  np.where(np.isfinite(u), u, 1.0),
                  rng.uniform(0.5, 2.0, n))
    x0[free] = rng.uniform(-1.0, 1.0, free.sum())

    slack = np.where(rng.uniform(size=m) < frac_ineq,
                     rng.uniform(0.1, 1.0, m), 0.0)
    b = np.asarray(A @ x0).ravel() + slack
    sense = np.where(slack > 0, "<", "=")

    # dual-feasible cost => bounded: c = A'y0 + zl - zu with the right signs
    y0 = rng.standard_normal(m) * 0.5
    y0[sense == "<"] = -np.abs(y0[sense == "<"])  # '<' rows need y <= 0
    zl = np.where(np.isfinite(l), np.abs(rng.standard_normal(n)) + 0.01, 0.0)
    zu = np.where(np.isfinite(u) & (rng.uniform(size=n) < 0.3),
                  np.abs(rng.standard_normal(n)) * 0.5, 0.0)
    c = np.asarray(A.T @ y0).ravel() + zl - zu
    if name is None:
        name = f"optlp_like_{m}x{n}_s{seed}"
    return GeneralLP(A=A, b=b, c=c, l=l, u=u, sense=sense, name=name)


def _finish_lp(rng, A, l, u, free, frac_ineq, name) -> GeneralLP:
    """Make the instance feasible and bounded by construction.

    Primal: b = A x0 (+ slack on '<' rows) for an interior x0 within the
    bounds.  Dual: c = A'y0 + zl - zu with y <= 0 on '<' rows and a
    strictly positive margin on lower-bounded columns (zero on free
    columns — a random cost there is an unbounded ray).
    """
    m, n = A.shape
    x0 = np.where(np.isfinite(u), rng.uniform(0.25, 0.75, n)
                  * np.where(np.isfinite(u), u, 1.0),
                  rng.uniform(0.5, 2.0, n))
    x0[free] = rng.uniform(-1.0, 1.0, int(free.sum()))
    slack = np.where(rng.uniform(size=m) < frac_ineq,
                     rng.uniform(0.1, 1.0, m), 0.0)
    b = np.asarray(A @ x0).ravel() + slack
    sense = np.where(slack > 0, "<", "=")
    y0 = rng.standard_normal(m) * 0.5
    y0[sense == "<"] = -np.abs(y0[sense == "<"])
    zl = np.where(np.isfinite(l), np.abs(rng.standard_normal(n)) + 0.01, 0.0)
    zu = np.where(np.isfinite(u) & (rng.uniform(size=n) < 0.3),
                  np.abs(rng.standard_normal(n)) * 0.5, 0.0)
    c = np.asarray(A.T @ y0).ravel() + zl - zu
    return GeneralLP(A=A.tocsr(), b=b, c=c, l=l, u=u, sense=sense,
                     name=name)


def _bounds(rng, n, frac_free, frac_boxed):
    l = np.zeros(n)
    u = np.full(n, np.inf)
    boxed = rng.uniform(size=n) < frac_boxed
    u[boxed] = rng.uniform(1.0, 5.0, int(boxed.sum()))
    free = rng.uniform(size=n) < frac_free
    l[free], u[free] = -np.inf, np.inf
    return l, u, free


def staircase_lp(periods: int = 60, rows_per_period: int = 500,
                 vars_per_period: int = 1700, nnz_per_row: int = 16,
                 frac_ineq: float = 0.3, frac_free: float = 0.02,
                 frac_boxed: float = 0.4, seed: int = 0,
                 name: str | None = None) -> GeneralLP:
    """Multiperiod (staircase) LP: period-t rows touch period t and t-1
    columns only.  The dominant structure of dynamic/planning instances in
    the reference's optLP set (reference data/README.md:12-23); its normal
    equations are block-banded, the regime the sparse-Cholesky IPM path is
    built for.  Defaults: 30k rows x 102k cols, ~1e6 nnz."""
    rng = np.random.default_rng(seed)
    T, r, k = periods, rows_per_period, vars_per_period
    m, n = T * r, T * k
    half = max(nnz_per_row // 2, 2)
    rows, cols = [], []
    for t in range(T):
        rr = np.repeat(np.arange(t * r, (t + 1) * r), half)
        # own-period coupling
        rows.append(rr)
        cols.append(t * k + rng.integers(0, k, r * half))
        # previous-period coupling (staircase band)
        if t > 0:
            rows.append(rr)
            cols.append((t - 1) * k + rng.integers(0, k, r * half))
    # structural anchor: each row covers one own-period column
    diag_rows = np.arange(m)
    diag_cols = (diag_rows // r) * k + (diag_rows % r)
    rows.append(diag_rows)
    cols.append(diag_cols)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = rng.standard_normal(rows.size)
    vals[-m:] = 2.0 + np.abs(vals[-m:])     # strong diagonal anchor
    A = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
    A.sum_duplicates()
    l, u, free = _bounds(rng, n, frac_free, frac_boxed)
    if name is None:
        name = f"stair_{m}x{n}_s{seed}"
    return _finish_lp(rng, A, l, u, free, frac_ineq, name)


def windowed_cover_lp(m: int = 30000, n: int = 100000,
                      win_lo: int = 4, win_hi: int = 14,
                      frac_ineq: float = 0.6, frac_free: float = 0.0,
                      frac_boxed: float = 0.7, seed: int = 0,
                      name: str | None = None) -> GeneralLP:
    """Set-covering-like LP (rail-family analog): every column covers a
    contiguous window of rows.  Columns are short and local, so A D A' is
    banded — the second major optLP structure family."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(win_lo, win_hi + 1, n)
    starts = rng.integers(0, m, n)
    starts = np.minimum(starts, m - lens)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    indices = np.concatenate(
        [np.arange(s, s + L) for s, L in zip(starts, lens)])
    data = np.ones(indices.size)
    # sign mix: covering columns (+1) and a minority of cutting columns
    flip = rng.uniform(size=n) < 0.2
    col_ids = np.repeat(np.arange(n), lens)
    data[flip[col_ids]] = -1.0
    A = sp.csc_matrix((data, indices, indptr), shape=(m, n)).tocsr()
    # anchor: every row covered by a dedicated unit column
    A = sp.hstack([A, 2.0 * sp.eye(m, format="csr")], format="csr")
    n_tot = n + m
    l, u, free = _bounds(rng, n_tot, frac_free, frac_boxed)
    if name is None:
        name = f"cover_{m}x{n_tot}_s{seed}"
    return _finish_lp(rng, A, l, u, free, frac_ineq, name)


def multicommodity_lp(grid: int = 42, commodities: int = 14,
                      frac_ineq_cap: float = 1.0, frac_free: float = 0.0,
                      frac_boxed: float = 0.5, seed: int = 0,
                      name: str | None = None) -> GeneralLP:
    """Multicommodity network design (stp3d-family analog): per-commodity
    flow conservation on a shared grid graph plus arc-capacity coupling
    rows.  Block-diagonal incidence + wide coupling — the third optLP
    structure family (graph-Laplacian-like normal equations).

    Defaults: grid=42, K=14 -> m ~ 31.6k rows, n ~ 96.5k cols."""
    rng = np.random.default_rng(seed)
    g = grid
    V = g * g
    # 4-neighbor grid arcs, both directions
    ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    node = (ii * g + jj).ravel()
    right = node[(jj < g - 1).ravel()]
    down = node[(ii < g - 1).ravel()]
    tails = np.concatenate([right, right + 1, down, down + g])
    heads = np.concatenate([right + 1, right, down + g, down])
    E = tails.size
    K = commodities
    # block-diagonal incidence: commodity k flows on its own copy of arcs
    arc_ids = np.arange(E)
    rows_inc = np.concatenate([np.concatenate([k * V + tails, k * V + heads])
                               for k in range(K)])
    cols_inc = np.concatenate([np.concatenate([k * E + arc_ids,
                                               k * E + arc_ids])
                               for k in range(K)])
    vals_inc = np.tile(np.concatenate([np.ones(E), -np.ones(E)]), K)
    # capacity coupling: sum_k x_{k,a} <= cap_a
    rows_cap = K * V + np.tile(arc_ids, K)
    cols_cap = np.arange(K * E)
    vals_cap = np.ones(K * E)
    m, n = K * V + E, K * E
    A = sp.csr_matrix((np.concatenate([vals_inc, vals_cap]),
                       (np.concatenate([rows_inc, rows_cap]),
                        np.concatenate([cols_inc, cols_cap]))),
                      shape=(m, n))
    l, u, free = _bounds(rng, n, frac_free, frac_boxed)
    # feasible primal: interior flows; conservation rows are '=' with b
    # implied by x0, capacity rows '<' with positive slack
    x0 = np.where(np.isfinite(u), 0.5 * np.where(np.isfinite(u), u, 1.0),
                  rng.uniform(0.5, 2.0, n))
    b = np.asarray(A @ x0).ravel()
    sense = np.array(["="] * (K * V) + ["<"] * E)
    b[K * V:] += rng.uniform(0.5, 2.0, E)        # capacity slack
    y0 = rng.standard_normal(m) * 0.5
    y0[K * V:] = -np.abs(y0[K * V:])
    zl = np.abs(rng.standard_normal(n)) + 0.01
    zu = np.where(np.isfinite(u) & (rng.uniform(size=n) < 0.3),
                  np.abs(rng.standard_normal(n)) * 0.5, 0.0)
    c = np.asarray(A.T @ y0).ravel() + zl - zu
    if name is None:
        name = f"mcom_{m}x{n}_s{seed}"
    return GeneralLP(A=A, b=b, c=c, l=l, u=u, sense=sense, name=name)


def scattered_cover_lp(m: int = 20000, n: int = 70000,
                       len_lo: int = 4, len_hi: int = 12,
                       frac_ineq: float = 0.6, frac_free: float = 0.0,
                       frac_boxed: float = 0.7, seed: int = 0,
                       name: str | None = None) -> GeneralLP:
    """Set-covering LP with SCATTERED (non-local) short columns — the
    rail-family analog (reference data/README.md:12-23).  Unlike
    windowed_cover_lp the covered rows are drawn uniformly at random, so
    A D A' has expander structure: no RCM band exists and the factorizer
    must take its general sparse-LU path.  Exercises the regime where the
    cover structure itself (massive dual degeneracy) makes the plain
    crossover expensive."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(len_lo, len_hi + 1, n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    indices = rng.integers(0, m, int(indptr[-1]))
    data = np.ones(indices.size)
    flip = rng.uniform(size=n) < 0.15
    col_ids = np.repeat(np.arange(n), lens)
    data[flip[col_ids]] = -1.0
    A = sp.csc_matrix((data, indices, indptr), shape=(m, n))
    A.sum_duplicates()
    A = sp.hstack([A, 2.0 * sp.eye(m, format="csr")], format="csr")
    n_tot = n + m
    l, u, free = _bounds(rng, n_tot, frac_free, frac_boxed)
    if name is None:
        name = f"rail_{m}x{n_tot}_s{seed}"
    return _finish_lp(rng, A, l, u, free, frac_ineq, name)


def transport_windowed_lp(supplies: int = 15000, demands: int = 15000,
                          degree: int = 7, frac_boxed: float = 0.6,
                          seed: int = 0,
                          name: str | None = None) -> GeneralLP:
    """Capacitated transportation LP on a geometric bipartite graph — the
    degme-family analog: supply i connects to a window of demands around
    its own position, so the normal equations are a banded bipartite
    Laplacian.  Transportation polytopes are massively primal-degenerate
    (many basic variables at bounds), the regime where vendor crossover
    stalls and the perturbation's unique-vertex trick pays."""
    rng = np.random.default_rng(seed)
    S, D = supplies, demands
    # arcs: supply i -> demands centered at i * D / S
    centers = (np.arange(S, dtype=np.float64) * D / S).astype(np.int64)
    offs = rng.integers(-2 * degree, 2 * degree + 1, (S, degree))
    cols_d = (centers[:, None] + offs) % D
    tails = np.repeat(np.arange(S), degree)
    heads = cols_d.ravel()
    n = tails.size
    rows = np.concatenate([tails, S + heads])
    cols = np.concatenate([np.arange(n), np.arange(n)])
    vals = np.concatenate([np.ones(n), -np.ones(n)])
    A = sp.csr_matrix((vals, (rows, cols)), shape=(S + D, n))
    # feasible interior flow, then marginals from it
    x0 = rng.uniform(0.5, 2.0, n)
    b = np.asarray(A @ x0).ravel()
    sense = np.array(["="] * (S + D))
    l = np.zeros(n)
    u = np.full(n, np.inf)
    boxed = rng.uniform(size=n) < frac_boxed
    u[boxed] = x0[boxed] + rng.uniform(0.5, 3.0, int(boxed.sum()))
    # integer-ish costs with heavy ties -> dual degeneracy like real
    # transportation instances
    c = rng.integers(1, 20, n).astype(np.float64)
    if name is None:
        name = f"tran_{S + D}x{n}_s{seed}"
    return GeneralLP(A=A, b=b, c=c, l=l, u=u, sense=sense, name=name)


def optlp_scale_suite(num_per_family: int = 4, base_seed: int = 42,
                      scale: float = 1.0,
                      families: tuple = ("stair", "cover", "mcom",
                                         "rail", "tran")) -> list[GeneralLP]:
    """Reference-class suite: >=30k rows / ~1e5 cols / ~1e6 nnz per
    instance across five structure families (VERDICT r3 item 1 / r4
    item 8); ``scale`` shrinks every dimension for smoke tests."""
    makers = {
        "stair": lambda s: staircase_lp(
            periods=max(int(60 * scale), 2),
            rows_per_period=max(int(500 * scale), 8),
            vars_per_period=max(int(1700 * scale), 16), seed=s),
        "cover": lambda s: windowed_cover_lp(
            m=max(int(30000 * scale), 40),
            n=max(int(100000 * scale), 120), seed=s),
        "mcom": lambda s: multicommodity_lp(
            grid=max(int(42 * scale), 4),
            commodities=max(int(14 * scale), 2), seed=s),
        "rail": lambda s: scattered_cover_lp(
            m=max(int(20000 * scale), 40),
            n=max(int(70000 * scale), 120), seed=s),
        "tran": lambda s: transport_windowed_lp(
            supplies=max(int(15000 * scale), 24),
            demands=max(int(15000 * scale), 24), seed=s),
    }
    out = []
    for k in range(num_per_family):
        s = base_seed + k
        for fam in families:
            out.append(makers[fam](s))
    return out


def optlp_like_suite(out_dir: str | Path, num: int = 6, base_seed: int = 42,
                     m: int = 120, n: int = 400) -> list[Path]:
    """Generate and write a suite of .mps instances; returns the paths."""
    from smart_crossover_tpu_torch.data.mps_write import write_mps

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for k in range(num):
        lp = random_sparse_lp(m=m, n=n, seed=base_seed + k)
        p = out_dir / f"{lp.name}.mps"
        write_mps(lp, p)
        paths.append(p)
    return paths
