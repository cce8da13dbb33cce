"""The port's single-instance PDHG against the JAX package's (CPU, f64):
the chunk kernels' plain versions against the Pallas kernels in interpret
mode, the eager cores against the jitted ones, and ``pdhg_solve`` end to
end against the JAX package and HiGHS."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ssp
import torch
from scipy.optimize import linprog

from smart_crossover_tpu.ops.pdhg_pallas import (
    get_halpern_chunk_fn,
    get_pdhg_chunk_fn,
    pad_lp_for_pallas,
)
from smart_crossover_tpu.solvers import pdhg as jp
from smart_crossover_tpu_torch import pdhg_solve
from smart_crossover_tpu_torch.interop import from_reference
from smart_crossover_tpu_torch.ops.pdhg_chunk import (
    halpern_chunk,
    halpern_chunk_plain,
    pdhg_chunk,
    pdhg_chunk_plain,
)
from smart_crossover_tpu_torch.solvers import pdhg as tp


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _chunk_inputs(rng):
    """The inputs of tests/test_pallas.py::test_pallas_pdhg_chunk_matches_scan."""
    m, n = 16, 128
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    c = rng.standard_normal(n)
    l, u = np.zeros(n), np.ones(n)
    eq = rng.random(m) < 0.5
    x = np.full(n, 0.5)
    y = np.zeros(m)
    return A, b, c, l, u, eq, x, y, A @ x


@pytest.mark.parametrize("runner", [pdhg_chunk_plain, pdhg_chunk])
def test_pdhg_chunk_matches_pallas(rng, runner):
    """K3's plain version (and the wrapper's CPU route) against
    _pdhg_chunk_kernel in interpret mode: 32 adaptive iterations."""
    A, b, c, l, u, eq, x, y, Ax = _chunk_inputs(rng)
    m, n = A.shape
    opnorm, eta = 20.0, 0.9 / 20.0
    fn = get_pdhg_chunk_fn(m, n, "float64", 32, interpret=True)
    want = fn(*(jnp.asarray(v) for v in (A, b, c, l, u, eq, x, y, Ax)),
              jnp.zeros(n), jnp.zeros(m), 0.0, eta, 1.0, 0, opnorm)
    At, bt, ct, lt, ut, eqt, xt, yt, Axt = _t(A, b, c, l, u, eq, x, y, Ax)
    got = runner(At, bt, ct, lt, ut, eqt.double(), xt, yt, Axt,
                 torch.zeros(n, dtype=torch.float64),
                 torch.zeros(m, dtype=torch.float64),
                 0.0, eta, 1.0, 0, opnorm, chunk=32)
    for g, w in zip(got[:5], want[:5]):        # x, y, Ax, xs, ys
        _close(g, w)
    assert float(got[5]) == pytest.approx(float(want[5]), rel=1e-12)
    assert float(got[6]) == pytest.approx(float(want[6]), rel=1e-9)


@pytest.mark.parametrize("runner", [halpern_chunk_plain, halpern_chunk])
def test_halpern_chunk_matches_pallas(rng, runner):
    """K4's plain version (and the wrapper's CPU route) against
    _halpern_chunk_kernel in interpret mode: 32 Halpern iterations from a
    mid-window state (k = 5) with anchors of their own."""
    A, b, c, l, u, eq, x, y, Ax = _chunk_inputs(rng)
    m, n = A.shape
    xa = rng.uniform(0.0, 1.0, n)
    ya = 0.1 * rng.standard_normal(m)
    y = 0.1 * rng.standard_normal(m)
    omega, k, step = 1.3, 5.0, 0.99 / 20.0
    fn = get_halpern_chunk_fn(m, n, "float64", 32, interpret=True)
    want = fn(*(jnp.asarray(v) for v in (A, b, c, l, u, eq, x, y, Ax, xa,
                                          ya, A @ xa)), omega, k, step)
    ref = from_reference(A=A, b=b, c=c, l=l, u=u, x=x, y=y, Ax=Ax, xa=xa,
                         ya=ya, Axa=A @ xa)
    got = runner(ref["A"], ref["b"], ref["c"], ref["l"], ref["u"],
                 torch.from_numpy(eq), ref["x"], ref["y"], ref["Ax"],
                 ref["xa"], ref["ya"], ref["Axa"], omega, k, step, chunk=32)
    for g, w in zip(got[:3], want[:3]):        # x, y, Ax
        _close(g, w)
    assert float(got[3]) == float(want[3]) == k + 32


def _lp_eq(rng, m=16, n=128):
    """A feasible bounded equality LP (tests/test_pallas.py:156-161)."""
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    b = A @ rng.uniform(0.2, 0.8, n)
    c = A.T @ rng.standard_normal(m) + np.abs(rng.standard_normal(n)) + 0.05
    return A, b, c, np.zeros(n), np.full(n, 2.0), np.array(["="] * m)


def _lp_le(rng, m=12, n=50):
    """Six '=' and six '<' rows, unaligned (tests/test_pallas.py:125-130)."""
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.1, 0.9, n)
    sense = np.array(["="] * 6 + ["<"] * 6)
    b = b + np.where(sense == "<", 0.3, 0.0)
    c = rng.standard_normal(n)
    return A, b, c, np.zeros(n), np.ones(n), sense


@pytest.mark.parametrize("mode", ["adaptive", "halpern"])
@pytest.mark.parametrize("make,horizon", [(_lp_eq, 256), (_lp_le, 128)])
def test_core_matches_jax_short_horizon(rng, make, horizon, mode):
    """A short horizon (a restart check after every 64-iteration chunk),
    tol = 0, the same ||A|| on both sides: the port's eager core (plain
    chunks) against the JAX core running the Pallas chunk on the padded LP,
    cut back.  On the '<' LP the horizon is 128: reduction-order
    differences grow about 1000x per chunk there, and at 192 iterations
    the JAX package's own XLA and Pallas cores already differ by 7.6e-9."""
    A, b, c, l, u, sense = make(rng)
    m, n = A.shape
    is_eq = sense == "="
    opnorm = float(np.linalg.norm(A, 2))
    x0, y0 = np.clip(np.zeros(n), l, u), np.zeros(m)
    kw = dict(max_iters=horizon, check_every=64, restart_period=200,
              tol=0.0)
    (Ap, bp, cp, lp, up, eqp, x0p, y0p, _, _) = pad_lp_for_pallas(
        *(jnp.asarray(v) for v in (A, b, c, l, u, is_eq, x0, y0)))
    mp, np_ = Ap.shape
    if mode == "halpern":
        runner = get_halpern_chunk_fn(mp, np_, "float64", 64, True)
        jcore, tcore = jp._pdhg_core_halpern, tp._pdhg_core_halpern
    else:
        runner = get_pdhg_chunk_fn(mp, np_, "float64", 64, True)
        jcore, tcore = jp._pdhg_core, tp._pdhg_core
    jx, jy, jit, jdone = jcore(Ap, bp, cp, lp, up, eqp, jnp.asarray(opnorm),
                               x0p, y0p, chunk_runner=runner, **kw)
    At, bt, ct, lt, ut, x0t, y0t = _t(A, b, c, l, u, x0, y0)
    x, y, it, done = tcore(At, bt, ct, lt, ut, torch.from_numpy(is_eq),
                           torch.tensor(opnorm, dtype=torch.float64),
                           x0t, y0t, **kw)
    assert it == int(jit) == horizon and not done and not bool(jdone)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx)[:n], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy)[:m], rtol=0,
                               atol=1e-9)


def _highs(A, b, c, l, u, sense):
    eq = sense == "="
    le = ~eq
    return linprog(c, A_eq=A[eq], b_eq=b[eq],
                   A_ub=A[le] if le.any() else None,
                   b_ub=b[le] if le.any() else None,
                   bounds=list(zip(l, u)), method="highs")


@pytest.mark.parametrize("mode", ["adaptive", "halpern"])
@pytest.mark.parametrize("make,tol,max_iters",
                         [(_lp_le, 1e-8, 20_000), (_lp_eq, 1e-7, 30_000)])
def test_pdhg_solve_matches_jax_and_highs(rng, make, tol, max_iters, mode):
    """pdhg_solve end to end on the LPs of tests/test_pallas.py:118-170:
    the port on the CPU against the JAX package with use_pallas=True
    (interpret mode, padded): both OPTIMAL, objectives within
    1e-6 (1 + |obj|) of each other and of HiGHS."""
    A, b, c, l, u, sense = make(rng)
    kw = dict(sense=sense, tol=tol, max_iters=max_iters, mode=mode)
    want = jp.pdhg_solve(A, b, c, l, u, use_pallas=True, **kw)
    got = pdhg_solve(A, b, c, l, u, device="cpu", **kw)
    ref = _highs(A, b, c, l, u, sense)
    assert ref.status == 0
    assert got.status == want.status == "OPTIMAL"
    scale = 1e-6 * (1.0 + abs(ref.fun))
    assert abs(got.obj_val - want.obj_val) <= scale
    assert abs(got.obj_val - ref.fun) <= scale
    assert got.x.shape == (A.shape[1],) and got.y.shape == (A.shape[0],)


def test_pdhg_solve_takes_tensors(rng):
    """Tensors in, the same answer as numpy in (the device is the
    tensor's)."""
    A, b, c, l, u, sense = _lp_eq(rng)
    kw = dict(sense=sense, tol=1e-7, max_iters=30_000)
    a = pdhg_solve(A, b, c, l, u, device="cpu", **kw)
    t = pdhg_solve(*_t(A, b, c, l, u), **kw)
    assert a.iter_count == t.iter_count
    np.testing.assert_array_equal(a.x, t.x)


def test_estimate_opnorm_matches_svd():
    """Power iteration from the port's own start vector: a spectral gap
    sigma1 / sigma2 = 2.5 makes 50 steps converge whatever the start."""
    rng = np.random.default_rng(7)
    m, n = 30, 70
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, m)))
    sig = np.concatenate([[10.0], np.linspace(4.0, 0.5, m - 1)])
    A = (U * sig) @ V.T
    est = float(tp.estimate_opnorm(torch.from_numpy(A)))
    assert est == pytest.approx(np.linalg.norm(A, 2), rel=1e-6)


def test_sparse_and_unknown_mode_raise(rng):
    """A sparse A takes the sparse route (on the CPU, the host scipy core
    in both packages: bit for bit); an unknown mode raises."""
    from jax.experimental import sparse as jsparse

    A, b, c, l, u, _ = _lp_eq(rng, 4, 8)
    got = pdhg_solve(ssp.csr_matrix(A), b, c, l, u, device="cpu")
    want = jp.pdhg_solve(jsparse.BCOO.fromdense(jnp.asarray(A)), b, c, l, u)
    assert got.status == want.status == "OPTIMAL"
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, want.y)
    with pytest.raises(ValueError, match="mode"):
        pdhg_solve(A, b, c, l, u, mode="barrier")


def test_chunk_wrappers_refuse_other_devices():
    A = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pdhg_chunk(A, *([None] * 10), 0.0, 1.0, 1.0, 0, 1.0)
    with pytest.raises(ValueError, match="no kernel"):
        halpern_chunk(A, *([None] * 11), 1.0, 0.0, 1.0)


def test_cpu_route_launches_no_kernel(rng):
    """On CPU tensors the wrappers run the plain versions and count no
    launch."""
    from smart_crossover_tpu_torch import _build

    A, b, c, l, u, sense = _lp_eq(rng, 6, 20)
    _build.reset_kernel_launch_counts()
    for mode in ("adaptive", "halpern"):
        pdhg_solve(A, b, c, l, u, sense=sense, max_iters=128, mode=mode,
                   device="cpu")
    assert not any(_build.kernel_launch_counts().values())
