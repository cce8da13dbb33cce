"""The port's sparse first-order LP against the JAX package's (CPU, f64):
the sparse Ruiz scaling, the host scipy core, the PDHG cores on a sparse
operator against the JAX cores on a BCOO A, ``pdhg_solve`` and
``pdhg_general_lp`` on a sparse A, the arc-list MCF PDHG
``pdhg_mcf_device``, and ``solve_mcf(method='first_order')``.

Tolerances: the host scipy core runs the same numpy operations in both
packages and must agree bit for bit.  The tensor cores take their sums
in another order than XLA's BCOO products; the Halpern core holds 1e-12
over 512 iterations, the adaptive core 1e-9 over 128: its step rule
divides by a cancelling sum, and reduction-order differences grow about
1000x per chunk after that (ROADMAP section 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ssp
import torch
from jax.experimental import sparse as jsparse
from scipy.optimize import linprog

from smart_crossover_tpu.data import mcf_gen as j_gen
from smart_crossover_tpu.data.lp_gen import random_sparse_lp
from smart_crossover_tpu.models import GeneralLP as J_GeneralLP
from smart_crossover_tpu.solvers import pdhg as JP
from smart_crossover_tpu.solvers import pdhg_mcf as JM
from smart_crossover_tpu_torch import interop
from smart_crossover_tpu_torch.ops.pdhg_sparse import (
    CSROperator,
    IncidenceOperator,
)
from smart_crossover_tpu_torch.solvers import pdhg as PP
from smart_crossover_tpu_torch.solvers import pdhg_mcf as PM

CPU = "cpu"
HALPERN_TOL, HALPERN_ITERS = 1e-12, 512
ADAPTIVE_TOL, ADAPTIVE_ITERS = 1e-9, 128


def eq_sparse_lp(seed=5, m=30, n=120):
    """A sparse all-equality LP with a diagonal cover, x* in (0.2, 0.8)."""
    rng = np.random.default_rng(seed)
    A = (ssp.random(m, n, density=0.1, random_state=seed, format="csr")
         + ssp.eye(m, n)).tocsr()
    return J_GeneralLP(A=A, b=A @ rng.uniform(0.2, 0.8, n),
                       c=rng.standard_normal(n), l=np.zeros(n),
                       u=np.ones(n), sense=np.full(m, "="))


LPS = {"eq": eq_sparse_lp,
       "le": lambda: random_sparse_lp(m=40, n=160, seed=17)}


def scaled(lp):
    """The Ruiz-scaled LP as pdhg_solve runs it: (A as COO, b, c, l, u,
    is_eq, x0, y0)."""
    A = ssp.csr_matrix(lp.A)
    R, C = JP._ruiz_equilibrate(jsparse.BCOO.from_scipy_sparse(A))
    coo = A.tocoo()
    As = ssp.coo_matrix((coo.data * R[coo.row] * C[coo.col],
                         (coo.row, coo.col)), shape=A.shape)
    l, u = lp.l / C, lp.u / C
    return (As, lp.b * R, lp.c * C, l, u, lp.sense == "=",
            np.clip(np.zeros(A.shape[1]), l, u), np.zeros(A.shape[0]))


def _t(v):
    return torch.as_tensor(np.asarray(v))


@pytest.mark.parametrize("case", sorted(LPS))
def test_ruiz_sparse_matches_jax_bit_for_bit(case):
    A = ssp.csr_matrix(LPS[case]().A)
    R, C = PP._ruiz_equilibrate(A)
    jR, jC = JP._ruiz_equilibrate(jsparse.BCOO.from_scipy_sparse(A))
    np.testing.assert_array_equal(R, jR)
    np.testing.assert_array_equal(C, jC)


@pytest.mark.parametrize("case", sorted(LPS))
def test_scipy_core_matches_jax_bit_for_bit(case):
    As, b, c, l, u, eq, x0, y0 = scaled(LPS[case]())
    A = ssp.csr_matrix(As)
    opnorm = PP._scipy_opnorm(A, A.shape[1])
    kw = dict(max_iters=640, check_every=64, restart_period=200, tol=1e-9)
    x, y, it, done = PP._pdhg_core_scipy(A, b, c, l, u, eq, opnorm, x0, y0,
                                         **kw)
    jx, jy, jit, jdone = JP._pdhg_core_scipy(A, b, c, l, u, eq, opnorm, x0,
                                             y0, **kw)
    np.testing.assert_array_equal(x, np.asarray(jx))
    np.testing.assert_array_equal(y, np.asarray(jy))
    assert it == int(jit) and done == bool(jdone)


@pytest.mark.parametrize("case", sorted(LPS))
@pytest.mark.parametrize("mode", ["adaptive", "halpern"])
def test_sparse_core_matches_jax_bcoo_core(case, mode):
    """The tensor core on a CSR operator against the JAX core on the same
    BCOO A, the same ||A||, tol 0 (no early stop)."""
    As, b, c, l, u, eq, x0, y0 = scaled(LPS[case]())
    m, n = As.shape
    op = CSROperator(As.row, As.col, As.data, As.shape, torch.float64, CPU)
    opnorm = float(np.linalg.norm(As.toarray(), 2))
    if mode == "halpern":
        iters, tol = HALPERN_ITERS, HALPERN_TOL
        jcore, pcore = JP._pdhg_core_halpern, PP._pdhg_core_halpern
    else:
        iters, tol = ADAPTIVE_ITERS, ADAPTIVE_TOL
        jcore, pcore = JP._pdhg_core, PP._pdhg_core
    kw = dict(max_iters=iters, check_every=64, restart_period=200, tol=0.0)
    Ab = jsparse.BCOO((jnp.asarray(As.data), jnp.stack(
        [jnp.asarray(As.row), jnp.asarray(As.col)], 1)), shape=As.shape)
    jx, jy, jit, _ = jcore(Ab, *(jnp.asarray(v) for v in (b, c, l, u, eq)),
                           jnp.asarray(opnorm), jnp.asarray(x0),
                           jnp.asarray(y0), **kw)
    x, y, it, done = pcore(op, *(_t(v) for v in (b, c, l, u, eq)),
                           torch.tensor(opnorm, dtype=torch.float64),
                           _t(x0), _t(y0), **kw)
    assert it == int(jit) == iters and not done
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=tol)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=tol)


def test_operators_match_scipy():
    rng = np.random.default_rng(3)
    mcf = j_gen.transshipment_mcf(m=25, seed=2)
    A = ssp.csr_matrix(mcf.A)
    x, y = rng.standard_normal(mcf.n), rng.standard_normal(mcf.m)
    coo = A.tocoo()
    for op in (CSROperator(coo.row, coo.col, coo.data, A.shape,
                           torch.float64, CPU),
               IncidenceOperator(mcf.tails, mcf.heads, mcf.m, torch.float64,
                                 CPU)):
        assert op.shape == A.shape and op.T.shape == A.shape[::-1]
        np.testing.assert_allclose((op @ _t(x)).numpy(), A @ x, atol=1e-12)
        np.testing.assert_allclose((op.T @ _t(y)).numpy(), A.T @ y,
                                   atol=1e-12)
        assert op.T.T is op


@pytest.mark.parametrize("mode", ["adaptive", "halpern"])
def test_pdhg_solve_sparse_matches_jax(mode):
    """pdhg_solve on a scipy A against the JAX package's on the BCOO A, on
    the CPU: the adaptive mode runs the host scipy core in both packages
    (bit for bit, polish included); the Halpern mode the tensor core on
    the CSR operator against XLA's BCOO core (their ||A|| estimates come
    from other random starts, so at the solution: tol 1e-8, the
    objectives within 1e-7 of each other and of HiGHS)."""
    lp = eq_sparse_lp()
    A = ssp.csr_matrix(lp.A)
    kw = dict(tol=1e-8, max_iters=20_000, mode=mode)
    a = JP.pdhg_solve(jsparse.BCOO.from_scipy_sparse(A), lp.b, lp.c, lp.l,
                      lp.u, **kw)
    r = PP.pdhg_solve(A, lp.b, lp.c, lp.l, lp.u, device=CPU, **kw)
    assert a.status == r.status == "OPTIMAL"
    ref = linprog(lp.c, A_eq=A.toarray(), b_eq=lp.b,
                  bounds=list(zip(lp.l, lp.u)), method="highs").fun
    if mode == "adaptive":
        np.testing.assert_array_equal(r.x, a.x)
        np.testing.assert_array_equal(r.y, a.y)
        assert r.iter_count == a.iter_count and r.obj_val == a.obj_val
    assert r.obj_val == pytest.approx(a.obj_val, rel=1e-7)
    assert r.obj_val == pytest.approx(ref, rel=1e-7)


def test_pdhg_solve_takes_a_sparse_tensor():
    """A sparse tensor A runs the same route as its scipy matrix."""
    lp = eq_sparse_lp(seed=6, m=20, n=60)
    A = ssp.csr_matrix(lp.A)
    kw = dict(tol=1e-6, max_iters=4000, device=CPU)
    a = PP.pdhg_solve(A, lp.b, lp.c, lp.l, lp.u, **kw)
    coo = A.tocoo()
    At = torch.sparse_coo_tensor(np.stack([coo.row, coo.col]), coo.data,
                                 size=A.shape)
    b = PP.pdhg_solve(At.to_sparse_csr(), lp.b, lp.c, lp.l, lp.u, **kw)
    np.testing.assert_array_equal(a.x, b.x)
    assert a.status == b.status == "OPTIMAL"


def test_pdhg_general_lp_sparse_rule_matches_jax():
    """A big sparse LP (m n > 1e6, nnz < 0.1 m n) takes the sparse route
    in both packages by default; cut at 256 iterations (the host core on
    both sides), the results agree bit for bit, polish included."""
    lp_j = random_sparse_lp(m=600, n=2400, seed=2)
    lp_p = interop.instance_from_reference(lp_j)
    assert lp_j.m * lp_j.n > 1_000_000
    a = JP.pdhg_general_lp(lp_j, max_iters=256)
    b = PP.pdhg_general_lp(lp_p, max_iters=256, device=CPU)
    np.testing.assert_array_equal(b.x, a.x)
    np.testing.assert_array_equal(b.y, a.y)
    assert b.status == a.status and b.iter_count == a.iter_count == 256


def mcf_cases():
    return {"transshipment": j_gen.transshipment_mcf(m=60, seed=3),
            "goto_regular": j_gen.goto_like_mcf(12, 12, 4, regular=True,
                                                seed=1)}


@pytest.fixture
def jax_arc_order_start(monkeypatch):
    """The port's power iteration starts from the JAX package's Gaussian,
    drawn in that package's degree-bucket arc order, moved back to the
    instance's arc order: both ||A|| estimates then run from one vector."""
    def use(mcf):
        order = JM.IncidenceDeviceOp(mcf.tails, mcf.heads, mcf.m).order_T
        v = np.empty(mcf.n)
        v[order] = np.random.default_rng(0).standard_normal(mcf.n)
        monkeypatch.setattr(PM, "_start_vector", lambda n, seed=0: v)
    return use


@pytest.mark.parametrize("case", ["transshipment", "goto_regular"])
def test_pdhg_mcf_device_matches_jax_halpern(case, jax_arc_order_start):
    """The default (Halpern) mode, f64, two chunks: x, y back in the
    instance's arc and node order in both packages."""
    mcf_j = mcf_cases()[case]
    jax_arc_order_start(mcf_j)
    kw = dict(max_iters=500, mode="halpern", tol=1e-12)
    jx, jy, ji, jd, _ = JM.pdhg_mcf_device(mcf_j, dtype=jnp.float64, **kw)
    x, y, it, done, rt = PM.pdhg_mcf_device(
        interop.instance_from_reference(mcf_j), device=CPU, **kw)
    assert it == ji == 500 and done == jd
    np.testing.assert_allclose(x, jx, rtol=0, atol=HALPERN_TOL * (
        1 + np.abs(jx).max()))
    np.testing.assert_allclose(y, jy, rtol=0, atol=HALPERN_TOL * (
        1 + np.abs(jy).max()))
    assert x.dtype == np.float64 and rt.total_seconds() > 0


def test_pdhg_mcf_device_adaptive_matches_jax_core():
    """The adaptive mode against the JAX adaptive core on the BCOO
    incidence matrix (the JAX package's own pdhg_mcf_device runs that core
    on its incidence operator), the same ||A||, 128 iterations, the
    differences relative to 1 + the largest value."""
    mcf_j = mcf_cases()["transshipment"]
    mcf_p = interop.instance_from_reference(mcf_j)
    A = mcf_p.A.tocoo()
    op = CSROperator(A.row, A.col, A.data, A.shape, torch.float64, CPU)
    opnorm = PM._power_opnorm(op, _t(PM._start_vector(mcf_p.n)))
    kw = dict(max_iters=ADAPTIVE_ITERS, check_every=64, restart_period=200,
              tol=1e-12)
    x, y, it, done, _ = PM.pdhg_mcf_device(mcf_p, mode="adaptive",
                                           device=CPU, **kw)
    n, m = mcf_j.n, mcf_j.m
    u = np.asarray(mcf_j.u, np.float64)
    jx, jy, jit, _ = JP._pdhg_core(
        jsparse.BCOO.from_scipy_sparse(ssp.csr_matrix(mcf_j.A)),
        jnp.asarray(mcf_j.b), jnp.asarray(mcf_j.c), jnp.zeros(n),
        jnp.asarray(u), jnp.ones(m, bool), jnp.asarray(float(opnorm)),
        jnp.clip(jnp.zeros(n), 0.0, u), jnp.zeros(m), **kw)
    assert it == int(jit) == ADAPTIVE_ITERS
    # flows run up to the capacities: differences relative to 1 + max |x|
    for got, want in ((x, np.asarray(jx)), (y, np.asarray(jy))):
        np.testing.assert_allclose(got, want, rtol=0, atol=ADAPTIVE_TOL * (
            1 + np.abs(want).max()))


def test_pdhg_mcf_device_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mcf = interop.instance_from_reference(j_gen.transshipment_mcf(m=30))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.pdhg_mcf_device(mcf)
    with pytest.raises(ValueError, match="mode"):
        PM.pdhg_mcf_device(mcf, mode="barrier", device=CPU)
