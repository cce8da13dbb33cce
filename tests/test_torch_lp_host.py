"""The port's host copies of the LP solvers against the JAX package's.

The IPM, presolve, the ray extraction, the certificates, the normal-
equations factorizer, the network analysis, the LP manager and the host
projectors are numpy / scipy code copied into the port with only their
import paths changed.  The same seeded inputs go through both packages;
every output array must be equal bit for bit (``np.array_equal``), and
statuses and iteration counts equal.  Sizes and cases are those of the
JAX package's tests of these modules.
"""
import dataclasses
import datetime

import numpy as np
import pytest
import scipy.sparse as sp

from smart_crossover_tpu.data.mcf_gen import transshipment_mcf
from smart_crossover_tpu.lp_methods.lp_manager import LPManager as J_LPManager
from smart_crossover_tpu.models import Basis as J_Basis
from smart_crossover_tpu.models import GeneralLP as J_GeneralLP
from smart_crossover_tpu.solvers import certificates as J_cert
from smart_crossover_tpu.solvers import ipm as J_ipm
from smart_crossover_tpu.solvers import laplacian as J_lap
from smart_crossover_tpu.solvers import presolve as J_pre
from smart_crossover_tpu.solvers import projection as J_proj
from smart_crossover_tpu.solvers import rays as J_rays
from smart_crossover_tpu.solvers.ne_factor import NEFactorizer as J_NEF
from smart_crossover_tpu_torch import interop
from smart_crossover_tpu_torch.lp_methods.lp_manager import (
    LPManager as P_LPManager,
)
from smart_crossover_tpu_torch.models import Basis as P_Basis
from smart_crossover_tpu_torch.solvers import certificates as P_cert
from smart_crossover_tpu_torch.solvers import ipm as P_ipm
from smart_crossover_tpu_torch.solvers import laplacian as P_lap
from smart_crossover_tpu_torch.solvers import presolve as P_pre
from smart_crossover_tpu_torch.solvers import projection as P_proj
from smart_crossover_tpu_torch.solvers import rays as P_rays
from smart_crossover_tpu_torch.solvers.ne_factor import NEFactorizer as P_NEF


def same(a, b, path="out"):
    """Assert a and b equal bit for bit: arrays by np.array_equal (NaN equal
    to NaN), scalars by ==, dataclasses and containers field by field.
    Wall-clock fields (timedelta) are skipped."""
    if isinstance(a, datetime.timedelta):
        return
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
        return
    if sp.issparse(a):
        assert sp.issparse(b), path
        a, b = a.toarray(), b.toarray()
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        kw = {"equal_nan": True} if a.dtype.kind == "f" else {}
        assert np.array_equal(a, b, **kw), path
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
        return
    if isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
        return
    assert a == b, f"{path}: {a!r} != {b!r}"


def lp_pair(A, b, c, l, u, sense):
    """The same LP as the JAX package's GeneralLP and the port's (through
    interop.instance_from_reference)."""
    j = J_GeneralLP(A=A, b=b, c=c, l=l, u=u, sense=sense)
    return j, interop.instance_from_reference(j)


def random_eq_lp(seed, m=10, n=25):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    c = rng.standard_normal(n)
    return A, b, c, np.zeros(n), np.ones(n)


def one_sided_free_lp(seed=4):
    """tests/test_ipm.py::test_ipm_one_sided_and_free."""
    rng = np.random.default_rng(seed)
    m, n = 6, 14
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(-0.3, 0.7, n)
    l = np.full(n, 0.0)
    u = np.full(n, np.inf)
    l[0], u[0] = -np.inf, np.inf
    l[1] = -np.inf
    u[1] = 2.0
    y0 = rng.standard_normal(m)
    zl0 = np.abs(rng.standard_normal(n)) + 0.1
    zl0[0] = 0.0
    zu0 = np.zeros(n)
    zl0[1], zu0[1] = 0.0, np.abs(rng.standard_normal()) + 0.1
    return A, b, A.T @ y0 + zl0 - zu0, l, u


def le_lp(seed):
    """tests/test_ipm.py::test_ipm_general_lp_with_ineq: '<' rows."""
    rng = np.random.default_rng(seed)
    m, n = 5, 10
    A = rng.standard_normal((m, n))
    x0 = rng.uniform(0.2, 0.8, n)
    b = A @ x0 + np.array([0.0, 0.1, 0.0, 0.2, 0.0])
    sense = np.array(["=", "<", "=", "<", "="])
    return A, b, rng.standard_normal(n), np.zeros(n), np.ones(n), sense


# ------------------------------------------------------------------ IPM
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ipm_solve_equality_lps(seed):
    args = random_eq_lp(seed)
    a, b = J_ipm.ipm_solve(*args), P_ipm.ipm_solve(*args)
    assert a.status == "OPTIMAL"
    same(a, b)


def test_ipm_solve_one_sided_and_free():
    args = one_sided_free_lp()
    a, b = J_ipm.ipm_solve(*args), P_ipm.ipm_solve(*args)
    assert a.status == "OPTIMAL"
    same(a, b)


@pytest.mark.parametrize("seed", [42, 7])
def test_ipm_general_lp_with_le_rows(seed):
    j, p = lp_pair(*le_lp(seed))
    a, b = J_ipm.ipm_general_lp(j), P_ipm.ipm_general_lp(p)
    assert a.status == "OPTIMAL"
    same(a, b)


def test_ipm_general_lp_warm_start():
    j, p = lp_pair(*le_lp(3))
    base = J_ipm.ipm_general_lp(j)
    x0 = np.clip(base.x + 0.01, 0.0, 1.0)
    a = J_ipm.ipm_general_lp(j, x0=x0, y0=base.y)
    b = P_ipm.ipm_general_lp(p, x0=x0, y0=base.y)
    same(a, b)


def test_ipm_mcf_tree_pcg_route():
    """An MCF above the IPM's tree-PCG threshold (m > 2000 nodes,
    tests/test_laplacian.py::test_large_mcf_barrier_direct_1e8)."""
    mcf = transshipment_mcf(m=2500, seed=5)
    assert mcf.m >= P_ipm._NE_PCG_MIN_M == J_ipm._NE_PCG_MIN_M
    args = (mcf.A, mcf.b, mcf.c, np.zeros(mcf.n), mcf.u)
    a, b = J_ipm.ipm_solve(*args), P_ipm.ipm_solve(*args)
    assert a.status == "OPTIMAL"
    same(a, b)


# ------------------------------------------------------------ presolve
def presolve_case(seed):
    """tests/test_presolve.py: a fixed column, a singleton '=' row, an
    empty row and an empty column."""
    rng = np.random.default_rng(seed)
    m, n = 6, 10
    A = rng.standard_normal((m, n))
    A[2, :] = 0.0
    A[3, :] = 0.0
    A[3, 7] = 2.0
    A[:, 9] = 0.0
    x0 = rng.uniform(0.2, 0.8, n)
    l = np.zeros(n)
    u = np.ones(n)
    l[5] = u[5] = 0.4
    x0[5] = 0.4
    x0[7] = 0.3
    b = A @ x0
    b[2] = 0.0
    c = rng.standard_normal(n)
    c[9] = 1.0
    sense = np.full(m, "=")
    sense[[0, 4]] = "<"
    b[[0, 4]] += 0.1
    return A, b, c, l, u, sense


@pytest.mark.parametrize("seed", [0, 42])
def test_presolve_and_postsolve(seed):
    j, p = lp_pair(*presolve_case(seed))
    red_j, info_j = J_pre.presolve_lp(j)
    red_p, info_p = P_pre.presolve_lp(p)
    assert red_j.n < j.n and red_j.m < j.m
    same(red_j, red_p, "reduced")
    same(info_j, info_p, "info")
    rng = np.random.default_rng(seed)
    x_red = rng.uniform(0.0, 1.0, red_j.n)
    y_red = rng.standard_normal(red_j.m)
    same(info_j.postsolve_x(x_red), info_p.postsolve_x(x_red), "x")
    same(info_j.postsolve_y(y_red, j), info_p.postsolve_y(y_red, p), "y")


@pytest.mark.parametrize("case", ["infeasible", "unbounded"])
def test_presolve_errors(case):
    if case == "infeasible":
        args = (np.zeros((1, 2)), np.array([1.0]), np.ones(2), np.zeros(2),
                np.ones(2), np.array(["="]))
    else:
        args = (np.array([[1.0, 0.0]]), np.array([1.0]),
                np.array([0.0, -1.0]), np.zeros(2), np.array([2.0, np.inf]),
                np.array(["="]))
    j, p = lp_pair(*args)
    with pytest.raises(J_pre.PresolveError) as ej:
        J_pre.presolve_lp(j)
    with pytest.raises(P_pre.PresolveError) as ep:
        P_pre.presolve_lp(p)
    assert ej.value.status == ep.value.status == case.upper()


# --------------------------------------------------------------- rays
def infeasible_lp():
    """tests/test_rays.py::_infeasible_glp."""
    A = np.array([[1.0, 1.0, 0.5], [1.0, 1.0, 0.5]])
    return (A, np.array([1.0, 4.0]), np.array([1.0, 2.0, 3.0]),
            np.zeros(3), np.full(3, np.inf))


def unbounded_lp():
    """tests/test_rays.py::_unbounded_glp."""
    A = np.array([[1.0, -1.0, 0.0], [0.0, 1.0, -1.0]])
    return (A, np.zeros(2), np.array([-1.0, 0.0, 0.0]),
            np.full(3, -np.inf), np.full(3, np.inf))


@pytest.mark.parametrize("make, status", [(infeasible_lp, "INFEASIBLE"),
                                          (unbounded_lp, "UNBOUNDED")])
def test_classify_lp(make, status):
    A, b, c, l, u = make()
    a, p = J_rays.classify_lp(A, b, c, l, u), P_rays.classify_lp(A, b, c, l, u)
    assert a.status == status
    same(a, p)


def test_extract_farkas_and_ray():
    A, b, c, l, u = infeasible_lp()
    a, p = J_rays.extract_farkas(A, b, l, u), P_rays.extract_farkas(A, b, l, u)
    assert a.status == "INFEASIBLE"
    same(a, p)
    assert (J_rays.verify_farkas(A, b, l, u, a.farkas_ray)
            == P_rays.verify_farkas(A, b, l, u, p.farkas_ray) > 0)
    A, b, c, l, u = unbounded_lp()
    da, dp = J_rays.extract_ray(A, c, l, u), P_rays.extract_ray(A, c, l, u)
    assert da is not None
    same(da, dp)
    assert (J_rays.verify_ray(A, c, l, u, da)
            == P_rays.verify_ray(A, c, l, u, dp) > 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classify_fuzz(seed):
    """tests/test_rays.py::test_classify_matches_highs_fuzz, one of each
    kind (feasible rhs, arbitrary rhs)."""
    rng = np.random.default_rng(seed)
    m, n = 4, 7
    A = rng.normal(size=(m, n))
    c = rng.normal(size=n)
    l = np.where(rng.random(n) < 0.7, 0.0, -np.inf)
    u = np.where(rng.random(n) < 0.4, rng.uniform(1.0, 5.0, n), np.inf)
    b = rng.normal(size=m) * 10.0
    same(J_rays.classify_lp(A, b, c, l, u), P_rays.classify_lp(A, b, c, l, u))


# -------------------------------------------------------- certificates
def test_certify_lp():
    j, p = lp_pair(*le_lp(11))
    res = J_ipm.ipm_general_lp(j)
    same(J_cert.certify_lp(j, res.x, res.y), P_cert.certify_lp(p, res.x, res.y))
    x_bad = res.x + 0.05
    same(J_cert.certify_lp(j, x_bad, res.y), P_cert.certify_lp(p, x_bad, res.y))


def test_certify_mcf():
    mcf_j = transshipment_mcf(m=40, seed=0)
    mcf_p = interop.instance_from_reference(mcf_j)
    res = J_ipm.ipm_solve(mcf_j.A, mcf_j.b, mcf_j.c, np.zeros(mcf_j.n),
                          mcf_j.u)
    for x, y in ((res.x, res.y), (np.round(res.x, 3), res.y * 0.9)):
        same(J_cert.certify_mcf(mcf_j, x, y), P_cert.certify_mcf(mcf_p, x, y))


# ----------------------------------------------------------- NE factor
def _banded_spd(rng, m, bw):
    """tests/test_ne_factor.py::_banded_spd."""
    diags = [rng.standard_normal(m - k) * 0.3 for k in range(1, bw + 1)]
    Mh = sp.diags(diags, offsets=range(1, bw + 1), shape=(m, m))
    M = Mh + Mh.T + sp.diags(np.full(m, 2.0 * bw))
    perm = rng.permutation(m)
    P = sp.csr_matrix((np.ones(m), (np.arange(m), perm)), shape=(m, m))
    return (P @ M @ P.T).tocsr()


@pytest.mark.parametrize("kind", ["banded", "splu"])
def test_ne_factorizer(kind):
    """Both numeric routes: the banded Cholesky on the RCM pattern (small
    patterns never race the two), and the sparse LU that factor() keeps
    for good after a banded breakdown."""
    rng = np.random.default_rng(3)
    if kind == "banded":
        M = _banded_spd(rng, 300, 5)
    else:
        M = sp.random(150, 150, density=0.3, random_state=3)
        M = (M @ M.T + 10.0 * sp.eye(150)).tocsr()
    fa, fp = J_NEF(M), P_NEF(M)
    assert fa.mode == fp.mode == "banded" and fa.bw == fp.bw
    if kind == "splu":
        fa.mode = fp.mode = "splu"
    rhs = rng.standard_normal((M.shape[0], 3))
    for scale, reg in ((1.0, 0.0), (7.5, 1e-8)):
        Ms = (scale * M).tocsr()
        same(fa.factor(Ms, reg)(rhs), fp.factor(Ms, reg)(rhs))
    assert fa.mode == fp.mode == kind


# ------------------------------------------------------------ network
@pytest.mark.parametrize("seed", [0, 2])
def test_analyze_network(seed):
    mcf = transshipment_mcf(m=40, seed=seed)
    A = sp.csc_matrix(mcf.A)
    art = sp.diags(np.where(mcf.b == 0, 1.0, np.sign(mcf.b))).tocsc()
    for M in (A, sp.hstack([A, art])):
        a, b = J_lap.analyze_network(M), P_lap.analyze_network(M)
        assert a is not None
        same(a, b)
    A_gen = sp.random(20, 50, density=0.3, random_state=0)
    assert J_lap.analyze_network(A_gen) is P_lap.analyze_network(A_gen) is None


def test_tree_pcg_solver():
    mcf = transshipment_mcf(m=80, seed=3)
    A = sp.csr_matrix(mcf.A).astype(np.float64)
    AT = A.T.tocsr()
    rng = np.random.default_rng(8)
    d = 10.0 ** rng.uniform(-4, 4, mcf.n)
    reg = 1e-12 * (1.0 + float((A.power(2) @ d).max()))
    rhs = A @ (d * rng.standard_normal(mcf.n))
    outs = [mod.make_tree_pcg_ne_solver(mod.analyze_network(A), A, AT, d,
                                        reg, abs_tol=1e-12)(rhs)
            for mod in (J_lap, P_lap)]
    same(*outs)


# ---------------------------------------------------------- LP manager
def test_lp_manager():
    """tests/test_lp_methods.py::test_lp_manager_fix_and_recover."""
    j, p = lp_pair(*le_lp(5))
    mj, mp = J_LPManager(j.copy()), P_LPManager(p.copy())
    for mgr in (mj, mp):
        mgr.fix_variables(ind_fix_to_low=np.array([0, 3]),
                          ind_fix_to_up=np.array([5]))
        mgr.fix_constraints(ind_fix_to_up=np.array([1]))
        mgr.update_subproblem()
    same(mj.lp_sub, mp.lp_sub, "lp_sub")
    assert mj.get_num_fixed_variables() == mp.get_num_fixed_variables() == 3
    assert (mj.get_num_fixed_constraints()
            == mp.get_num_fixed_constraints())
    x_sub = np.arange(mj.lp_sub.n, dtype=float) / 10
    same(mj.get_orix(x_sub), mp.get_orix(x_sub))
    same(mj.recover_x_from_sub_x(x_sub), mp.recover_x_from_sub_x(x_sub))
    vb = np.zeros(mj.lp_sub.n)
    cb = -np.ones(mj.lp_sub.m)
    same(mj.recover_basis_from_sub_basis(J_Basis(vb, cb)),
         mp.recover_basis_from_sub_basis(P_Basis(vb, cb)))


# ---------------------------------------------------------- projectors
def test_apply_projector():
    rng = np.random.default_rng(0)
    Y = sp.random(12, 40, density=0.3, random_state=1) + sp.eye(12, 40)
    v = rng.standard_normal(40)
    a, b = J_proj.apply_projector(Y, v), P_proj.apply_projector(Y, v)
    same(a, b)
    assert J_proj.projector_residual(Y, a) == P_proj.projector_residual(Y, b)


def test_apply_projector_with_free():
    rng = np.random.default_rng(1)
    Y = sp.random(10, 30, density=0.3, random_state=2) + sp.eye(10, 30)
    A_f = sp.csr_matrix(rng.standard_normal((10, 3)))
    v = rng.standard_normal(30)
    same(J_proj.apply_projector_with_free(Y, v, A_f),
         P_proj.apply_projector_with_free(Y, v, A_f))
