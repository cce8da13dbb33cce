"""The port's solver facade (``solve_lp``, ``solve_mcf``, ``solve_ot``)
against the JAX package's, method by method, on the CPU.

The host methods (presolve, barrier with and without crossover, the
perturbation crossover, the simplex methods, the network simplex) must
match bit for bit.  The device methods run their plain versions with
``device="cpu"``: PDHG on an all-equality dense LP (statuses equal,
objectives within 1e-6 relative of each other and within barrierTol of
HiGHS), Sinkhorn to 1e-9, the device simplex (the default engine
'parent' and 'mega') to the certified objective and HiGHS's to 1e-9.  The
sparse first-order routes (a big sparse LP, ``solve_mcf(method=
'first_order')``) run the host scipy core on the CPU in both packages and
match bit for bit.
"""
import numpy as np
import pytest
import scipy.sparse as sp
from scipy.optimize import linprog

from smart_crossover_tpu.data.mcf_gen import transshipment_mcf
from smart_crossover_tpu.data.lp_gen import random_sparse_lp
from smart_crossover_tpu.models import GeneralLP as J_GeneralLP
from smart_crossover_tpu.models import OptTransport as J_OT
from smart_crossover_tpu.models import StandardLP as J_StandardLP
from smart_crossover_tpu.solvers import solving as J
from smart_crossover_tpu.solvers.settings import SolverSettings as J_Settings
from smart_crossover_tpu_torch import interop
from smart_crossover_tpu_torch.solvers import solving as P
from smart_crossover_tpu_torch.solvers.settings import (
    SolverSettings as P_Settings,
)
from tests.test_torch_lp_host import presolve_case, same
from tests.test_torch_network_simplex import same_native_core  # noqa: F401

# the JAX side's network simplex runs the port's C++ core
pytestmark = pytest.mark.usefixtures("same_native_core")

EXACT_RTOL = 1e-9


def eq_lp(seed, m=6, n=15):
    """tests/test_solving.py::make_lp."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    c = rng.standard_normal(n)
    return J_GeneralLP(A=A, b=b, c=c, l=np.zeros(n), u=np.ones(n),
                       sense=np.full(m, "="))


def le_lp(seed, m=8, n=20):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n) + np.where(np.arange(m) % 2, 0.3, 0.0)
    sense = np.where(np.arange(m) % 2, "<", "=")
    return J_GeneralLP(A=A, b=b, c=rng.standard_normal(n), l=np.zeros(n),
                       u=np.ones(n), sense=sense)


def highs_general(lp):
    A = sp.csr_matrix(lp.A)
    eq = lp.sense == "="
    res = linprog(lp.c,
                  A_eq=A[eq].toarray() if eq.any() else None,
                  b_eq=lp.b[eq] if eq.any() else None,
                  A_ub=A[~eq].toarray() if (~eq).any() else None,
                  b_ub=lp.b[~eq] if (~eq).any() else None,
                  bounds=[(lo if np.isfinite(lo) else None,
                           up if np.isfinite(up) else None)
                          for lo, up in zip(lp.l, lp.u)], method="highs")
    assert res.status == 0
    return res


def both_lp(lp_j, method, settings=None, device=None, **kw):
    """The JAX facade's and the port's answers (``device`` goes to the
    port alone)."""
    lp_p = interop.instance_from_reference(lp_j)
    sj = J_Settings(**settings) if settings else None
    sp_ = P_Settings(**settings) if settings else None
    dev = {} if device is None else {"device": device}
    return (J.solve_lp(lp_j, method=method, settings=sj, **kw),
            P.solve_lp(lp_p, method=method, settings=sp_, **kw, **dev))


# ------------------------------------------------------- LP host methods
LP_CASES = {"eq": lambda: eq_lp(42), "le": lambda: le_lp(3),
            "presolve": lambda: J_GeneralLP(*presolve_case(0)),
            "sparse": lambda: random_sparse_lp(m=40, n=160, seed=17)}


@pytest.mark.parametrize("case", sorted(LP_CASES))
@pytest.mark.parametrize("method, settings", [
    ("default", None),
    ("simplex", None),
    ("primal_simplex", {"simplexPricing": "PP"}),
    ("barrier", None),
    ("barrier", {"crossover": "off"}),
    ("barrier_perturb", None),
])
def test_solve_lp_host_methods_bit_for_bit(case, method, settings):
    lp = LP_CASES[case]()
    a, b = both_lp(lp, method, settings)
    assert a.status == "OPTIMAL"
    same(a, b)
    ref = highs_general(lp)
    if method != "barrier" or settings is None:
        # every exact vertex equals HiGHS's objective
        assert b.obj_val == pytest.approx(ref.fun, rel=1e-8)


def test_solve_lp_dual_simplex_warm_basis():
    """A dual-feasible warm basis (tests/test_dual_simplex.py): the optimal
    basis of the LP, then the right-hand side moved."""
    lp = eq_lp(42)
    base = J.solve_lp(lp, method="simplex")
    lp2 = lp.copy()
    lp2.b = lp.b + 0.02
    warm = interop.instance_from_reference(base.basis)
    a = J.solve_lp(lp2, method="dual_simplex", warm_start_basis=base.basis)
    b = P.solve_lp(interop.instance_from_reference(lp2),
                   method="dual_simplex", warm_start_basis=warm)
    assert a.status == "OPTIMAL"
    same(a, b)
    assert b.obj_val == pytest.approx(highs_general(lp2).fun, rel=1e-8)


def test_solve_standard_lp_and_warm_solution():
    lp = eq_lp(7)
    std_j = J_StandardLP(A=lp.A, b=lp.b, c=lp.c, u=lp.u)
    std_p = interop.instance_from_reference(std_j)
    assert type(std_p).__name__ == "StandardLP"
    same(J.solve_lp(std_j, method="barrier"),
         P.solve_lp(std_p, method="barrier"))
    x0 = np.full(lp.n, 0.5)
    a, b = both_lp(lp, "primal_simplex", warm_start_solution=(x0, None))
    same(a, b)


@pytest.mark.parametrize("method", ["barrier", "simplex"])
def test_solve_lp_certified_failures(method):
    """Infeasible and unbounded LPs (tests/test_rays.py): the same status
    and the same verifiable ray."""
    infeas = J_GeneralLP(A=np.array([[1.0, 1.0, 0.5], [1.0, 1.0, 0.5]]),
                         b=np.array([1.0, 4.0]), c=np.array([1.0, 2.0, 3.0]),
                         l=np.zeros(3), u=np.full(3, np.inf),
                         sense=np.array(["=", "="]))
    unb = J_GeneralLP(A=np.array([[1.0, -1.0, 0.0], [0.0, 1.0, -1.0]]),
                      b=np.zeros(2), c=np.array([-1.0, 0.0, 0.0]),
                      l=np.full(3, -np.inf), u=np.full(3, np.inf),
                      sense=np.array(["=", "="]))
    for lp, status in ((infeas, "INFEASIBLE"), (unb, "UNBOUNDED")):
        a, b = both_lp(lp, method)
        assert a.status == status
        same(a, b)


def test_bad_backend_and_method():
    lp = interop.instance_from_reference(eq_lp(1))
    with pytest.raises(ValueError, match="Unknown solver"):
        P.solve_lp(lp, solver="XYZ")
    with pytest.raises(ValueError, match="Invalid method"):
        P.solve_lp(lp, method="nope")


# --------------------------------------------------- LP first-order route
@pytest.mark.parametrize("mode", ["adaptive", "halpern"])
def test_solve_lp_first_order_cpu(mode):
    """PDHG on an all-equality dense LP, the port's plain chunk versions in
    float64 against the JAX package.  (The '<' LP drifts between the eager
    and jitted cores, ROADMAP section 3.)"""
    lp = eq_lp(0, m=12, n=40)
    settings = {"barrierTol": 1e-7, "fomMode": mode,
                "firstOrderMaxIters": 30_000}
    a, b = both_lp(lp, "first_order", settings, device="cpu")
    assert a.status == b.status == "OPTIMAL"
    assert b.obj_val == pytest.approx(a.obj_val, rel=1e-6)
    ref = highs_general(lp).fun
    for out in (a, b):
        assert abs(out.obj_val - ref) <= 1e-7 * abs(ref)


def test_first_order_default_device_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lp = interop.instance_from_reference(eq_lp(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.solve_lp(lp, method="first_order")


def test_first_order_sparse_route_raises():
    """A large sparse LP takes the JAX package's BCOO route (m n > 1e6,
    nnz < 0.1 m n), and the port's sparse route with it, densifying
    nothing: on the CPU both run the host scipy core, so the facades'
    answers match bit for bit (at barrierTol 1e-2, reached in 128
    iterations).  ``sparse=True`` keeps a small LP sparse in both packages
    too."""
    from smart_crossover_tpu.solvers.pdhg import (
        pdhg_general_lp as j_pdhg_general_lp,
    )
    from smart_crossover_tpu_torch.solvers.pdhg import pdhg_general_lp

    lp_j = random_sparse_lp(m=600, n=2400, seed=2)
    assert lp_j.m * lp_j.n > 1_000_000
    a, b = both_lp(lp_j, "first_order", {"barrierTol": 1e-2,
                                         "firstOrderMaxIters": 4000},
                   device="cpu")
    assert b.status == a.status == "OPTIMAL"
    assert b.bar_iter_count == a.bar_iter_count
    np.testing.assert_array_equal(b.x, a.x)
    np.testing.assert_array_equal(b.y, a.y)
    small = eq_lp(0)
    a = j_pdhg_general_lp(small, sparse=True, tol=1e-8)
    b = pdhg_general_lp(interop.instance_from_reference(small), sparse=True,
                        tol=1e-8, device="cpu")
    assert a.status == b.status == "OPTIMAL"
    np.testing.assert_array_equal(b.x, a.x)
    assert b.obj_val == pytest.approx(highs_general(small).fun, rel=1e-7)


# -------------------------------------------------------------------- MCF
@pytest.mark.parametrize("method, settings", [
    ("default", None), ("network_simplex", None), ("barrier", None),
    ("barrier", {"crossover": "off"})])
def test_solve_mcf(method, settings):
    mcf_j = transshipment_mcf(m=30, seed=1)
    mcf_p = interop.instance_from_reference(mcf_j)
    a = J.solve_mcf(mcf_j, method=method,
                    settings=J_Settings(**settings) if settings else None)
    b = P.solve_mcf(mcf_p, method=method,
                    settings=P_Settings(**settings) if settings else None)
    assert a.status == "OPTIMAL"
    same(a, b)
    if settings is None:
        ref = linprog(mcf_j.c, A_eq=mcf_j.A, b_eq=mcf_j.b,
                      bounds=np.stack([np.zeros(mcf_j.n), mcf_j.u], 1),
                      method="highs")
        assert b.obj_val == pytest.approx(ref.fun, rel=1e-8)


def first_order_mcf(crossover):
    """solve_mcf(method='first_order') in both packages on the CPU (the
    host scipy core in both), and HiGHS's objective."""
    mcf_j = transshipment_mcf(m=30, seed=1)
    mcf_p = interop.instance_from_reference(mcf_j)
    st = {"barrierTol": 1e-6, "firstOrderMaxIters": 20_000,
          "crossover": crossover}
    a = J.solve_mcf(mcf_j, method="first_order", settings=J_Settings(**st))
    b = P.solve_mcf(mcf_p, method="first_order", settings=P_Settings(**st),
                    device="cpu")
    assert a.status == b.status == "OPTIMAL"
    np.testing.assert_array_equal(b.x_bar, a.x_bar)
    assert b.bar_iter_count == a.bar_iter_count
    ref = linprog(mcf_j.c, A_eq=mcf_j.A, b_eq=mcf_j.b,
                  bounds=np.stack([np.zeros(mcf_j.n), mcf_j.u], 1),
                  method="highs").fun
    return a, b, ref


def test_solve_mcf_first_order_raises():
    """solve_mcf(method='first_order') with crossover on: PDHG on the
    sparse incidence matrix, then the network simplex; the interior point
    equal bit for bit, the vertex equal and at HiGHS's objective."""
    a, b, ref = first_order_mcf("on")
    same(a, b)
    assert b.obj_val == pytest.approx(ref, rel=1e-8)


def test_solve_mcf_first_order_interior_point():
    """With crossover off the first-order pair is the product (polished,
    as in the JAX package): equal bit for bit, near HiGHS's objective."""
    a, b, ref = first_order_mcf("off")
    assert b.x is not None and b.basis is None
    assert b.obj_val == a.obj_val
    assert b.obj_val == pytest.approx(ref, rel=1e-5)


# --------------------------------------------------------------------- OT
def ot_pair(seed, ns=8, nd=9):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, ns)
    d = rng.uniform(0.5, 2.0, nd)
    d *= s.sum() / d.sum()
    ot = J_OT(s=s, d=d, M=rng.uniform(0.0, 5.0, (ns, nd)))
    return ot, interop.instance_from_reference(ot)


def highs_ot(ot):
    mcf = ot.to_MCF()
    return linprog(mcf.c, A_eq=mcf.A.toarray(), b_eq=mcf.b,
                   bounds=[(0, None)] * mcf.n, method="highs").fun


def test_solve_ot_sinkhorn_cpu():
    ot_j, ot_p = ot_pair(0)
    st = {"sinkhornReg": 0.05, "firstOrderMaxIters": 2000}
    a = J.solve_ot(ot_j, method="sinkhorn", settings=J_Settings(**st))
    b = P.solve_ot(ot_p, method="sinkhorn", settings=P_Settings(**st),
                   device="cpu")
    assert a.status == b.status == "APPROXIMATE"
    np.testing.assert_allclose(b.x, a.x, rtol=0, atol=EXACT_RTOL)
    assert b.obj_val == pytest.approx(a.obj_val, rel=EXACT_RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_ot_device_simplex_mega_cpu(seed):
    """Engine 'mega' through the plain versions of K1 and K2: OPTIMAL, and
    equal to the JAX package's certified objective (its default engine)
    and to HiGHS's."""
    ot_j, ot_p = ot_pair(seed)
    a = J.solve_ot(ot_j, method="device_simplex",
                   settings=J_Settings(sinkhornReg=0.01))
    b = P.solve_ot(ot_p, method="device_simplex",
                   settings=P_Settings(sinkhornReg=0.01,
                                       deviceSimplexEngine="mega"),
                   device="cpu")
    assert a.status == b.status == "OPTIMAL"
    assert b.obj_val == pytest.approx(a.obj_val, rel=EXACT_RTOL)
    assert b.obj_val == pytest.approx(highs_ot(ot_j), rel=EXACT_RTOL)
    assert b.x.shape == (ot_j.M.size,)


def default_engine_case(seed):
    """The default deviceSimplexEngine, 'parent', as in the JAX package:
    OPTIMAL through K1's plain version and the parent-array engine, equal
    to the JAX package's certified objective and to HiGHS's."""
    ot_j, ot_p = ot_pair(seed)
    assert P_Settings().deviceSimplexEngine == "parent"
    a = J.solve_ot(ot_j, method="device_simplex",
                   settings=J_Settings(sinkhornReg=0.01))
    b = P.solve_ot(ot_p, method="device_simplex",
                   settings=P_Settings(sinkhornReg=0.01), device="cpu")
    assert a.status == b.status == "OPTIMAL"
    assert b.obj_val == pytest.approx(a.obj_val, rel=EXACT_RTOL)
    assert b.obj_val == pytest.approx(highs_ot(ot_j), rel=EXACT_RTOL)
    assert b.x.shape == (ot_j.M.size,)


def test_solve_ot_default_engine_raises():
    default_engine_case(0)


def test_solve_ot_device_simplex_default_engine_seed1():
    default_engine_case(1)


def test_solve_ot_network_simplex():
    ot_j, ot_p = ot_pair(2)
    a = J.solve_ot(ot_j, method="network_simplex")
    b = P.solve_ot(ot_p, method="network_simplex")
    same(a, b)
    assert b.obj_val == pytest.approx(highs_ot(ot_j), rel=EXACT_RTOL)
