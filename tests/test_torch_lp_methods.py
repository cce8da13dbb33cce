"""The port's perturbation crossover, ``run_perturb_algorithm``, against the
JAX package's, on the LPs of the JAX package's tests/test_lp_methods.py.

The crossover runs on the host (barrier, projectors, simplex) in both
packages, so the status, x, the basis and the pivot count must be equal
bit for bit; the objective must equal HiGHS's to 1e-8 relative.
"""
import numpy as np
import pytest
import scipy.sparse as sp

from smart_crossover_tpu.lp_methods import algorithms as J_alg
from smart_crossover_tpu.models import GeneralLP as J_GeneralLP
from smart_crossover_tpu.models import OptTransport
from smart_crossover_tpu_torch import interop
from smart_crossover_tpu_torch.lp_methods import algorithms as P_alg
from tests.test_lp_methods import highs_on_general, random_general_lp
from tests.test_torch_network_simplex import same_native_core  # noqa: F401

# the JAX side's network simplex runs the port's C++ core
pytestmark = pytest.mark.usefixtures("same_native_core")

OBJ_RTOL = 1e-8


def run_both(lp_j):
    lp_p = interop.instance_from_reference(lp_j)
    a = J_alg.run_perturb_algorithm(lp_j)
    b = P_alg.run_perturb_algorithm(lp_p)
    assert a.status == b.status == "OPTIMAL"
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.x_bar, b.x_bar)
    np.testing.assert_array_equal(a.basis.vbasis, b.basis.vbasis)
    np.testing.assert_array_equal(a.basis.cbasis, b.basis.cbasis)
    assert a.iter_count == b.iter_count
    assert a.bar_iter_count == b.bar_iter_count
    assert a.obj_val == b.obj_val
    ref = highs_on_general(lp_j)
    assert b.obj_val == pytest.approx(ref.fun, rel=OBJ_RTOL)
    return b


@pytest.mark.parametrize("seed", [0, 1])
def test_equality_lp(seed):
    rng = np.random.default_rng(seed)
    run_both(random_general_lp(rng, m=8, n=20, frac_ineq=0.0))


@pytest.mark.parametrize("seed", [3, 4])
def test_with_inequalities(seed):
    rng = np.random.default_rng(seed)
    run_both(random_general_lp(rng, m=10, n=24, frac_ineq=0.5))


def test_with_free_vars():
    rng = np.random.default_rng(9)
    lp = random_general_lp(rng, m=8, n=18, frac_ineq=0.3, with_free=True)
    assert np.isinf(lp.l).any()
    run_both(lp)


def test_degenerate_assignment():
    rng = np.random.default_rng(0)
    k = 8
    ot = OptTransport(s=np.ones(k), d=np.ones(k),
                      M=rng.integers(1, 5, (k, k)).astype(float))
    mcf = ot.to_MCF()
    lp = J_GeneralLP(A=sp.csr_matrix(mcf.A), b=mcf.b, c=mcf.c,
                     l=np.zeros(mcf.n), u=np.full(mcf.n, np.inf),
                     sense=np.full(mcf.m, "="))
    run_both(lp)


def test_feasibility_problem_branch():
    rng = np.random.default_rng(42)
    m, n = 6, 14
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    y0 = rng.standard_normal(m)
    lp = J_GeneralLP(A=A, b=b, c=A.T @ y0, l=np.zeros(n), u=np.ones(n),
                     sense=np.full(m, "="))
    lp_p = interop.instance_from_reference(lp)
    assert J_alg.check_feasibility_problem(lp)
    assert P_alg.check_feasibility_problem(lp_p)
    run_both(lp)


@pytest.mark.parametrize("is_feas", [False, True])
def test_perturb_c(is_feas):
    """The seeded perturbation (RandomState(42)) and its projector scale."""
    rng = np.random.default_rng(5)
    lp = random_general_lp(rng, m=5, n=12, with_free=True)
    x = rng.uniform(0.3, 0.7, 12)
    np.testing.assert_array_equal(
        J_alg.perturb_c(lp, x, is_feas),
        P_alg.perturb_c(interop.instance_from_reference(lp), x, is_feas))
