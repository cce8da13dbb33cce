"""The port's host copies of the revised simplex and of the crossover
start statuses against the originals: the same numpy code, so the
results must be bit for bit equal."""
import numpy as np
import pytest

from smart_crossover_tpu.solvers import simplex as js
from smart_crossover_tpu.solvers.solving import (
    _crossover_statuses as j_statuses,
)
from smart_crossover_tpu_torch.solvers import simplex as ts
from smart_crossover_tpu_torch.solvers.solving import _crossover_statuses


def _lp(seed):
    """A feasible LP with box and infinite bounds, and a nearby interior
    point standing in for a first-order warm start."""
    rng = np.random.default_rng(seed)
    m, n = 8 + 2 * seed, 24 + 4 * seed
    A = rng.standard_normal((m, n))
    x_feas = rng.uniform(0.2, 0.8, n)
    b = A @ x_feas
    c = rng.standard_normal(n)
    l, u = np.zeros(n), np.ones(n)
    u[:3] = np.inf                    # a few columns bounded below only
    x_near = np.clip(x_feas + 1e-9 * rng.standard_normal(n), l, u)
    x_near[3:6] = l[3:6] + 1e-10      # hugging bounds
    x_near[6:8] = u[6:8] - 1e-10
    return A, b, c, l, u, x_near


def _same(got, want):
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.vstatus, want.vstatus)
    assert got.obj_val == want.obj_val
    assert got.iter_count == want.iter_count
    assert got.status == want.status


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_primal_simplex_cold_and_warm_identical(seed):
    A, b, c, l, u, x_near = _lp(seed)
    _same(ts.primal_simplex(A, b, c, l, u), js.primal_simplex(A, b, c, l, u))
    vst = _crossover_statuses(x_near, l, u)
    np.testing.assert_array_equal(vst, j_statuses(x_near, l, u))
    got = ts.primal_simplex(A, b, c, l, u, vstatus=vst)
    _same(got, js.primal_simplex(A, b, c, l, u, vstatus=vst))
    assert got.status == "OPTIMAL"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dual_simplex_from_dual_feasible_basis_identical(seed):
    """An optimal basis stays dual feasible after a change of b: the dual
    simplex's own start."""
    A, b, c, l, u, _ = _lp(seed)
    base = ts.primal_simplex(A, b, c, l, u)
    b2 = b + 0.02
    got = ts.dual_simplex(A, b2, c, l, u, vstatus=base.vstatus)
    _same(got, js.dual_simplex(A, b2, c, l, u, vstatus=base.vstatus))
    assert got.fallback is False


@pytest.mark.parametrize("ctol", [1e-7, 1e-3])
def test_crossover_statuses_identical(ctol):
    rng = np.random.default_rng(5)
    n = 200
    l = np.where(rng.random(n) < 0.2, -np.inf, 0.0)
    u = np.where(rng.random(n) < 0.2, np.inf, 1.0)
    x = np.clip(rng.choice([0.0, 1.0, 0.5], n)
                + rng.choice([0.0, 1e-9, -1e-9, 1e-4], n), -5.0, 5.0)
    got = _crossover_statuses(x, l, u, ctol)
    np.testing.assert_array_equal(got, j_statuses(x, l, u, ctol))
    assert got.dtype == np.int8
    assert set(np.unique(got)) <= {ts.ST_BASIC, ts.ST_LOWER, ts.ST_UPPER}
