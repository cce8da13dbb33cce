"""The port's fleet PDHG and fleet LP crossover against the JAX package's
(CPU, f64), and against HiGHS."""
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from smart_crossover_tpu.parallel.batched_lp import (
    batched_lp_crossover as j_crossover,
)
from smart_crossover_tpu.solvers import pdhg_batched as jpb
from smart_crossover_tpu_torch import batched_lp_crossover, pdhg_dense_batched
from smart_crossover_tpu_torch.solvers import pdhg_batched as tpb


def make_fleet(rng, B=4, m=12, n=64):
    """As tests/test_pdhg_batched.py::make_fleet."""
    A = rng.standard_normal((B, m, n))
    b = np.einsum("bmn,bn->bm", A, rng.uniform(0.1, 0.9, (B, n)))
    c = rng.standard_normal((B, n))
    return A, b, c, np.zeros((B, n)), np.ones((B, n))


def test_opnorms_match_jax(rng):
    A = rng.standard_normal((5, 16, 40))
    want = np.asarray(jpb._opnorms(A))
    got = tpb._opnorms(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_pdhg_dense_batched_matches_jax(rng, use_pallas):
    """4 x 16 x 128: the port's plain version against the JAX package's
    Pallas kernel (interpret mode) and its vmapped XLA oracle, as
    tests/test_pdhg_batched.py:26-36 holds those two, at 40 iterations
    rather than 50: on this fleet reduction-order differences grow ~150x
    from iteration 40 to 50 (to 1.3e-9 against XLA, where the JAX
    package's own two paths reach 4.3e-10), and a shorter horizon keeps
    the tolerance."""
    A, b, c, l, u = make_fleet(rng, 4, 16, 128)
    want = jpb.pdhg_dense_batched(A, b, c, l, u, iters=40,
                                  use_pallas=use_pallas)
    got = pdhg_dense_batched(A, b, c, l, u, iters=40, device="cpu")
    for k in ("x", "y", "x_avg", "y_avg"):
        assert got[k].dtype == torch.float64
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got["opnorm"], want["opnorm"], rtol=1e-12)


def test_batched_lp_crossover_matches_jax_and_highs(rng):
    """warm_engine='pdhg' at 4 x 10 x 40 and 4000 iterations: every
    instance optimal on both sides, objectives equal to 1e-8 and equal to
    HiGHS's."""
    B, m, n = 4, 10, 40
    A, b, c, l, u = make_fleet(rng, B, m, n)
    out = batched_lp_crossover(A, b, c, l, u, warm_engine="pdhg",
                               pdhg_iters=4000, device="cpu")
    jout = j_crossover(A, b, c, l, u, warm_engine="pdhg", pdhg_iters=4000)
    assert out["optimal"].all() and np.asarray(jout["optimal"]).all()
    np.testing.assert_allclose(out["obj"], jout["obj"], rtol=0, atol=1e-8)
    for i in range(B):
        ref = linprog(c[i], A_eq=A[i], b_eq=b[i], bounds=[(0, 1)] * n,
                      method="highs")
        assert out["obj"][i] == pytest.approx(ref.fun, abs=1e-8)
        np.testing.assert_allclose(A[i] @ out["x"][i], b[i], atol=1e-8)
    assert out["x_bar"].shape == (B, n) and out["pivots"].shape == (B,)
    assert out["warm_seconds"] >= 0 and out["crossover_seconds"] >= 0


def test_batched_lp_crossover_takes_tensors(rng):
    A, b, c, l, u = make_fleet(rng, 2, 6, 20)
    a = batched_lp_crossover(A, b, c, l, u, warm_engine="pdhg",
                             pdhg_iters=500, device="cpu")
    t = batched_lp_crossover(*(torch.from_numpy(v) for v in (A, b, c, l, u)),
                             warm_engine="pdhg", pdhg_iters=500)
    np.testing.assert_array_equal(a["x_bar"], t["x_bar"])
    np.testing.assert_array_equal(a["obj"], t["obj"])


def test_pdhg_dense_batched_refuses_other_devices():
    A = torch.zeros(1, 2, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pdhg_dense_batched(A, torch.zeros(1, 2, device="meta"),
                           *(torch.zeros(1, 3, device="meta")
                             for _ in range(3)), iters=1)
