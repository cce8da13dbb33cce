"""Parity of the port's Sinkhorn stages with the JAX package (CPU, f64).

The JAX side runs under conftest's x64; the fused TPU kernel runs in
interpret mode, as tests/test_pallas.py runs it.
"""
import importlib

import numpy as np
import pytest
import torch

from smart_crossover_tpu import parameters as jparams
from smart_crossover_tpu.ops.sinkhorn_pallas import sinkhorn_plan_pallas
from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch import parameters as tparams
from smart_crossover_tpu_torch.ops.sinkhorn_fused import (
    sinkhorn_plan_fused,
    sinkhorn_plan_fused_plain,
)
from smart_crossover_tpu_torch.solvers import sinkhorn as tsk

# the JAX package's solvers/__init__ re-exports a function named sinkhorn
jsk = importlib.import_module("smart_crossover_tpu.solvers.sinkhorn")

SHAPES = [(2, 13, 29), (3, 24, 40), (2, 48, 24)]


def _batch(B, S, D, seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(1) / d.sum(1))[:, None]
    M = rng.uniform(0.0, 5.0, (B, S, D))
    return s, d, M


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_parameters_equal():
    assert tparams.TOLERANCE_FOR_ARTIFICIAL_VARS == \
        jparams.TOLERANCE_FOR_ARTIFICIAL_VARS
    assert tparams.TOLERANCE_FOR_REDUCED_COSTS == \
        jparams.TOLERANCE_FOR_REDUCED_COSTS


@pytest.mark.parametrize("shape", SHAPES)
def test_potentials_and_plan_match_jax(shape):
    """f, g and the rounded plan agree with the JAX package to abs 1e-10;
    the port batches, JAX runs per instance."""
    s, d, M = _batch(*shape, seed=1)
    reg = 0.3
    ts, td, tM = _t(s, d, M)
    f, g = tsk.sinkhorn_potentials(ts, td, tM, reg, num_iters=150)
    X = tsk.sinkhorn_plan(ts, td, tM, reg, num_iters=150)
    for b in range(shape[0]):
        jf, jg = jsk.sinkhorn_potentials(s[b], d[b], M[b], reg, num_iters=150)
        np.testing.assert_allclose(f[b].numpy(), np.asarray(jf), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(g[b].numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-10)
        jX = jsk.sinkhorn_plan(s[b], d[b], M[b], reg, num_iters=150)
        np.testing.assert_allclose(X[b].numpy(), np.asarray(jX), rtol=0,
                                   atol=1e-10)


def test_per_instance_reg_and_rounding_match_jax():
    """A (B,) regularisation vector gives each instance its own eps, and the
    rounded plan has exact marginals."""
    s, d, M = _batch(3, 13, 29, seed=2)
    regs = np.array([0.2, 0.5, 1.0])
    ts, td, tM = _t(s, d, M)
    f, g = tsk.sinkhorn_potentials(ts, td, tM, torch.from_numpy(regs), 80)
    P = tsk.plan_from_potentials(f, g, tM, torch.from_numpy(regs))
    R = tsk.round_to_feasible(P, ts, td)
    for b in range(3):
        jf, jg = jsk.sinkhorn_potentials(s[b], d[b], M[b], regs[b], 80)
        jP = jsk.plan_from_potentials(jf, jg, M[b], regs[b])
        jR = jsk.round_to_feasible(jP, s[b], d[b])
        np.testing.assert_allclose(P[b].numpy(), np.asarray(jP), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(R[b].numpy(), np.asarray(jR), rtol=0,
                                   atol=1e-10)
    np.testing.assert_allclose(R.sum(2).numpy(), s, atol=1e-12)
    np.testing.assert_allclose(R.sum(1).numpy(), d, atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_plain_matches_pallas_interpret(shape):
    """The fused kernel's plain version against the TPU kernel run in
    interpret mode (x64): plan rtol 1e-9.  Its potentials agree with the
    XLA Sinkhorn's to abs 1e-9."""
    s, d, M = _batch(*shape, seed=3)
    reg = 0.4
    want = np.asarray(sinkhorn_plan_pallas(s, d, M, reg, num_iters=120))
    plan, f, g = sinkhorn_plan_fused_plain(*_t(s, d, M), reg, 120)
    np.testing.assert_allclose(plan.numpy(), want, rtol=1e-9, atol=1e-300)
    for b in range(shape[0]):
        jf, jg = jsk.sinkhorn_potentials(s[b], d[b], M[b], reg, 120)
        np.testing.assert_allclose(f[b].numpy(), np.asarray(jf), atol=1e-9)
        np.testing.assert_allclose(g[b].numpy(), np.asarray(jg), atol=1e-9)


def test_fused_folded_eps_matches_pallas_route():
    """The pipeline's call: eps = reg * max(M_b) folded into M, kernel at
    reg = 1, as the JAX package's batched_tnet(use_pallas=True) calls it."""
    s, d, M = _batch(2, 13, 29, seed=4)
    eps = 0.05 * M.max(axis=(1, 2))
    Mn = M / eps[:, None, None]
    want = np.asarray(sinkhorn_plan_pallas(s, d, Mn, 1.0, num_iters=200))
    plan, _, _ = sinkhorn_plan_fused(*_t(s, d, Mn), 1.0, 200)
    np.testing.assert_allclose(plan.numpy(), want, rtol=1e-9, atol=1e-300)


def test_fused_wrapper_cpu_uses_plain_and_counts_nothing():
    s, d, M = _t(*_batch(2, 13, 29, seed=5))
    _build.reset_kernel_launch_counts()
    got = sinkhorn_plan_fused(s, d, M, 0.5, 30)
    want = sinkhorn_plan_fused_plain(s, d, M, 0.5, 30)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert _build.kernel_launch_counts() == {"sinkhorn_fused": 0,
                                             "transport_simplex_mega": 0}


def test_fused_wrapper_rejects_other_devices():
    s, d, M = (t.to("meta") for t in _t(*_batch(1, 8, 8, seed=6)))
    with pytest.raises(ValueError, match="no kernel"):
        sinkhorn_plan_fused(s, d, M, 1.0, 3)
