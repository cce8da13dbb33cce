"""The port's device projector, ``apply_projector_torch``, against the JAX
package's ``apply_projector_jax`` (float64, ``jax_enable_x64``) and the
host ``apply_projector``, on the CPU in float64.

Both device projectors run CG on Y Y' with the stopping rule of
``jax.scipy.sparse.linalg.cg`` (residual relative to ||Y v||, atol 0); the
port checks that rule once per block of iterations and masks a stopped
lane's update, which must end at the same iteration as a check after every
iteration.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from smart_crossover_tpu.solvers.projection import (
    apply_projector as j_apply_projector,
)
from smart_crossover_tpu.solvers.projection import apply_projector_jax
from smart_crossover_tpu_torch.solvers.projection import (
    _cg_normal,
    apply_projector,
    apply_projector_torch,
)

REL = 1e-10


def dense_case(seed, m=20, n=60, scale_cols=False):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((m, n))
    if scale_cols:
        # Y = A diag(x) with x spread over decades, as get_projector_Xc forms
        Y = Y * 10.0 ** rng.uniform(-2, 0, n)[None, :]
    return Y, rng.standard_normal(n)


CASES = [(0, False), (1, True), (2, True), (3, True)]


@pytest.mark.parametrize("seed, scale", CASES)
def test_matches_jax_and_host(seed, scale):
    """At a tight CG tolerance both device projectors reach the projection
    to ~1e-13 and must agree to 1e-10; the host CG lands in null(Y) too."""
    Y, v = dense_case(seed, scale_cols=scale)
    pt = apply_projector_torch(Y, v, tol=1e-12, device="cpu")
    assert pt.dtype == torch.float64 and pt.device.type == "cpu"
    pt = pt.numpy()
    pj = np.asarray(apply_projector_jax(Y, v, tol=1e-12))
    assert pj.dtype == np.float64
    scale_v = np.linalg.norm(pj)
    assert np.linalg.norm(pt - pj) <= REL * scale_v
    ph = apply_projector(Y, v)
    np.testing.assert_array_equal(ph, j_apply_projector(Y, v))
    assert np.linalg.norm(pt - ph) <= 1e-6 * scale_v


@pytest.mark.parametrize("seed, scale", CASES)
def test_default_tol_stops_where_jax_stops(seed, scale):
    """At the default tolerance (1e-8) the port stops at JAX's iteration:
    JAX capped at the port's count k gives its own result, capped at k - 1
    another.  The iterates there differ by the summation order of the
    products (up to ~3e-9 relative once CG runs past m iterations), so
    they are held to 1e-6."""
    Y, v = dense_case(seed, scale_cols=scale)
    Yt, vt = torch.tensor(Y), torch.tensor(v)
    _, k = _cg_normal(Yt, Yt @ vt, 1e-8, 1000)
    k = int(k)
    pj = np.asarray(apply_projector_jax(Y, v))
    np.testing.assert_array_equal(
        np.asarray(apply_projector_jax(Y, v, max_iter=k)), pj)
    assert not np.array_equal(
        np.asarray(apply_projector_jax(Y, v, max_iter=k - 1)), pj)
    pt = apply_projector_torch(Y, v, device="cpu").numpy()
    assert np.linalg.norm(pt - pj) <= 1e-6 * np.linalg.norm(pj)


@pytest.mark.parametrize("tol", [1e-8, 1e-5])
def test_residual_below_cg_tolerance(tol):
    Y, v = dense_case(3, scale_cols=True)
    p = apply_projector_torch(Y, v, tol=tol, device="cpu").numpy()
    assert np.linalg.norm(Y @ p) <= tol * np.linalg.norm(Y @ v) * (1 + 1e-9)


@pytest.mark.parametrize("block", [2, 7, 32])
def test_masked_blocks_stop_at_the_same_iteration(block):
    """A batch of three lanes that converge at different iterations: each
    lane's iterate and iteration count equal those of a check after every
    iteration (block = 1)."""
    rng = np.random.default_rng(4)
    Y = torch.tensor(rng.standard_normal((3, 15, 40)))
    Y[1] *= torch.tensor(10.0 ** rng.uniform(-3, 0, 40))
    Y[2, :, :20] *= 1e-2
    rhs = torch.tensor(rng.standard_normal((3, 15)))
    z1, k1 = _cg_normal(Y, rhs, 1e-10, 1000, block=1)
    zb, kb = _cg_normal(Y, rhs, 1e-10, 1000, block=block)
    assert len(set(k1.tolist())) == 3       # the lanes stop apart
    assert torch.equal(k1, kb)
    assert torch.equal(z1, zb)
    # each lane as its own single system stops at the same iteration (its
    # products take another summation order than the batched ones)
    for i in range(3):
        zi, ki = _cg_normal(Y[i], rhs[i], 1e-10, 1000, block=1)
        assert int(ki) == int(k1[i])
        assert torch.linalg.norm(zi - z1[i]) <= 1e-6 * torch.linalg.norm(zi)


def test_max_iter_caps_each_lane():
    Y, v = dense_case(5, scale_cols=True)
    Yt, vt = torch.tensor(Y), torch.tensor(v)
    _, k = _cg_normal(Yt, Yt @ vt, 1e-300, 9, block=4)
    assert int(k) == 9


def test_sparse_y_and_default_device():
    Y, v = dense_case(6)
    with pytest.raises(TypeError, match="dense Y"):
        apply_projector_torch(sp.csr_matrix(Y), v, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            apply_projector_torch(Y, v)
