"""The mega transportation simplex's plain version (float32) against the
JAX package's mega kernel run in interpret mode, from identical state:
same pivot count, same optimal flag, same final basis mask, objective
rtol 1e-5.  The JAX side pads to 128 with pad leaves; the port does not,
and the pivot rule makes both walk the same pivots."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_crossover_tpu.ops.transport_simplex_anc import (
    _tree_cells as j_tree_cells,
    build_ancestor_matrix as j_anc,
)
from smart_crossover_tpu.ops.transport_simplex_mega import (
    batched_transport_simplex_mega as j_mega,
    transport_simplex_mega as j_mega_single,
)
from smart_crossover_tpu.ops.transport_simplex_parent import (
    build_parent_from_mask as j_parent,
)
from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch.interop import from_reference
from smart_crossover_tpu_torch.ops.transport_simplex_mega import (
    batched_transport_simplex_mega,
    mega_setup,
    transport_simplex_mega,
    transport_simplex_mega_plain,
    transport_simplex_mega_state,
)


def _nw_corner(S, D, seed):
    """Northwest-corner basic feasible plan, its spanning basis mask and
    uniform costs (as tests/test_transport_simplex_mega.py builds them)."""
    rng = np.random.default_rng(seed)
    M = rng.uniform(0, 1, (S, D)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, S)
    s /= s.sum()
    d = rng.uniform(0.5, 1.5, D)
    d /= d.sum()
    X = np.zeros((S, D), np.float32)
    Bm = np.zeros((S, D), bool)
    si, dj = s.copy(), d.copy()
    i = j = 0
    while i < S and j < D:
        t = min(si[i], dj[j])
        X[i, j] = t
        Bm[i, j] = True
        si[i] -= t
        dj[j] -= t
        if si[i] <= 1e-15 and i < S - 1:
            i += 1
        elif dj[j] <= 1e-15 and j < D - 1:
            j += 1
        else:
            break
    assert Bm.sum() == S + D - 1
    return X, Bm, M


def _batch(S, D, B=3, seed0=0):
    parts = [_nw_corner(S, D, seed0 + k) for k in range(B)]
    return [np.stack([p[i] for p in parts]) for i in range(3)]


@pytest.mark.parametrize("shape,refresh", [((13, 29), 128), ((24, 40), 16),
                                           ((48, 24), 128)])
def test_plain_matches_jax_mega(shape, refresh):
    X, Bm, M = _batch(*shape)
    jX, jB, jp, jo = j_mega(X, Bm, M, max_pivots=2000, refresh=refresh)
    ref = from_reference(X0=X, Bm=Bm, M=M)
    tX, tB, tp, to = batched_transport_simplex_mega(
        ref["X0"], ref["Bm"], ref["M"], max_pivots=2000, refresh=refresh)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    assert to.all() and (tp > 0).all()
    assert tX.dtype == torch.float32
    obj_t = (tX.numpy().astype(np.float64) * M).sum((1, 2))
    obj_j = (np.asarray(jX, np.float64) * M).sum((1, 2))
    np.testing.assert_allclose(obj_t, obj_j, rtol=1e-5)


def test_pivot_cap_matches_jax_mega():
    """Stopped by max_pivots: the same count and optimal = False."""
    X, Bm, M = _batch(24, 40, B=2, seed0=7)
    jX, jB, jp, jo = j_mega(X, Bm, M, max_pivots=9, refresh=4)
    tX, tB, tp, to = batched_transport_simplex_mega(
        *(torch.from_numpy(a) for a in (X, Bm, M)), max_pivots=9, refresh=4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    assert not to.any() and (tp == 9).all()


@pytest.mark.parametrize("shape", [(13, 29), (48, 24)])
def test_setup_state_equals_jax(shape):
    """parent, N, dep, w and Xv from the port's setup equal the JAX
    package's setup helpers on the same (unpadded) basis."""
    X, Bm, M = _batch(*shape, B=2, seed0=3)
    st = mega_setup(*(torch.from_numpy(a) for a in (X, Bm, M)))
    S, D = shape
    for b in range(2):
        jp = j_parent(jnp.asarray(Bm[b]))
        jN = np.asarray(j_anc(jp, jnp.float32))
        ci, cj, nr = (np.asarray(a) for a in j_tree_cells(jp, S, D))
        np.testing.assert_array_equal(st["parent"][b].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(st["N"][b].numpy(), jN)
        np.testing.assert_array_equal(st["dep"][b].numpy(), jN.sum(1) - 1)
        np.testing.assert_array_equal(st["w"][b].numpy(),
                                      np.where(nr, M[b][ci, cj % D], 0))
        np.testing.assert_array_equal(st["Xv"][b].numpy(),
                                      np.where(nr, X[b][ci, cj % D], 0))


def test_wrapper_cpu_takes_plain_version():
    X, Bm, M = _batch(13, 29, B=2, seed0=5)
    st = mega_setup(*(torch.from_numpy(a) for a in (X, Bm, M)))
    _build.reset_kernel_launch_counts()
    got = transport_simplex_mega_state(st, max_pivots=500)
    want = transport_simplex_mega_plain(st, max_pivots=500)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert _build.kernel_launch_counts()["transport_simplex_mega"] == 0
    # the state handed in is left untouched
    assert torch.equal(st["mask"], torch.from_numpy(Bm))


def _marginals(X):
    return X.sum(-1).astype(np.float64), X.sum(-2).astype(np.float64)


def test_jax_positional_order():
    """ROADMAP 3.8: the JAX positional order (X, Bm, M, s, d) on a 6x6
    northwest-corner basis, batched and single-instance, gives the JAX
    package's pivots, basis and plan."""
    X, Bm, M = _batch(6, 6, B=2, seed0=11)
    s, d = _marginals(X)
    jX, jB, jp, jo = j_mega(X, Bm, M, s, d)
    tX, tB, tp, to = batched_transport_simplex_mega(
        *(torch.from_numpy(a) for a in (X, Bm, M, s, d)))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
    assert to.all() and np.asarray(jo).all()
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), atol=1e-6)
    one = transport_simplex_mega(*(torch.from_numpy(a[0])
                                   for a in (X, Bm, M, s, d)))
    want = j_mega_single(X[0], Bm[0], M[0], s[0], d[0])
    assert int(one[2]) == int(want[2]) and bool(one[3])
    np.testing.assert_array_equal(one[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(one[0].numpy(), np.asarray(want[0]),
                               atol=1e-6)
