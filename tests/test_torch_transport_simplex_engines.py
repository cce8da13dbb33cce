"""The port's device pivot engines ('mask', 'parent', 'anc', 'packed')
against the JAX package's, from identical state, in float64 (the dtype of
the JAX package's own engine tests).

Both packages run the same pivot rule (Dantzig pricing with the lowest
flat index on ties, the lowest node id among the ratio-test ties), so
every instance must take the same number of pivots, end with the same
optimal flag and the same basis mask, and reach the same objective
(rtol 1e-9).  The port pivots the batch in lockstep, so the batched runs
also hold each instance to the JAX package's own run of it.  The starts
are those of tests/test_transport_simplex{,_parent,_anc,_packed}.py: the
northwest corner, a TNET warm start, and degenerate ties with integer
costs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from smart_crossover_tpu.network_methods.tree_bi import (
    identify_tree_flows as j_identify_tree_flows,
)
from smart_crossover_tpu.ops import transport_simplex as j_mask
from smart_crossover_tpu.ops import transport_simplex_anc as j_anc
from smart_crossover_tpu.ops import transport_simplex_packed as j_packed
from smart_crossover_tpu.ops import transport_simplex_parent as j_parent
from smart_crossover_tpu.ops.mst import boruvka_bipartite_mst as j_mst
from smart_crossover_tpu.ops.ranking import (
    ot_flow_indicators as j_ot_flow_indicators,
)
from smart_crossover_tpu.parallel import batched as jb
from smart_crossover_tpu_torch import certify_ot_basis_batch
from smart_crossover_tpu_torch.ops import transport_simplex as p_mask
from smart_crossover_tpu_torch.ops import transport_simplex_anc as p_anc
from smart_crossover_tpu_torch.ops import transport_simplex_packed as p_packed
from smart_crossover_tpu_torch.ops import transport_simplex_parent as p_parent
from tests.test_transport_simplex import northwest_corner_basis

OBJ_RTOL = 1e-9
_tnet_single = jax.jit(lambda s, d, M: jb.tnet_single(s, d, M, 0.01, 300))
ENGINES = ("mask", "parent", "anc", "packed")
JAX_BATCHED = {"mask": j_mask.batched_transport_simplex,
               "parent": j_parent.batched_transport_simplex_parent,
               "anc": j_anc.batched_transport_simplex_anc,
               "packed": j_packed.batched_transport_simplex_packed}
PORT_BATCHED = {"mask": p_mask.batched_transport_simplex,
                "parent": p_parent.batched_transport_simplex_parent,
                "anc": p_anc.batched_transport_simplex_anc,
                "packed": p_packed.batched_transport_simplex_packed}


def random_ot(seed, S, D):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, S)
    d = rng.uniform(0.5, 2.0, D)
    d *= s.sum() / d.sum()
    return s, d, rng.uniform(0.0, 5.0, (S, D))


def nw_batch(instances):
    """Northwest-corner starts of (s, d, M) instances of one shape."""
    starts = [northwest_corner_basis(s, d) for s, d, _ in instances]
    return (np.stack([x for x, _ in starts]),
            np.stack([bm for _, bm in starts]),
            np.stack([M for _, _, M in instances]))


def highs(s, d, M):
    S, D = M.shape
    A = np.zeros((S + D, S * D))
    for a in range(S * D):
        A[a // D, a] = 1
        A[S + a % D, a] = 1
    r = linprog(M.ravel(), A_eq=A, b_eq=np.concatenate([s, d]),
                bounds=[(0, None)] * (S * D), method="highs")
    assert r.status == 0
    return r.fun


def port_run(engine, X, Bm, M, **kw):
    out = PORT_BATCHED[engine](*(torch.from_numpy(np.asarray(a))
                                 for a in (X, Bm, M)), **kw)
    return [o.numpy() for o in out]


def assert_same(jout, pout, M):
    jX, jB, jp, jo = (np.asarray(a) for a in jout)
    pX, pB, pp, po = pout
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_array_equal(pB, jB)
    np.testing.assert_allclose((pX * M).sum((-2, -1)),
                               (jX * M).sum((-2, -1)), rtol=OBJ_RTOL)


def jax_batched(engine, X, Bm, M, max_pivots):
    s, d = X.sum(2), X.sum(1)
    return JAX_BATCHED[engine](X, Bm, M, s, d, 1e-7, max_pivots)


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_matches_jax_from_nw_corner(engine):
    """Four instances of one shape, pivoted in one lockstep batch, against
    the JAX package's vmapped engine; then HiGHS."""
    inst = [random_ot(100 + i, 9, 11) for i in range(4)]
    X, Bm, M = nw_batch(inst)
    pout = port_run(engine, X, Bm, M, max_pivots=2000)
    assert_same(jax_batched(engine, X, Bm, M, 2000), pout, M)
    assert pout[3].all() and (pout[2] > 0).all()
    for i, (s, d, Mi) in enumerate(inst):
        assert (pout[0][i] * Mi).sum() == pytest.approx(highs(s, d, Mi),
                                                        rel=1e-9)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_matches_jax_random_shapes(engine, seed):
    """tests/test_transport_simplex.py's random shapes, one instance."""
    rng = np.random.default_rng(seed)
    S, D = int(rng.integers(4, 14)), int(rng.integers(4, 14))
    X, Bm, M = nw_batch([random_ot(seed, S, D)])
    assert_same(jax_batched(engine, X, Bm, M, 2000),
                port_run(engine, X, Bm, M, max_pivots=2000), M)


@functools.lru_cache(maxsize=None)
def tnet_start(seed, S, D):
    """The JAX package's TNET warm start (tnet_single, then Borůvka over
    the support), as batched_tnet_exact_device builds it; read only."""
    s, d, M = random_ot(seed, S, D)
    X0, _, _ = _tnet_single(jnp.asarray(s), jnp.asarray(d), jnp.asarray(M))
    X0 = np.asarray(X0)
    Bm0 = np.asarray(j_mst((X0 > 1e-12).astype(np.float64)))
    assert Bm0.sum() == S + D - 1
    return X0, Bm0, M


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_matches_jax_from_tnet_warm_start(engine):
    starts = [tnet_start(50 + i, 10, 12) for i in range(3)]
    X, Bm, M = (np.stack([st[k] for st in starts]) for k in range(3))
    pout = port_run(engine, X, Bm, M, max_pivots=2000)
    assert_same(jax_batched(engine, X, Bm, M, 2000), pout, M)
    assert pout[3].all()


def integer_ties(seed, S, D, supply, lo, hi):
    """Equal supplies and small-integer costs: massively tied pricing and
    degenerate ratio tests, from the northwest corner."""
    rng = np.random.default_rng(seed)
    s = np.full(S, float(supply))
    d = np.full(D, supply * S / D)
    M = rng.integers(lo, hi, (S, D)).astype(np.float64)
    return s, d, M


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", ["unit_7x7", "twos_8x8", "fours_12x16"])
def test_engine_matches_jax_degenerate_ties(engine, case):
    S, D, supply, lo, hi = {"unit_7x7": (7, 7, 1, 1, 4),
                            "twos_8x8": (8, 8, 2, 1, 6),
                            "fours_12x16": (12, 16, 4, 0, 4)}[case]
    inst = [integer_ties(seed, S, D, supply, lo, hi) for seed in (3, 4)]
    X, Bm, M = nw_batch(inst)
    pout = port_run(engine, X, Bm, M, max_pivots=3000)
    assert_same(jax_batched(engine, X, Bm, M, 3000), pout, M)
    for i, (s, d, Mi) in enumerate(inst):
        assert pout[3][i]
        assert (pout[0][i] * Mi).sum() == pytest.approx(highs(s, d, Mi),
                                                        abs=1e-7)


def test_parent_engine_integer_costs_from_indicator_start():
    """tests/test_transport_simplex_parent.py's tie case: a start from the
    uniform plan's flow indicators, costs in 0..3."""
    for seed in range(2):
        s, d, M = integer_ties(seed, 12, 16, 4, 0, 4)
        X0 = np.outer(s, d) / s.sum()
        W = np.asarray(j_ot_flow_indicators(X0, s, d))
        X, _ = j_identify_tree_flows(W, s, d)
        Bm = np.asarray(j_mst((np.asarray(X) > 1e-12).astype(float)))
        X, Bm, M = (np.asarray(X)[None], Bm[None], M[None])
        assert_same(jax_batched("parent", X, Bm, M, 5000),
                    port_run("parent", X, Bm, M, max_pivots=5000), M)


@pytest.mark.parametrize("engine", ["anc", "packed"])
@pytest.mark.parametrize("refresh", [1, 5])
def test_refresh_schedule_matches_jax(engine, refresh):
    """Short refresh chunks: the instances leave lockstep phase (each
    refreshes on its own schedule and waits for the next host read), yet
    each walks the JAX package's pivots."""
    inst = [random_ot(200 + i, 12, 10) for i in range(3)]
    X, Bm, M = nw_batch(inst)
    s, d = X.sum(2), X.sum(1)
    jout = JAX_BATCHED[engine](X, Bm, M, s, d, 1e-7, 2000, refresh)
    assert_same(jout, port_run(engine, X, Bm, M, max_pivots=2000,
                               refresh=refresh), M)


def test_packed_full_pricing_matches_jax():
    """blocks=0: every pivot prices in full."""
    X, Bm, M = nw_batch([random_ot(7, 11, 13)])
    s, d = X.sum(2)[0], X.sum(1)[0]
    jout = j_packed.transport_simplex_packed(X[0], Bm[0], M[0], s, d,
                                             blocks=0)
    pout = port_run("packed", X, Bm, M, blocks=0)
    assert_same([np.asarray(a)[None] for a in jout], pout, M)


@pytest.mark.parametrize("engine", ENGINES)
def test_pivot_cap_matches_jax(engine):
    """Stopped at max_pivots: the same pivots, flags and basis."""
    X, Bm, M = nw_batch([random_ot(300 + i, 12, 14) for i in range(2)])
    pout = port_run(engine, X, Bm, M, max_pivots=7)
    assert_same(jax_batched(engine, X, Bm, M, 7), pout, M)
    assert (pout[2] == 7).all() and not pout[3].any()


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_float32_certifies(engine):
    """In float32, the card's dtype, from TNET warm starts: every basis
    optimal and certified by the host f64 certifier."""
    starts = [tnet_start(60 + i, 14, 12) for i in range(3)]
    X, Bm, M = (np.stack([st[k] for st in starts]) for k in range(3))
    out = PORT_BATCHED[engine](torch.from_numpy(X).float(),
                               torch.from_numpy(Bm),
                               torch.from_numpy(M).float(), max_pivots=2000)
    assert out[0].dtype == torch.float32 and out[3].all()
    s, d = X.sum(2), X.sum(1)
    certs = certify_ot_basis_batch(out[1].numpy(), s, d, M)
    assert all(c.ok for c in certs), [c.reason for c in certs]


def test_single_instance_wrappers():
    """The unbatched forms return one instance's (X, Bm, pivots,
    optimal), as the JAX functions do."""
    X, Bm, M = nw_batch([random_ot(8, 6, 9)])
    for engine, fn in (("mask", p_mask.transport_simplex),
                       ("parent", p_parent.transport_simplex_parent),
                       ("anc", p_anc.transport_simplex_anc),
                       ("packed", p_packed.transport_simplex_packed)):
        out = fn(*(torch.from_numpy(a[0]) for a in (X, Bm, M)))
        batched = port_run(engine, X, Bm, M)
        assert out[0].shape == (6, 9) and out[2].shape == ()
        np.testing.assert_array_equal(out[1].numpy(), batched[1][0])
        assert int(out[2]) == int(batched[2][0]) and bool(out[3])


def test_tree_potentials_match_jax():
    s, d, M = random_ot(5, 5, 6)
    _, Bm = northwest_corner_basis(s, d)
    ju, jv = j_mask.tree_potentials(Bm, M)
    u, v = p_mask.tree_potentials(torch.from_numpy(Bm)[None],
                                  torch.from_numpy(M)[None])
    np.testing.assert_array_equal(u[0].numpy(), np.asarray(ju))
    np.testing.assert_array_equal(v[0].numpy(), np.asarray(jv))
    ii, jj = np.nonzero(Bm)
    np.testing.assert_allclose(u[0].numpy()[ii] + v[0].numpy()[jj],
                               M[ii, jj], atol=1e-12)


def test_chain_and_root_paths_match_jax():
    """The lifting tables, depths and potentials of one chain pass and the
    root-path indicators, against the JAX package's one-hot forms."""
    s, d, M = random_ot(6, 7, 9)
    _, Bm = northwest_corner_basis(s, d)
    jpar = j_parent.build_parent_from_mask(Bm)
    S, D = M.shape
    V = S + D
    K = j_parent._num_levels(V)
    E_r, E_c, _, _ = j_parent._cell_onehots(jpar, S, D, jnp.float64)
    w = np.asarray(jnp.sum((E_r @ M) * E_c, axis=1))
    jtabs, jdep, jpot = j_parent._chain(jpar, jnp.asarray(w), K,
                                        jnp.float64)
    par = torch.from_numpy(np.asarray(jpar, np.int64))[None]
    pw = p_parent._cell_values(torch.from_numpy(M)[None], par)
    np.testing.assert_array_equal(pw[0].numpy(), w)
    tabs, dep, pot = p_parent._chain(par, pw, K)
    for jt, t in zip(jtabs, tabs):
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(jt))
    np.testing.assert_array_equal(dep[0].numpy(), np.asarray(jdep))
    np.testing.assert_array_equal(pot[0].numpy(), np.asarray(jpot))
    x, y = 3, S + 5
    jax_, jay = j_parent._root_paths2(jnp.asarray(x), jnp.asarray(y), jtabs,
                                      jnp.float64)
    ax, ay = p_parent._root_paths2(torch.tensor([x]), torch.tensor([y]),
                                   tabs)
    np.testing.assert_array_equal(ax[0].numpy(), np.asarray(jax_))
    np.testing.assert_array_equal(ay[0].numpy(), np.asarray(jay))


def test_pack_unpack_round_trip():
    """pack_bool_rows / unpack_row against the JAX package's, on an
    ancestor matrix and on random rows of every width mod 32."""
    s, d, M = random_ot(9, 13, 24)
    _, Bm = northwest_corner_basis(s, d)
    N = np.asarray(j_anc.build_ancestor_matrix(
        j_parent.build_parent_from_mask(Bm)))
    rng = np.random.default_rng(0)
    for rows in (N, rng.uniform(size=(5, 70)) < 0.5,
                 rng.uniform(size=(3, 64)) < 0.5):
        V = rows.shape[1]
        W = (V + 31) // 32
        P = p_packed.pack_bool_rows(torch.from_numpy(rows), W)
        jP = np.asarray(j_packed.pack_bool_rows(jnp.asarray(rows), W))
        np.testing.assert_array_equal(P.numpy(), jP.astype(np.int64))
        np.testing.assert_array_equal(p_packed.unpack_row(P, V).numpy(),
                                      rows)
        for r in range(rows.shape[0]):
            np.testing.assert_array_equal(
                np.asarray(j_packed.unpack_row(jnp.asarray(jP[r]), V)),
                p_packed.unpack_row(P[r], V).numpy())


def test_popcount32():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.integers(0, 2 ** 32, 500),
                        [0, 1, 2 ** 31, 2 ** 32 - 1, 0x55555555]])
    got = p_packed.popcount32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(),
                                  [bin(int(v)).count("1") for v in x])
