"""Zero masses on the exact OT device route (ROADMAP fault 3.15).

MNIST-style pairs on the whole pixel grid keep their blank pixels as
points of mass 0, so that a batch has one shape.  The flow indicators
were 0 / 0 = NaN there, Borůvka found no finite edge, and the route
pivoted an empty plan to objective 0 and called it optimal.  These tests
hold the repaired route to HiGHS (``scipy.optimize.linprog``) and to the
float64 certificate; they compare nothing with the JAX package, whose
route is still wrong at zero masses (it returns that empty plan as
optimal), and they hold the route on positive masses to what it computed
before, bit for bit.  They also hold the route's basis check and K2's
count of degenerate pivots.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

from smart_crossover_tpu_torch.network_methods.certify import (
    certify_ot_basis_batch,
)
from smart_crossover_tpu_torch.ops import ranking
from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
from smart_crossover_tpu_torch.ops import transport_simplex_mega as tsm
from smart_crossover_tpu_torch.parallel import batched
from smart_crossover_tpu_torch.parallel.batched import (
    basis_check,
    batched_tnet_exact_device,
)
from smart_crossover_tpu_torch.utils import trace
from tests.ot_grids import digit_grid, dotmark

CPU = "cpu"


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(autouse=True)
def one_thread():
    """The plain pivot loops are many small torch ops: beside other test
    workers, each taking every core, they crawl on several threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _highs(s, d, M):
    S, D = M.shape
    A = sp.vstack([sp.kron(sp.eye(S), np.ones((1, D))),
                   sp.kron(np.ones((1, S)), sp.eye(D))])
    res = linprog(M.ravel(), A_eq=A, b_eq=np.concatenate([s, d]),
                  bounds=(0, None), method="highs")
    assert res.status == 0
    return res.fun


def _old_indicators(X, s, d):
    """The indicator as written before the repair (and in the JAX
    package): NaN on every cell of a zero-mass row or column."""
    return torch.maximum(X / s[:, :, None], X / d[:, None, :])


@pytest.mark.parametrize("side", [12, 20])
@pytest.mark.parametrize("engine", ["mega", "parent"])
def test_zero_masses_reach_the_highs_optimum(side, engine):
    s, d, M = digit_grid(4, side, 3, 2)
    assert (s == 0).mean() > 0.5 and (d == 0).mean() > 0.5
    with trace.recording() as rec:
        X, obj, _, piv, opt, Bm = batched_tnet_exact_device(
            s, d, M, max_pivots=20000, engine=engine, device=CPU)
    assert bool(opt.all()) and int(piv.max()) < 20000
    S, D = M.shape[1:]
    assert Bm.reshape(4, -1).sum(1).tolist() == [S + D - 1] * 4
    certs = certify_ot_basis_batch(Bm.numpy(), s, d, M)
    assert all(c.ok for c in certs), [c.reason for c in certs]
    for i in range(4):
        want = _highs(s[i], d[i], M[i])
        assert certs[i].obj_val == pytest.approx(want, rel=1e-9)
        if engine == "parent":      # the route's own float64 objective
            assert float(obj[i]) == pytest.approx(want, rel=1e-9)
    route = rec.summary()["scx.route"]["counters"]
    assert route["route.zero_nodes"] == int((s == 0).sum() + (d == 0).sum())
    assert route["route.refused"] == 0


def test_the_unrepaired_indicator_is_refused_by_the_basis_check(monkeypatch):
    """With the indicator written as before, the route still pivots the
    empty plan to objective 0 and the engine calls it optimal; the basis
    check now turns every instance down."""
    s, d, M = digit_grid(2, 12, 3, 2)
    monkeypatch.setattr(batched, "ot_flow_indicators", _old_indicators)
    with trace.recording() as rec:
        X, obj, _, _, opt, _ = batched_tnet_exact_device(
            s, d, M, max_pivots=20000, engine="parent", device=CPU)
    assert float(obj.abs().max()) == 0.0
    assert not bool(opt.any())
    assert rec.summary()["scx.route"]["counters"]["route.refused"] == 2


def _route_before(s, d, M, engine, monkeypatch):
    """The route as it ran before zero masses were handled: the indicator
    as written before, Borůvka over the support alone, the engine given
    no masses, no basis check."""
    monkeypatch.setattr(batched, "ot_flow_indicators", _old_indicators)
    s, d, M = (torch.from_numpy(a) for a in (s, d, M))
    X0, push = batched._warm_start(s, d, M, 0.005, 1000)
    Bm0 = boruvka_bipartite_mst((X0 > 1e-12).to(M.dtype))
    X, Bm, piv, opt = batched.ENGINES[engine](X0, Bm0, M, max_pivots=20000)
    return X, (X.to(M.dtype) * M).sum((1, 2)), push, piv, opt, Bm


@pytest.mark.parametrize("engine", ["mega", "parent"])
def test_positive_masses_are_unchanged_bit_for_bit(engine, monkeypatch):
    s, d, M = dotmark(3, 6, seed=17)
    X = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, M.shape))
    st, dt = torch.from_numpy(s), torch.from_numpy(d)
    assert torch.equal(ranking.ot_flow_indicators(X, st, dt),
                       _old_indicators(X, st, dt))
    new = batched_tnet_exact_device(s, d, M, max_pivots=20000,
                                    engine=engine, device=CPU)
    old = _route_before(s, d, M, engine, monkeypatch)
    assert bool(new[4].all())
    for a, b in zip(new, old):
        assert torch.equal(a, b)


def test_k2_pivots_the_nonzero_masses_and_hangs_the_rest():
    """On zero masses 'mega' pivots the transport between the nonzero
    masses (no cell at a zero-mass node enters) and hangs the zero-mass
    nodes after: far fewer pivots than 'parent', which pivots them into
    place one degenerate pivot at a time, and the same certified
    optimum."""
    s, d, M = digit_grid(4, 16, 3, 4)
    out = {e: batched_tnet_exact_device(s, d, M, max_pivots=20000,
                                        engine=e, device=CPU)
           for e in ("mega", "parent")}
    certs = {e: certify_ot_basis_batch(o[5].numpy(), s, d, M)
             for e, o in out.items()}
    for i in range(4):
        assert certs["mega"][i].ok and certs["parent"][i].ok
        assert certs["mega"][i].obj_val == pytest.approx(
            certs["parent"][i].obj_val, rel=1e-12)
    assert 4 * int(out["mega"][3].sum()) < int(out["parent"][3].sum())
    # the zero-mass nodes hang from the nodes that minimise their price
    Bm = out["mega"][5]
    zero_cols = np.flatnonzero(d[0] == 0)
    assert bool(Bm[0][:, zero_cols].any(0).all())


def test_complete_zero_masses_is_dual_feasible_and_spanning():
    """From a tree on the nonzero-mass nodes and its potentials, the
    completion gives every cell at a zero-mass node a non-negative reduced
    cost, and the basis S + D - 1 tight arcs."""
    rng = np.random.default_rng(4)
    S = D = 6
    M = torch.tensor(rng.integers(0, 9, (1, S, D)), dtype=torch.float64)
    live_s = torch.tensor([[True, False, True, False, False, True]])
    live_d = torch.tensor([[False, True, True, False, True, False]])
    # a tree on the live nodes: rows 0, 2, 5 and columns 1, 2, 4
    mask = torch.zeros(1, S, D, dtype=torch.bool)
    for i, j in ((0, 1), (0, 2), (2, 2), (5, 4), (2, 4)):
        mask[0, i, j] = True
    u = torch.zeros(S, dtype=torch.float64)
    v = torch.zeros(D, dtype=torch.float64)
    v[1], v[2] = M[0, 0, 1], M[0, 0, 2]
    u[2] = M[0, 2, 2] - v[2]
    v[4] = M[0, 2, 4] - u[2]
    u[5] = M[0, 5, 4] - v[4]
    pot = torch.cat([u, v])[None]
    new = tsm.complete_zero_masses(M, mask, pot, live_s, live_d)
    assert int(new.sum()) == S + D - 1
    assert torch.equal(new & live_s[:, :, None] & live_d[:, None, :], mask)
    # potentials from the new tree, from row 0
    pu, pv = {0: 0.0}, {}
    arcs = torch.nonzero(new[0]).tolist()
    while len(pu) + len(pv) < S + D:
        for i, j in arcs:
            if i in pu and j not in pv:
                pv[j] = float(M[0, i, j]) - pu[i]
            elif j in pv and i not in pu:
                pu[i] = float(M[0, i, j]) - pv[j]
    rc = M[0] - torch.tensor([pu[i] for i in range(S)])[:, None] \
        - torch.tensor([pv[j] for j in range(D)])[None, :]
    zero = ~live_s[0, :, None] | ~live_d[0, None, :]
    assert float(rc[zero].min()) >= 0.0
    assert float(rc[new[0]].abs().max()) == 0.0


def test_k2_calls_a_start_with_a_zero_mass_bridge_not_optimal():
    """A starting basis whose nonzero-mass nodes are joined only through
    a zero-mass node cannot be completed: 'mega' does not call it
    optimal."""
    s = torch.tensor([[0.5, 0.0, 0.5]], dtype=torch.float64)
    d = torch.tensor([[0.5, 0.5]], dtype=torch.float64)
    M = torch.tensor([[[1.0, 2.0], [0.0, 0.0], [2.0, 1.0]]],
                     dtype=torch.float64)
    X = torch.tensor([[[0.5, 0.0], [0.0, 0.0], [0.0, 0.5]]],
                     dtype=torch.float64)
    # rows 0 and 2 reach each other only through row 1 (mass 0)
    Bm = torch.tensor([[[True, False], [True, True], [False, True]]])
    *_, opt = tsm.batched_transport_simplex_mega(X, Bm, M, s, d)
    assert opt.tolist() == [False]
    *_, opt = tsm.batched_transport_simplex_mega(X, Bm, M)
    assert opt.tolist() == [True]


def _engine_returning(monkeypatch, change):
    """The 'parent' engine with ``change`` applied to its (X, Bm)."""
    real = batched.ENGINES["parent"]

    def planted(X0, Bm0, M, *masses, **kw):
        X, Bm, piv, opt = real(X0, Bm0, M, *masses, **kw)
        X, Bm = change(X.clone(), Bm.clone())
        return X, Bm, piv, torch.ones_like(opt)

    monkeypatch.setitem(batched.ENGINES, "parent", planted)


def _empty_basis(X, Bm):
    Bm[0] = False
    return X, Bm


def _infeasible_plan(X, Bm):
    X[1] = 0.0                          # the parent's empty plan
    return X, Bm


def _plan_off_a_mass(X, Bm):
    i, j = map(int, torch.nonzero(X[0] > 0)[0])
    X[0, i, j] += 1e-2 * X[0].max()     # row i carries too much
    return X, Bm


def _negative_flow(X, Bm):
    i, j = map(int, torch.nonzero(X[1] > 0)[0])
    X[1, i, j] = -X[1].max()
    return X, Bm


@pytest.mark.parametrize("change,refused", [
    (_empty_basis, [0]), (_infeasible_plan, [1]), (_plan_off_a_mass, [0]),
    (_negative_flow, [1])])
def test_a_planted_basis_is_not_called_optimal(change, refused,
                                               monkeypatch):
    s, d, M = digit_grid(3, 10, 3, 2)
    _engine_returning(monkeypatch, change)
    with trace.recording() as rec:
        *_, opt, _ = batched_tnet_exact_device(
            s, d, M, max_pivots=20000, engine="parent", device=CPU)
    assert torch.nonzero(~opt)[:, 0].tolist() == refused
    counters = rec.summary()["scx.basis_check"]["counters"]
    assert counters["route.refused"] == len(refused)


def test_basis_check_on_its_own():
    s, d, M = digit_grid(2, 8, 3, 2)
    X, _, _, _, opt, Bm = batched_tnet_exact_device(
        s, d, M, max_pivots=20000, engine="parent", device=CPU)
    st, dt = torch.from_numpy(s), torch.from_numpy(d)
    assert basis_check(X, Bm, st, dt).tolist() == [True, True]
    # float32 flows, as a card's engine returns them, pass as well
    assert basis_check(X.float(), Bm, st, dt).tolist() == [True, True]
    short = Bm.clone()
    short[1, torch.nonzero(Bm[1])[0, 0], torch.nonzero(Bm[1])[0, 1]] = False
    assert basis_check(X, short, st, dt).tolist() == [True, False]
    assert basis_check(torch.zeros_like(X), Bm, st, dt).tolist() == \
        [False, False]


def _two_by_two():
    """Two 2 x 2 transports from the basis {(0,0), (0,1), (1,1)}, each with
    one pivot to optimality: cell (1,0) enters.  Instance 0: s = d =
    (1, 0), so x(1,1) = 0 leaves on a cycle of ratio 0 (degenerate);
    instance 1: s = d = (1, 1), ratio 1."""
    X = torch.tensor([[[1.0, 0.0], [0.0, 0.0]], [[1.0, 0.0], [0.0, 1.0]]])
    Bm = torch.tensor([[[True, True], [False, True]]] * 2)
    M = torch.tensor([[[0.0, 0.0], [0.0, 1.0]], [[1.0, 0.0], [0.0, 1.0]]])
    return X, Bm, M


def test_k2_plain_counts_a_degenerate_pivot():
    X, Bm, M = _two_by_two()
    st = tsm.mega_setup(X, Bm, M)
    out = tsm.transport_simplex_mega_plain(st, max_pivots=100)
    assert out[5].tolist() == [1, 1] and out[6].tolist() == [True, True]
    assert out[7].tolist() == [1, 0]
    assert bool(out[4][:, 1, 0].all())                     # (1,0) entered
    # the CPU wrapper takes the plain version, count included
    for a, b in zip(tsm.transport_simplex_mega_state(st, max_pivots=100),
                    out):
        assert torch.equal(a, b)


def test_k2_counters_in_the_trace():
    """``k2.pivots`` and ``k2.degenerate`` add up the batch in
    ``scx.simplex_kernel`` while the tracer records, and nothing is kept
    while it does not.  The route pivots no zero-mass node into place, so
    on a zero-mass grid as on a DOTmark-like batch no pivot is
    degenerate; the hand-built pair above has one of two."""
    for s, d, M in (digit_grid(2, 10, 3, 2), dotmark(2, 6, seed=3)):
        with trace.recording() as rec:
            *_, piv, opt, _ = batched_tnet_exact_device(
                s, d, M, max_pivots=20000, device=CPU)
        c = rec.summary()["scx.simplex_kernel"]["counters"]
        assert c["k2.pivots"] == int(piv.sum()) > 0
        assert c["k2.degenerate"] == 0
        trace.clear()
    with trace.recording() as rec:
        tsm.batched_transport_simplex_mega(*_two_by_two(), max_pivots=100)
    c = rec.summary()["scx.simplex_kernel"]["counters"]
    assert (c["k2.pivots"], c["k2.degenerate"]) == (2, 1)
    trace.clear()
    batched_tnet_exact_device(s, d, M, max_pivots=20000, device=CPU)
    assert trace.records() == []
