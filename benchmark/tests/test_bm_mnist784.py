"""The cell ``mnist784_batch16`` on the CPU at small sizes: MNIST-style
pairs on the whole pixel grid, blank pixels kept as points of mass 0.

The grid generator equals the port's construction where the two overlap;
the reference judges zero-mass transport against HiGHS; a whole small
cell passes for the program and fails for the control and for planted
faults (the empty plan called optimal, as the route returned it before
zero masses were repaired, among them); and K2's new counters are read
where the program counts them and give None where it does not."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

from benchmark.gen import digits, digits_grid
from benchmark.harness import cli, spec
from benchmark.reference import network_lp as ref
from benchmark.tests.small import SEED
from benchmark.tests.test_bm_control import (
    _certified_objective,
    _device,
    _device_flows,
    correct,
)

CELL = "mnist784_batch16"
NEW = ["degenerate_pivot_pct.mnist784", "degenerate_pivot_pct.batch",
       "k2_pivots.mnist784", "k2_pivots.batch"]


@pytest.fixture(autouse=True)
def one_thread():
    """The plain pivot loops are many small torch ops: beside other test
    workers, each taking every core, they crawl on several threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tracer():
    from smart_crossover_tpu_torch.utils import trace

    trace.clear()
    yield trace
    trace.clear()


def small_grid_cell() -> spec.Cell:
    """10 x 10 images (S = D = 100), 2 blobs each, batches of 4 from a
    pool of 2, every request kept whole."""
    cell = spec.load_cell(CELL)
    cell.config.update(side=10, blobs=2)
    cell.traffic.update(batch=4, pool_batches=2, warm_requests=1,
                        trace_requests=2, sample_every=1)
    return cell


def run_small_grid(seconds=1.0, trace=False, control=False):
    import time

    cell = small_grid_cell()
    return cell, cli.run_cell(cell, SEED, seconds, trace, torch.device("cpu"),
                              time.perf_counter(), 0.0, control=control)


@pytest.mark.parametrize("num,side,seed", [(3, 28, 5), (2, 12, 2**40 + 9)])
def test_grid_pairs_equal_the_ports_where_they_overlap(num, side, seed):
    from smart_crossover_tpu_torch.data import ot_gen

    s, d = digits_grid.grid_pairs(num, seed, side, blobs=4)
    imgs = ot_gen.synthetic_digits(2 * num, side, seed, 4)
    idx = np.arange(side * side)
    M = digits_grid.grid_cost(side)
    np.testing.assert_array_equal(
        M, ot_gen.grid_l1_cost((side, side), idx, (side, side), idx))
    assert M.max() == 2 * (side - 1)
    for i in range(num):
        ot = ot_gen.images_to_ot(imgs[2 * i], imgs[2 * i + 1])
        ia, ib = np.flatnonzero(imgs[2 * i]), np.flatnonzero(imgs[2 * i + 1])
        np.testing.assert_allclose(s[i][ia], ot.s, rtol=1e-15, atol=0)
        np.testing.assert_allclose(d[i][ib], ot.d, rtol=1e-15, atol=0)
        assert np.count_nonzero(s[i]) == ia.size
        np.testing.assert_array_equal(M[np.ix_(ia, ib)], ot.M)
    np.testing.assert_allclose(s.sum(1), 1.0, rtol=1e-14)
    assert (s == 0).mean() > (0.5 if side == 28 else 0.2)
    a = digits_grid.grid_pairs(num, seed, side)
    assert np.array_equal(a[0], s) and np.array_equal(a[1], d)
    np.testing.assert_array_equal(
        imgs, digits.synthetic_digits(2 * num, side, seed, 4))


def _highs(s, d, M):
    S, D = M.shape
    A = sp.vstack([sp.kron(sp.eye(S), np.ones((1, D))),
                   sp.kron(np.ones((1, S)), sp.eye(D))])
    res = linprog(M.ravel(), A_eq=A, b_eq=np.concatenate([s, d]),
                  bounds=(0, None), method="highs")
    assert res.status == 0
    return res.fun


def _tree_start(s, d, M):
    """The tree basis and vertex the route hands the pivot loop."""
    from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
    from smart_crossover_tpu_torch.parallel import batched

    s, d, M = (torch.from_numpy(a) for a in (s, d, M))
    X0, _ = batched._warm_start(s, d, M, 0.005, 1000)
    return X0, boruvka_bipartite_mst((X0 > 1e-12).to(M.dtype))


@pytest.mark.parametrize("pivoted", [True, False])
def test_the_reference_judges_zero_masses_as_highs(pivoted):
    """On 12 x 12 pairs with the zero pixels kept: for the bases the
    program pivots to optimality, the reference's float64 vertex has
    HiGHS's objective and its Lagrangian bound closes on it, so every
    number lies within the cell's limits; for the tree bases the route
    starts from, the bound stays below HiGHS's optimum, as any lower
    bound must, and ``rcost_err`` fails its limit: their vertex may
    already be optimal, but their potentials break the reduced costs'
    signs at zero-mass nodes (a flow bounded by a zero mass leaves those
    out of the Lagrangian bound)."""
    from smart_crossover_tpu_torch.parallel.batched import (
        batched_tnet_exact_device,
    )

    s, d = digits_grid.grid_pairs(3, 7, 12, blobs=2)
    M = digits_grid.grid_cost(12)
    Mb = np.broadcast_to(M, (3,) + M.shape).copy()
    limits = spec.load_cell(CELL).traffic["limits"]
    if pivoted:
        X, _, _, _, opt, Bm = batched_tnet_exact_device(
            s, d, Mb, max_pivots=20000, device="cpu")
    else:
        X, Bm = _tree_start(s, d, Mb)
    for i in range(3):
        net = ref.ot_network(s[i], d[i], M)
        basic = np.flatnonzero(Bm[i].numpy().ravel())
        x64, cx = ref.vertex_of_basis(net, basic, np.zeros(net.n, bool),
                                      torch.float64)
        assert np.abs(ref.residual(net, x64)).max() <= 1e-15
        nums = ref.judge_ot_basis(net, basic, cx, X[i].numpy(), True, cx,
                                  x64.reshape(M.shape))
        want = _highs(s[i], d[i], M)
        lag = cx * (1 - nums["device_gap"])
        assert lag <= want * (1 + 1e-12)
        if pivoted:
            assert bool(opt[i])
            assert cx == pytest.approx(want, rel=1e-9)
            assert all(nums[k] <= limits[k] for k in nums), nums
        else:
            assert cx >= want * (1 - 1e-12)
            assert nums["rcost_err"] > limits["rcost_err"]


def test_the_program_passes_and_the_control_fails():
    cell, res = run_small_grid(control=True)
    ok, checks = correct(cell, res)
    assert ok, checks
    ok, checks = correct(cell, res, "control_numbers")
    assert not ok
    for k in ("device_err", "device_gap", "vertex_err", "obj_err"):
        assert checks[k]["value"] > checks[k]["limit"], (k, checks)


def _empty_plan_called_optimal(monkeypatch):
    """What the route returned before zero masses were repaired: the
    basis it pivoted, with an empty plan of objective 0 called optimal."""
    def change(real, *a, **kw):
        X, obj, push, piv, opt, Bm = real(*a, **kw)
        return (torch.zeros_like(X), torch.zeros_like(obj), push, piv,
                torch.ones_like(opt), Bm)
    _device(monkeypatch, change)


def _unrepaired_indicator(monkeypatch):
    """The indicator as written before the repair: NaN at zero masses."""
    import smart_crossover_tpu_torch.parallel.batched as pb

    monkeypatch.setattr(
        pb, "ot_flow_indicators",
        lambda X, s, d: torch.maximum(X / s[:, :, None], X / d[:, None, :]))


@pytest.mark.parametrize("fault", [
    _empty_plan_called_optimal, _unrepaired_indicator, _device_flows,
    _certified_objective],
    ids=["empty-plan-called-optimal", "unrepaired-indicator",
         "device-flow-altered", "certified-objective-altered"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    cell, res = run_small_grid(seconds=0.5)
    ok, checks = correct(cell, res)
    assert not ok, checks


@pytest.mark.parametrize("name", NEW)
def test_the_new_readers_return_none_without_the_counters(name, tracer):
    assert spec.metric_reader(name).read(None) is None
    with tracer.recording():                 # spans without K2's counters
        with tracer.span("scx.route"):
            tracer.count("push.steps", 3)
    assert spec.metric_reader(name).read(None) is None


def test_a_traced_small_run_reads_k2s_counters(tracer):
    cell, res = run_small_grid(seconds=0.5, trace=True)
    got = cli.metrics(cell, res["run"], True)
    assert set(got) == {"degenerate_pivot_pct.mnist784",
                        "k2_pivots.mnist784"}
    # the route pivots no zero-mass node into place
    assert got["degenerate_pivot_pct.mnist784"]["value"] == 0.0
    assert got["k2_pivots.mnist784"]["value"] > 0
    counters = tracer.summary()["scx.route"]["counters"]
    assert counters["route.refused"] == 0 and counters["route.zero_nodes"] > 0
