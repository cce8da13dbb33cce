"""The metric arithmetic on made-up inputs."""
import math
from types import SimpleNamespace

import pytest

from benchmark.harness import spec
from benchmark.harness.loop import Window
from benchmark.harness.trace import Trace, union_and_gaps
from benchmark.roofline import peaks
from benchmark.roofline.sinkhorn import roofline_pct, sinkhorn_work

H100 = {"sms": 132, "max_sm_mhz": 1980.0}


def run_with(**kw):
    base = dict(window=Window(seconds=10.0), units=0, spans={}, counters=[],
                trace=None, device_info=None, setup_s=12.5,
                config={"S": 784, "D": 784, "sinkhorn_iters": 1000},
                traffic={"batch": 16})
    base.update(kw)
    return SimpleNamespace(**base)


def e2e(name):
    return spec.end_to_end_reader(name).read


def layer(name):
    return spec.metric_reader(name).read


def test_rate_and_time_per_vertex_take_the_whole_window():
    run = run_with(window=Window(seconds=12.5), units=400)
    assert e2e("certified_inst_per_s")(run) == 32.0
    assert e2e("vertex_s")(run_with(window=Window(seconds=52.0),
                                    units=8)) == 6.5
    assert e2e("vertex_s")(run_with(units=0)) is None
    assert e2e("setup_s")(run) == 12.5


@pytest.mark.parametrize("n", [20, 199, 200, 231])
def test_p95_leaves_the_nearest_rank_tail_beyond_it(n):
    lat = [(i + 1) / 1000 for i in range(n)]      # 1 ms .. n ms, shuffled
    lat = lat[::2] + lat[1::2]
    v = e2e("request_p95_ms")(run_with(window=Window(latencies=lat)))
    k = math.ceil(0.95 * n)
    assert v == pytest.approx(k)                   # the k-th smallest, in ms
    assert sum(x * 1e3 > v for x in lat) == n - k
    if n >= 200:
        assert n - k >= 10


def test_union_of_busy_spans_and_its_gaps():
    busy, gaps = union_and_gaps([(5, 10), (0, 3), (8, 12), (20, 30),
                                 (11, 12)], 2, 25)
    assert busy == 1 + 7 + 5                       # [2,3], [5,12], [20,25]
    assert gaps == [(3, 5), (12, 20)]
    assert union_and_gaps([], 0, 4) == (0, [(0, 4)])


def test_idle_share_and_kernel_time_from_a_trace():
    t = Trace(window_s=2.0, busy_s=0.5,
              kernels={"void mega_kernel(Args)": [0.2, 4],
                       "sinkhorn_cluster_kernel<8, 32>": [0.12, 4]})
    run = run_with(trace=t, device_info=H100)
    for c in ("batch", "goto", "single"):
        assert layer(f"device_idle_pct.{c}")(run) == pytest.approx(75.0)
    assert layer("k2_ms.batch")(run) == pytest.approx(50.0)
    assert layer("device_idle_pct.batch")(run_with()) is None
    assert layer("k2_ms.batch")(run_with(trace=Trace(1.0, 0.5))) is None


def test_k1_roofline_over_the_stretchs_own_shapes():
    # exp-bound: 2001 exps a cell at 16 x 132 x 1.98e9 per second
    ops, nbytes, exps = sinkhorn_work(16, 784, 784, 1000)
    assert exps == 16 * 784 * 784 * 2001
    bound = peaks.bound_s(ops, nbytes, exps, H100)
    assert bound == pytest.approx(exps / (16 * 132 * 1980e6))
    assert bound * 1e3 == pytest.approx(4.706, abs=1e-3)
    t = Trace(1.0, 0.5, {"sinkhorn_cluster_kernel<8, 32>(Args)":
                         [4 * 0.032, 4]})
    c = [{"k1_shape": (16, 784, 784)}] * 4
    run = run_with(trace=t, device_info=H100, counters=c,
                   traffic={"trace_requests": 4})
    assert roofline_pct(run) == pytest.approx(100 * bound / 0.032)
    assert layer("k1_roofline_pct.batch")(run) == roofline_pct(run)
    # B = 1 at shapes that differ: the summed bound over the summed time
    shapes = [(1, 120, 130), (1, 64, 200), (1, 150, 150)]
    t = Trace(1.0, 0.5, {"sinkhorn_cluster_kernel<2, 32>(Args)": [0.006, 3]})
    run = run_with(trace=t, device_info=H100, traffic={"trace_requests": 3},
                   counters=[{"k1_shape": sh} for sh in shapes] + [{}])
    want = sum(peaks.bound_s(*sinkhorn_work(*sh, 1000), H100)
               for sh in shapes)
    assert layer("k1_roofline_pct.single")(run) == pytest.approx(
        100 * want / 0.006)
    # no K1 launch, or not one launch a traced request: nothing to read
    assert roofline_pct(run_with(trace=Trace(1.0, 0.5),
                                 device_info=H100)) is None
    t = Trace(1.0, 0.5, {"sinkhorn_cluster_kernel<2, 32>(Args)": [0.006, 2]})
    assert roofline_pct(run_with(trace=t, device_info=H100,
                                 traffic={"trace_requests": 3},
                                 counters=[{"k1_shape": sh}
                                           for sh in shapes])) is None


def test_span_and_counter_means():
    run = run_with(spans={"warm_start": [1.5, 2.5],
                          "network_crossover": [0.2, 0.4]},
                   counters=[{"cg_s": 4.0}, {"cg_s": 5.0}, {}])
    assert layer("warm_start_s.goto")(run) == pytest.approx(2.0)
    assert layer("cg_s.goto")(run) == pytest.approx(4.5)
    assert layer("tnet_ms.single")(run) == pytest.approx(300.0)
    assert layer("tnet_ms.single")(run_with()) is None


def test_batch_spans_and_certificate_counters():
    run = run_with(spans={"ot_device": [0.3, 0.5], "certify": [0.2, 0.2]},
                   counters=[{"certified": 15, "instances": 16},
                             {"certified": 16, "instances": 16}])
    assert layer("ot_device_ms.batch")(run) == pytest.approx(400.0)
    assert layer("certify_ms.batch")(run) == pytest.approx(200.0)
    assert layer("uncertified_pct.batch")(run) == pytest.approx(100 / 32)
    assert layer("uncertified_pct.batch")(run_with()) is None
    assert layer("ot_device_ms.batch")(run_with()) is None


def test_a_traced_run_reads_its_spans_and_stretch():
    from benchmark.harness import cli
    from benchmark.tests.small import run_small

    cell, res = run_small("mnist_single_tnet", seconds=0.5, trace=True)
    run = res["run"]
    assert run.trace is not None and run.trace.window_s > 0
    assert len(run.spans["network_crossover"]) == len(res["window"].records)
    got = cli.metrics(cell, run, True)
    assert got["tnet_ms.single"]["unit"] == "ms"
    # the CPU records no device activity: no idle share, no roofline
    assert "device_idle_pct.single" not in got
    assert "k1_roofline_pct.single" not in got
