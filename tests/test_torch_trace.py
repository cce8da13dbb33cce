"""The port's tracer (``smart_crossover_tpu_torch/utils/trace.py``) and the
spans and counters of its routes, on the CPU."""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from smart_crossover_tpu_torch import OptTransport
from smart_crossover_tpu_torch.data.mcf_gen import goto_like_mcf
from smart_crossover_tpu_torch.network_methods.algorithms import (
    network_crossover,
)
from smart_crossover_tpu_torch.network_methods.certify import (
    certify_ot_basis_batch,
)
from smart_crossover_tpu_torch.parallel.batched import (
    batched_tnet_exact,
    batched_tnet_exact_device,
)
from smart_crossover_tpu_torch.solvers.pdhg_mcf import pdhg_mcf_device
from smart_crossover_tpu_torch.solvers.sinkhorn import sinkhorn
from smart_crossover_tpu_torch.utils import trace

CPU = "cpu"
ROUTE = ["scx.upload", "scx.sinkhorn_kernel", "scx.round_indicators",
         "scx.boruvka_flow", "scx.tree_solve", "scx.push",
         "scx.boruvka_support", "scx.simplex_setup", "scx.simplex_kernel",
         "scx.rebuild", "scx.basis_check"]
COUNTS = ("push_iters", "cg_rounds", "cg_pivots")


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def _ot(seed=42, S=10, D=12):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2, S)
    d = rng.uniform(0.5, 2, D)
    d *= s.sum() / d.sum()
    return OptTransport(s=s, d=d, M=rng.uniform(0, 5, (S, D)))


def _tnet(stats=None, method="tnet"):
    ot = _ot()
    x = sinkhorn(ot, reg=0.05, num_iters=300, device=CPU)
    return network_crossover(x, ot=ot, method=method, device=CPU,
                             stats=stats)


def _batch(B=3, S=12, D=14, seed=5):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2, (B, S))
    d = rng.uniform(0.5, 2, (B, D))
    d *= (s.sum(1) / d.sum(1))[:, None]
    return s, d, rng.uniform(0, 5, (B, S, D))


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_keeps_no_record_and_enters_no_range(monkeypatch):
    """With no profiler and no ``recording()``, a call keeps no record
    and never opens a ``record_function`` range; its ``stats`` carry the
    same keys and counts as a recorded call's."""
    with trace.recording():
        on = {}
        _tnet(on)
    trace.clear()

    def no_range(name):
        raise AssertionError(f"record_function({name!r}) while off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    off = {}
    out = _tnet(off)
    assert out.status == "OPTIMAL"
    assert trace.records() == [] and trace.summary() == {}
    assert set(off) == set(on)
    assert {k: off[k] for k in COUNTS} == {k: on[k] for k in COUNTS}
    for k in ("ranking_s", "tree_basis_s", "cg_s"):
        assert 0 < off[k] < 60
    assert off["cg_pivots"] + off["push_iters"] == out.iter_count


def test_spans_nest_and_share_the_request_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        _tnet()
        _tnet()
    recs = trace.records()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["scx.network_crossover"] * 2
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
            assert r.request == p.request
        assert r.request in {x.id for x in roots}
    assert len({r.request for r in recs}) == 2
    names = _by_name(recs)
    tb = names["scx.tree_basis"][0]
    assert {by_id[r.parent].name for r in names["scx.push"]} == \
        {"scx.tree_basis"}
    assert by_id[tb.parent].name == "scx.network_crossover"
    assert {by_id[r.parent].name for r in names["scx.cg.subproblem"]} == \
        {"scx.cg"}


def test_records_lie_on_kinetos_clock():
    """Each span's start and end lie within 1 ms of kineto's event of the
    same name (Unix-epoch nanoseconds)."""
    with profile(activities=[ProfilerActivity.CPU]):  # the profiler's
        _tnet()                                         # first-use cost
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _tnet(method="cnet_ot")
        _tnet()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    recs = trace.records()
    assert len(recs) == sum(len(v) for v in events.values()) > 10
    for name, rs in _by_name(recs).items():
        evs = sorted(events[name])
        for r, (a, b) in zip(sorted(rs, key=lambda r: r.start_ns), evs):
            assert abs(r.start_ns - a) < 1_000_000, name
            assert abs(r.end_ns - b) < 1_000_000, name
    assert abs(recs[-1].end_ns - time.time_ns()) < 5e9


def test_summary_self_time_is_total_less_children():
    with trace.recording():
        with trace.span("scx.outer"):
            time.sleep(0.002)
            for _ in range(2):
                with trace.span("scx.inner"):
                    time.sleep(0.003)
                    with trace.span("scx.leaf"):
                        time.sleep(0.001)
    s = trace.summary()
    assert s["scx.outer"]["calls"] == 1 and s["scx.inner"]["calls"] == 2
    for name, child in (("scx.outer", "scx.inner"),
                        ("scx.inner", "scx.leaf")):
        assert s[name]["self_s"] == pytest.approx(
            s[name]["host_s"] - s[child]["host_s"], abs=1e-12)
    assert s["scx.leaf"]["self_s"] == s["scx.leaf"]["host_s"]
    assert s["scx.outer"]["self_s"] >= 0.002
    assert s["scx.outer"]["event_s"] is None   # no CUDA device


def test_counters_attach_to_the_open_span():
    with trace.recording():
        trace.count("lost", 5)                  # no span open: dropped
        with trace.span("scx.a"):
            trace.count("n", 2)
            with trace.span("scx.b"):
                trace.count("n", 3)
                trace.count("m", 1)
            trace.count("n", 4)
    recs = _by_name(trace.records())
    assert recs["scx.b"][0].counters == {"n": 3, "m": 1}
    assert recs["scx.a"][0].counters == {"n": 6}
    s = trace.summary()
    assert s["scx.a"]["counters"] == {"n": 9, "m": 1}   # inclusive
    assert s["scx.b"]["counters"] == {"n": 3, "m": 1}
    stats = {}
    trace.count("x", 7, stats, "x_total")      # off: stats only
    assert stats == {"x_total": 7} and len(trace.records()) == 2


def test_span_writes_its_stats_key_whether_or_not_it_records():
    for rec in (False, True):
        stats = {}
        ctx = trace.recording() if rec else trace.span("scx.unused")
        with ctx:
            with trace.span("scx.timed", stats=stats, key="timed_s"):
                time.sleep(0.002)
        assert 0.002 <= stats["timed_s"] < 1
    recs = trace.records()
    assert [r.name for r in recs] == ["scx.timed"]
    assert recs[0].host_s == pytest.approx(stats["timed_s"], abs=1e-12)


def test_recording_stretch_covers_its_block_only():
    with trace.recording():
        with trace.span("scx.before"):
            pass
    with trace.recording() as rec:
        with trace.span("scx.inside"):
            pass
    with trace.recording():
        with trace.span("scx.after"):
            pass
    assert [r.name for r in rec.records()] == ["scx.inside"]
    assert list(rec.summary()) == ["scx.inside"]
    assert [r.name for r in trace.records()] == \
        ["scx.before", "scx.inside", "scx.after"]


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(trace.TRACER, "capacity", 3)
    with trace.recording():
        for _ in range(5):
            with trace.span("scx.s"):
                pass
    assert len(trace.records()) == 3 and trace.dropped() == 2
    trace.clear()
    assert trace.dropped() == 0 and trace.records() == []


def test_threads_keep_their_own_stacks():
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with trace.span(f"scx.{tag}"):
            barrier.wait()
            with trace.span(f"scx.{tag}.child"):
                barrier.wait()

    with trace.recording():
        ts = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    recs = _by_name(trace.records())
    for tag in "ab":
        root, child = recs[f"scx.{tag}"][0], recs[f"scx.{tag}.child"][0]
        assert root.parent is None and child.parent == root.id
        assert child.request == root.request == root.id
        assert child.thread == root.thread
    assert recs["scx.a"][0].thread != recs["scx.b"][0].thread


def test_tnet_emits_its_spans_and_counters():
    stats = {}
    with profile(activities=[ProfilerActivity.CPU]):
        out = _tnet(stats)
    s = trace.summary()
    for name in ("scx.network_crossover", "scx.ranking", "scx.tree_basis",
                 "scx.boruvka_flow", "scx.tree_solve", "scx.push", "scx.cg",
                 "scx.cg.subproblem", "scx.cg.pricing"):
        assert name in s, name
    assert "scx.cnet_setup" not in s
    root = s["scx.network_crossover"]
    assert root["calls"] == 1
    assert root["counters"]["cg.rounds"] == stats["cg_rounds"] == \
        s["scx.cg.subproblem"]["calls"] == s["scx.cg.pricing"]["calls"]
    assert root["counters"]["cg.pivots"] == stats["cg_pivots"]
    assert root["counters"]["push.steps"] == stats["push_iters"] == \
        s["scx.tree_basis"]["counters"]["push.steps"]
    assert [k for k in root["counters"] if k.startswith("push.")] == \
        ["push.steps"]
    assert s["scx.boruvka_flow"]["counters"]["boruvka.rounds"] >= 1
    assert stats["cg_pivots"] + stats["push_iters"] == out.iter_count
    for name, key in (("scx.ranking", "ranking_s"),
                      ("scx.tree_basis", "tree_basis_s"), ("scx.cg", "cg_s")):
        assert s[name]["host_s"] == pytest.approx(stats[key], abs=1e-12)
    parts = sum(s[n]["host_s"] for n in ("scx.ranking", "scx.tree_basis",
                                         "scx.cg"))
    assert parts <= root["host_s"]


def test_cnet_mcf_emits_its_spans_and_counters():
    mcf = goto_like_mcf(6, 6, 2, seed=3, regular=True)
    with trace.recording():
        x, _, iters, _, _ = pdhg_mcf_device(mcf, tol=1e-4, max_iters=2000,
                                            device=CPU)
        stats = {}
        out = network_crossover(x, mcf=mcf, method="cnet_mcf", device=CPU,
                                stats=stats)
    assert out.status == "OPTIMAL"
    s = trace.summary()
    assert s["scx.pdhg"]["counters"] == {"pdhg.iters": iters}
    assert s["scx.pdhg"]["event_s"] is None
    assert "scx.tree_basis" not in s
    root = s["scx.network_crossover"]
    assert root["calls"] == 1 and s["scx.cnet_setup"]["calls"] == 1
    assert root["counters"]["cg.rounds"] == stats["cg_rounds"] == \
        s["scx.cg.subproblem"]["calls"] == s["scx.cg.pricing"]["calls"]
    assert stats["push_iters"] == 0
    assert not any(k.startswith("push.") for k in root["counters"])
    recs = trace.records()
    assert len({r.request for r in recs}) == 2   # the warm start, CNET
    parts = sum(s[n]["host_s"] for n in ("scx.ranking", "scx.cnet_setup",
                                         "scx.cg.subproblem",
                                         "scx.cg.pricing"))
    assert parts <= root["host_s"]


def test_pdhg_records_under_the_profiler_only():
    mcf = goto_like_mcf(6, 6, 2, seed=3, regular=True)
    pdhg_mcf_device(mcf, tol=1e-4, max_iters=500, device=CPU)
    assert trace.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        pdhg_mcf_device(mcf, tol=1e-4, max_iters=500, device=CPU)
    assert [r.name for r in trace.records()] == ["scx.pdhg"]


def test_the_batched_route_emits_every_stage():
    s, d, M = _batch()
    with trace.recording():
        X, obj, push, piv, opt, Bm = batched_tnet_exact_device(
            s, d, M, reg=0.005, sinkhorn_iters=200, max_pivots=2000,
            device=CPU)
        certs = certify_ot_basis_batch(Bm.numpy(), s, d, M)
    sm = trace.summary()
    route = sm["scx.route"]
    assert route["calls"] == 1 and all(sm[n]["calls"] == 1 for n in ROUTE)
    by_id = {r.id: r for r in trace.records()}
    for r in trace.records():
        if r.name in ROUTE:
            assert by_id[r.parent].name in ("scx.route",)
    assert route["counters"]["boruvka.rounds"] == \
        sm["scx.boruvka_flow"]["counters"]["boruvka.rounds"] \
        + sm["scx.boruvka_support"]["counters"]["boruvka.rounds"]
    assert route["counters"]["push.steps"] == int(push.max())
    assert sum(sm[n]["host_s"] for n in ROUTE) <= route["host_s"]
    assert sm["scx.certify"]["counters"].get("certify.rejected") == \
        sum(not c.ok for c in certs) == 0


def test_batched_tnet_exact_keeps_its_stats():
    s, d, M = _batch()
    for engine, max_pivots in (("mega", 1), ("host", None)):
        stats = {}
        with trace.recording() as rec:
            _, _, _, opt = batched_tnet_exact(
                s, d, M, sinkhorn_iters=100, engine=engine,
                max_pivots=max_pivots, device=CPU, stats=stats)
        assert opt.all() and stats["engine"] == engine
        sm = rec.summary()
        assert sm["scx.exact.device"]["host_s"] == stats["device_s"] > 0
        assert sm["scx.exact.host"]["host_s"] == stats["host_s"] > 0
        if engine == "mega":
            assert stats["repaired"] >= 1
            assert sm["scx.exact.host"]["counters"]["exact.repaired"] == \
                stats["repaired"]
        else:
            assert "repaired" not in stats
