"""The per-layer metrics read from the port's own tracer
(``harness/program_trace.py``): a traced small CPU run of each cell
reports each of them over the traced stretch alone, an untraced run
records nothing, and each reader returns None on an empty record."""
import math

import pytest

from benchmark.harness import cli, spec
from benchmark.tests.small import run_small

PROGRAM = {
    "dotmark32_batch16": ("scx.route", [
        "push_ms.batch", "boruvka_ms.batch", "tree_solve_ms.batch",
        "push_steps.batch"]),
    "mnist_single_tnet": ("scx.network_crossover", [
        "ranking_ms.single", "tree_basis_ms.single", "cg_ms.single"]),
    "goto17_single_cnet": ("scx.network_crossover", [
        "pdhg_ms_per_iter.goto", "subproblem_s.goto", "pricing_s.goto",
        "cg_rounds.goto"]),
}
METRICS = sorted(m for _, ms in PROGRAM.values() for m in ms)


@pytest.fixture
def tracer():
    from smart_crossover_tpu_torch.utils import trace

    trace.clear()
    yield trace
    trace.clear()


def test_the_metrics_are_declared_for_their_cells():
    entries = {m["name"]: m for m in spec.benchmark_json()["per_layer"]}
    for cell, (_, names) in PROGRAM.items():
        for name in names:
            assert entries[name]["workloads"] == [cell]
            assert entries[name]["source"] in ("program_span",
                                               "program_counter")


@pytest.mark.parametrize("name", sorted(PROGRAM))
def test_a_traced_small_run_reports_the_programs_metrics(name, tracer):
    cell, res = run_small(name, seconds=0.5, trace=True)
    got = cli.metrics(cell, res["run"], True)
    root, names = PROGRAM[name]
    for m in names:
        print(name, m, got.get(m))
        assert m in got and math.isfinite(got[m]["value"])
        assert got[m]["value"] >= 0
    # the record is the traced stretch's: the set-up and the requests
    # after it ran with the profiler off
    traced = min(cell.traffic["trace_requests"], len(res["window"].records))
    assert tracer.summary()[root]["calls"] == traced


def test_an_untraced_run_records_nothing(tracer):
    run_small("mnist_single_tnet", seconds=0.3)
    assert tracer.records() == []


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_returns_none_on_an_empty_record(name, tracer):
    assert spec.metric_reader(name).read(None) is None
