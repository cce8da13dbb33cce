"""``correct`` on the CPU at small sizes: true for the program, false for
the control (the reference in the program's place one precision below
the configuration's) and for the program with its timed path broken:
an answer altered where it is produced (the pivot kernel's basis, the
device's flows or objective, a certified vertex or objective, a
crossover's vertex), and half of a batch left out."""
import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import cli, spec
from benchmark.tests.small import run_small

CELLS = ["dotmark32_batch16", "mnist_single_tnet", "goto17_single_cnet"]


def correct(cell, res, key="numbers"):
    attempted, failed, checks = cli.verdict(cell, res, key)
    return attempted > 0 and failed == 0, checks


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_the_control_fails(name):
    cell, res = run_small(name, control=True)
    ok, checks = correct(cell, res)
    assert ok, checks
    ok, checks = correct(cell, res, "control_numbers")
    assert not ok
    # float32 in the float64 stages' place
    assert checks["vertex_err"]["value"] > checks["vertex_err"]["limit"]
    assert checks["obj_err"]["value"] > checks["obj_err"]["limit"]
    if "device_err" in checks:
        # bfloat16 in the device's float32 stage's place
        assert checks["device_err"]["value"] > checks["device_err"]["limit"]
        assert checks["device_gap"]["value"] > checks["device_gap"]["limit"]


def _device(monkeypatch, change):
    """The device route with ``change`` applied to what it returns."""
    import smart_crossover_tpu_torch.parallel.batched as pb

    real = pb.batched_tnet_exact_device

    def altered(*a, **kw):
        return change(real, *a, **kw)

    monkeypatch.setattr(pb, "batched_tnet_exact_device", altered)


def _unpivoted(monkeypatch):
    """K2 returns its starting basis unpivoted and calls it optimal."""
    def change(real, *a, **kw):
        X, obj, push, piv, opt, Bm = real(*a, **dict(kw, max_pivots=0))
        return X, obj, push, piv, torch.ones_like(opt), Bm
    _device(monkeypatch, change)


def _device_flows(monkeypatch):
    def change(real, *a, **kw):
        X, *rest = real(*a, **kw)
        X = X.clone()
        i, j = map(int, torch.nonzero(X[0])[0])
        X[0, i, j] += 1e-2 * float(X[0].max())
        return (X, *rest)
    _device(monkeypatch, change)


def _device_objective(monkeypatch):
    def change(real, *a, **kw):
        X, obj, *rest = real(*a, **kw)
        obj = obj.clone()
        obj[-1] *= 1 + 1e-3
        return (X, obj, *rest)
    _device(monkeypatch, change)


def _half_batch(monkeypatch):
    def change(real, s, d, M, **kw):
        h = M.shape[0] // 2
        out = real(s[:h], d[:h], M[:h], **kw)
        return tuple(torch.cat([t, t]) for t in out)
    _device(monkeypatch, change)


def _certificate(monkeypatch, field, factor):
    import smart_crossover_tpu_torch.network_methods.certify as cert

    real = cert.certify_ot_basis_batch

    def altered(Bm, s, d, M, **kw):
        out = real(Bm, s, d, M, **kw)
        i = next(k for k, c in enumerate(out) if c.ok)
        c = out[i]
        if field == "x":
            a, b = np.argwhere(c.x > 0)[0]
            x = c.x.copy()
            x[a, b] *= factor
            out[i] = dataclasses.replace(c, x=x)
        else:
            out[i] = dataclasses.replace(c, obj_val=c.obj_val * factor)
        return out

    monkeypatch.setattr(cert, "certify_ot_basis_batch", altered)


def _certified_vertex(monkeypatch):
    _certificate(monkeypatch, "x", 1 + 1e-7)


def _certified_objective(monkeypatch):
    _certificate(monkeypatch, "obj", 1 + 1e-9)


def _alter_crossover(monkeypatch):
    import smart_crossover_tpu_torch.network_methods.algorithms as alg

    real = alg.network_crossover

    def altered(*a, **kw):
        out = real(*a, **kw)
        x = out.x.copy()
        j = int(np.flatnonzero(out.basis.vbasis == 0)[0])
        x[j] += 1e-7 * (1 + abs(x[j]))
        return dataclasses.replace(out, x=x)

    monkeypatch.setattr(alg, "network_crossover", altered)


BATCH = "dotmark32_batch16"


@pytest.mark.parametrize("name,fault", [
    (BATCH, _unpivoted),
    (BATCH, _device_flows),
    (BATCH, _device_objective),
    (BATCH, _half_batch),
    (BATCH, _certified_vertex),
    (BATCH, _certified_objective),
    ("mnist_single_tnet", _alter_crossover),
    ("goto17_single_cnet", _alter_crossover),
], ids=["batch-k2-basis-unpivoted", "batch-device-flow-altered",
        "batch-device-objective-altered", "batch-half-left-out",
        "batch-certified-vertex-altered",
        "batch-certified-objective-altered",
        "tnet-vertex-altered", "cnet-vertex-altered"])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    cell, res = run_small(name, seconds=0.5)
    ok, checks = correct(cell, res)
    assert not ok, checks


def test_a_request_that_raises_fails_the_run(monkeypatch):
    import importlib

    sk = importlib.import_module("smart_crossover_tpu_torch.solvers.sinkhorn")
    calls = {"n": 0}
    real = sk.sinkhorn

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:           # after the one warm-up request
            raise RuntimeError("planted")
        return real(*a, **kw)

    monkeypatch.setattr(sk, "sinkhorn", flaky)
    cell, res = run_small("mnist_single_tnet", seconds=0.5)
    attempted, failed, _ = cli.verdict(cell, res)
    assert failed >= 1 and res["window"].records[0] is None


@pytest.mark.parametrize("e,over", [(1e-7, True), (1e-9, False)])
def test_a_certified_negative_flow_is_held_to_the_stated_tolerance(e, over):
    """A 2 x 2 transport whose basis {(0, 0), (0, 1), (1, 1)} has the exact
    vertex x01 = -e: ``sign_err`` reads e against the certificate's
    absolute 1e-8, and the vertex's arithmetic (``vertex_err``) stays
    exact."""
    from benchmark.reference import network_lp as ref

    s, d = np.array([0.5, 0.5]), np.array([0.5 + e, 0.5 - e])
    net = ref.ot_network(s, d, np.array([[1.0, 2.0], [2.0, 1.0]]))
    basic = np.array([0, 1, 3])
    x = np.array([0.5 + e, -e, 0.0, 0.5])
    limits = spec.load_cell(BATCH).traffic["limits"]
    nums = ref.judge_ot_basis(net, basic, float(net.c @ x), x, True,
                              float(net.c @ x), x)
    assert nums["sign_err"] == pytest.approx(e, rel=1e-6)
    assert (nums["sign_err"] > limits["sign_err"]) is over
    assert nums["vertex_err"] <= 1e-15 and nums["device_err"] >= e
    uncertified = ref.judge_ot_basis(net, basic, float(net.c @ x), x)
    assert uncertified["sign_err"] == 0.0
