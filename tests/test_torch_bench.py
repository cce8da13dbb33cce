"""The port's benchmark (``smart_crossover_tpu_torch/bench.py``) against
the root ``bench.py`` and the JAX pipeline, on the CPU.

The batch generator and the host baseline equal the root file's bit for
bit; the benchmark's pipeline (plain versions on the CPU) certifies the
reduced CPU row with the JAX package's certified objectives; the CLI's
``bench --device cpu`` prints its result line and loads no JAX module;
without a card and without ``--device cpu`` it exits non-zero with no
result.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as root_bench
from smart_crossover_tpu.network_methods.certify import (
    certify_ot_basis_batch as j_certify,
)
from smart_crossover_tpu.parallel.batched import (
    batched_tnet_exact_device as j_exact,
)
from smart_crossover_tpu_torch import bench
from smart_crossover_tpu_torch.network_methods.certify import (
    certify_ot_basis_batch,
)
from smart_crossover_tpu_torch.parallel.batched import (
    batched_tnet_exact_device,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(reg=bench.REG, sinkhorn_iters=bench.SINKHORN_ITERS,
          max_pivots=bench.MAX_PIVOTS)
# one thread, in this process and in the CLI's: thousands of small torch
# ops, beside other test workers on the same cores
ONE_THREAD = dict(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                  OPENBLAS_NUM_THREADS="1")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape, seed", [((3, 16, 16), 0),
                                         ((2, 36, 49), 5)])
def test_batch_and_baseline_equal_root_bench(shape, seed):
    ours = bench.make_batch(*shape, seed=seed)
    ref = root_bench.make_batch(*shape, seed=seed)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    s, d, M = (a[0] for a in ref)
    np.testing.assert_array_equal(
        bench.cpu_reference_pipeline(s, d, M, reg=0.01, sinkhorn_iters=150),
        root_bench.cpu_reference_pipeline(s, d, M, reg=0.01,
                                          sinkhorn_iters=150))


@pytest.mark.parametrize("seed", [0, 3])
def test_cpu_row_certifies_with_jax_objectives(seed):
    """The CPU row's call (8 x 64^2, f32 inputs, the benchmark's reg,
    iterations and pivot cap): 8/8 certified, the certified objectives
    equal to those of the JAX pipeline and certifier to 1e-9.  Pivot
    counts are reported, not matched."""
    s64, d64, M64 = bench.make_batch(*bench.CPU_ROW[:3], seed=seed)
    s, d, M = (a.astype(np.float32) for a in (s64, d64, M64))
    out = batched_tnet_exact_device(s, d, M, device="cpu", **KW)
    jout = j_exact(s, d, M, **KW)
    certs = certify_ot_basis_batch(out[5].numpy(), s64, d64, M64)
    jcerts = j_certify(np.asarray(jout[5]), s64, d64, M64)
    assert sum(c.ok for c in certs) == 8 and all(c.ok for c in jcerts)
    assert bool(out[4].all())
    np.testing.assert_allclose([c.obj_val for c in certs],
                               [c.obj_val for c in jcerts], rtol=1e-9)
    print("pivots port", out[3].tolist(), "jax", np.asarray(jout[3]).tolist())


def test_stage_split_runs_the_pipeline():
    """The staged pass calls the stages of batched_tnet_exact_device: the
    same push iterations and pivots per instance, a time for each stage."""
    s, d, M = (a.astype(np.float32) for a in bench.make_batch(3, 36, 36, 2))
    kw = dict(KW, sinkhorn_iters=200)
    ms, push, piv = bench.stage_split(s, d, M, **kw, device="cpu")
    out = batched_tnet_exact_device(s, d, M, device="cpu", **kw)
    assert tuple(ms) == bench.STAGES and all(v >= 0 for v in ms.values())
    np.testing.assert_array_equal(push.numpy(), out[2].numpy())
    np.testing.assert_array_equal(piv.numpy(), out[3].numpy())


@pytest.mark.parametrize("argv, env, want", [
    ([], {}, [("ot_64x256x256", 64, 0, 9, 2),
              ("ot_16x784x784", 16, 1, 5, 1)]),
    (["--seed", "5"], {}, [("ot_64x256x256", 64, 5, 9, 2),
                           ("ot_16x784x784", 16, 6, 5, 1)]),
    (["--cell", "ot_16x784x784", "--seed", "2"], {},
     [("ot_16x784x784", 16, 3, 5, 1)]),
    ([], {"SCX_BENCH_SKIP_784": "1"}, [("ot_64x256x256", 64, 0, 9, 2)]),
    (["--device", "cpu", "--seed", "3"], {},
     [("ot_64x256x256", 8, 3, 9, 2)]),
    (["--cell", "serve_16x128x128x16", "--seed", "1"], {},
     [("serve_16x128x128x16", 16, 1, 16, 2)]),
    (["--cell", "serve_16x128x128x16", "--seed", "4", "--device", "cpu"],
     {}, [("serve_16x128x128x16", 4, 4, 3, 2)]),
    (["--cell", "goto17_cnet_mcf"], {"SCX_BENCH_SKIP_784": "1"},
     [("goto17_cnet_mcf", 1, 42, 5000, 1)]),
    (["--cell", "goto17_cnet_mcf", "--seed", "2", "--device", "cpu"], {},
     [("goto17_cnet_mcf", 1, 44, 500, 1)]),
    (["--cell", "goto17_irregular_cnet_mcf", "--seed", "1"], {},
     [("goto17_irregular_cnet_mcf", 1, 43, 5000, 1)]),
    (["--cell", "goto17_irregular_cnet_mcf", "--device", "cpu"], {},
     [("goto17_irregular_cnet_mcf", 1, 42, 500, 1)]),
    (["--cell", "ipm_stair_10000x36975"], {},
     [("ipm_stair_10000x36975", 20, 0, 2, 1)]),
    (["--cell", "ipm_stair_10000x36975", "--seed", "3", "--device", "cpu"],
     {}, [("ipm_stair_10000x36975", 2, 3, 2, 1)]),
])
def test_rows(argv, env, want, monkeypatch):
    """The rows a command line runs: the root bench.py's shapes, seeds,
    reps and baseline instances by default; the CPU's reduced row; a row
    that runs only when named (serving: dispatches for reps; GOTO-17: one
    instance, seed 42 + N, 5000 warm iterations, on either class; the
    staircase LP: periods, seed N, two solves, one baseline run)."""
    monkeypatch.delenv("SCX_BENCH_SKIP_784", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ap = argparse.ArgumentParser()
    bench.add_arguments(ap)
    rows = bench.rows_to_run(ap.parse_args(argv))
    assert [(r[0], r[1], r[4], r[5], r[6]) for r in rows] == want
    if argv[:2] in (["--cell", "goto17_cnet_mcf"],
                    ["--cell", "goto17_irregular_cnet_mcf"]):
        # the torus's width
        assert rows[0][2] == rows[0][3] == (16 if "cpu" in argv else 362)
    if argv[:2] == ["--cell", "ipm_stair_10000x36975"]:
        # rows and columns per period: 10,000 x 34,000 structural
        assert rows[0][2:4] == ((20, 60) if "cpu" in argv else (500, 1700))


def test_cpu_refuses_the_784_row():
    ap = argparse.ArgumentParser()
    bench.add_arguments(ap)
    with pytest.raises(SystemExit, match="784"):
        bench.rows_to_run(ap.parse_args(["--device", "cpu",
                                         "--cell", "ot_16x784x784"]))


@pytest.fixture(scope="module")
def cpu_bench():
    """The CLI's `bench --device cpu` in a fresh process; its return code,
    stdout and the JAX modules loaded after it ran."""
    code = ("import json, sys\n"
            "from smart_crossover_tpu_torch.__main__ import main\n"
            "rc = main(['bench', '--device', 'cpu'])\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.split('.')[0] in "
            "('smart_crossover_tpu', 'bench')]\n"
            "print(json.dumps({'rc': rc, 'bad': bad}), file=sys.stderr)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(ONE_THREAD)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stderr.strip().splitlines()[-1]), r.stdout


def test_cli_bench_cpu_prints_result(cpu_bench):
    status, stdout = cpu_bench
    assert status["rc"] == 0
    res = json.loads(stdout.strip().splitlines()[-1])
    assert res["metric"] == "certified_exact_ot_crossover_throughput"
    assert res["unit"] == "instances/s/chip"
    assert res["value"] > 0 and res["vs_baseline"] > 0
    det = res["detail"]
    assert det["backend"] == "cpu" and det["fallback"] is False
    assert "NOT comparable" in det["note"]
    assert det["all_certified"] and det["n_certified"] == det["batch"] == 8
    assert det["all_optimal_device"] and det["correct"]
    assert det["device_obj_max_rel_to_certified"] <= bench.OBJ_RTOL
    assert tuple(det["stage_ms"]) == bench.STAGES
    assert set(det["layers"]) == {
        "device_stage_ms", "certify_ms", "sinkhorn_kernel_ms",
        "simplex_kernel_ms", "push_ms", "tree_solve_ms", "boruvka_ms",
        "simplex_setup_ms"}
    assert len(det["device_stage_ms_all"]) == 9
    assert "mnist_784" not in det
    # the plain versions ran: no kernel launched
    assert not any(det["launches"].values())


def test_cli_bench_loads_no_jax(cpu_bench):
    status, _ = cpu_bench
    assert status["bad"] == []


def test_bench_without_card_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
