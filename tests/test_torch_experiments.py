"""The paper's experiment drivers on the PyTorch port against the JAX
repo's, on the CPU.

``scripts/torch_run_network_crossover.py`` and
``scripts/torch_run_perturb_crossover.py`` run the protocols of
``scripts/run_network_crossover.py`` and
``scripts/run_perturb_crossover.py``; each pair fills two result stores
from the same instances, and the stores hold the same (instance, method)
records with the same statuses and objectives (1e-9; iteration counts are
the host copies' and equal too, where the paths are host code).
``scripts/torch_make_results_md.py`` renders the stores to the same
markdown as ``scripts/make_results_md.py``, byte for byte.  The drivers'
command lines with ``--device cpu`` exit 0 and load no JAX module; without
a card and without ``--device cpu`` they stop before any work.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from smart_crossover_tpu.data import ResultStore as JStore
from smart_crossover_tpu.data import mcf_gen as j_mcf_gen
from smart_crossover_tpu.data import ot_gen as j_ot_gen
from smart_crossover_tpu.data.lp_gen import optlp_scale_suite as j_suite
from smart_crossover_tpu.solvers.settings import SolverSettings as JSettings
from smart_crossover_tpu_torch.data import ResultStore
from smart_crossover_tpu_torch.data.dimacs_write import write_dimacs_min
from smart_crossover_tpu_torch.data.lp_gen import optlp_scale_suite
from smart_crossover_tpu_torch.data.mcf_gen import goto_like_mcf
from smart_crossover_tpu_torch.data.ot_gen import mnist_like_ot_suite
from smart_crossover_tpu_torch.solvers.settings import SolverSettings
from tests.test_torch_network_simplex import same_native_core  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJ_RTOL = 1e-9          # the port's exact objectives against the JAX ones
HIGHS_RTOL = 1e-8        # the perturbation arms against HiGHS
ONE_THREAD = dict(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                  OPENBLAS_NUM_THREADS="1")
METHODS = ["tnet", "cnet_ot", "cnet_mcf"]
STAIR = dict(num_per_family=1, scale=0.01, families=("stair",))

pytestmark = pytest.mark.usefixtures("same_native_core")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def net():
    return _script("run_network_crossover"), \
        _script("torch_run_network_crossover")


@pytest.fixture(scope="module")
def ptb():
    return _script("run_perturb_crossover"), \
        _script("torch_run_perturb_crossover")


def records(store):
    """{(instance, method): row} without the wall-clock fields."""
    return {(r["instance"], r["method"]):
            {k: v for k, v in r.items() if k not in ("ts", "runtime")}
            for r in store.rows()}


def assert_same_records(ours, ref, rtol=OBJ_RTOL, same_iters=True):
    assert set(ours) == set(ref)
    for key, r in ref.items():
        o = ours[key]
        assert o["status"] == r["status"], key
        if r.get("obj_val") is not None:
            assert o["obj_val"] == pytest.approx(
                r["obj_val"], rel=rtol, abs=rtol), key
        if same_iters:
            for k in ("iter_count", "bar_iter_count"):
                assert o.get(k) == r.get(k), (key, k)


def ot_pair():
    """One 8 x 8 MNIST-like OT pair from each package."""
    (ours,) = mnist_like_ot_suite(num_pairs=1, side=8)
    (ref,) = j_ot_gen.mnist_like_ot_suite(num_pairs=1, side=8)
    np.testing.assert_array_equal(ours.M, ref.M)
    return ours, ref


def goto16():
    ours = goto_like_mcf(16, 16, extra_arc_factor=4, seed=42, regular=True)
    ref = j_mcf_gen.goto_like_mcf(16, 16, extra_arc_factor=4, seed=42,
                                  regular=True)
    return ours, ref


@pytest.fixture(scope="module", params=["crossover", "total"])
def network_stores(request, net, tmp_path_factory):
    """Both drivers' stores after one OT pair and one GOTO-16 MCF in one
    mode."""
    j_net, t_net = net
    tmp = tmp_path_factory.mktemp(f"net_{request.param}")
    stores = ResultStore(tmp / "port.jsonl"), JStore(tmp / "jax.jsonl")
    settings = (SolverSettings(log_console=0, simplexPricing="SE"),
                JSettings(log_console=0, simplexPricing="SE"))
    for (ours, ref) in (ot_pair(), goto16()):
        if request.param == "crossover":
            t_net.run_instance(ours.name, ours, METHODS, stores[0],
                               settings[0], 1e-4, device="cpu")
            j_net.run_instance(ref.name, ref, METHODS, stores[1],
                               settings[1], 1e-4)
        else:
            t_net.run_total(ours.name, ours, METHODS, stores[0],
                            settings[0], device="cpu")
            j_net.run_total(ref.name, ref, METHODS, stores[1], settings[1])
    return request.param, stores


def test_network_driver_records_equal_jax(network_stores):
    """The same (instance, method) records, statuses and objectives
    (1e-9); the iteration counts are reported, not matched."""
    mode, (ours, ref) = network_stores
    got, want = records(ours), records(ref)
    assert_same_records(got, want, same_iters=False)
    methods = {m for _, m in want}
    if mode == "crossover":
        assert methods == {"barrier_crossover", "tnet", "cnet_ot",
                           "cnet_mcf"}
    else:
        assert methods == {"cold_network_simplex", "total_tnet",
                           "total_cnet_ot", "total_cnet_mcf"}
    assert all(r["status"] == "OPTIMAL" for r in got.values())


def test_network_driver_crossovers_equal_their_baselines(network_stores):
    """Every crossover method lands on its instance's baseline objective
    (the barrier's crossover, or the cold network simplex)."""
    mode, (ours, _) = network_stores
    base = "barrier_crossover" if mode == "crossover" \
        else "cold_network_simplex"
    got = records(ours)
    for (inst, method), r in got.items():
        ref = got[(inst, base)]["obj_val"]
        assert r["obj_val"] == pytest.approx(ref, rel=OBJ_RTOL), method


def test_network_driver_summary_table(network_stores, net, capsys):
    """The closing table of both drivers over their stores: the same
    methods, counts and failures."""
    _, (ours, ref) = network_stores
    from smart_crossover_tpu.analysis import summarize as j_summarize
    from smart_crossover_tpu_torch.analysis import summarize

    s_ours, s_ref = summarize(ours), j_summarize(ref)
    assert set(s_ours) == set(s_ref)
    for k, v in s_ref.items():
        assert s_ours[k]["num_instances"] == v["num_instances"]
        assert s_ours[k]["num_failed"] == v["num_failed"] == 0


def test_network_total_runs_k1_once_per_ot_pair(net, tmp_path,
                                                monkeypatch):
    """`total` mode's OT warm start is one sinkhorn(ot) call, B = 1, at
    the given device."""
    _, t_net = net
    calls = []
    real = t_net.sinkhorn

    def spy(ot, *a, **k):
        calls.append((ot.M.shape, k.get("device")))
        return real(ot, *a, **k)

    monkeypatch.setattr(t_net, "sinkhorn", spy)
    ours, _ = ot_pair()
    t_net.run_total(ours.name, ours, METHODS, ResultStore(tmp_path / "s"),
                    SolverSettings(log_console=0), device="cpu")
    assert calls == [(ours.M.shape, "cpu")]


@pytest.fixture(scope="module")
def perturb_stores(ptb, tmp_path_factory):
    j_ptb, t_ptb = ptb
    tmp = tmp_path_factory.mktemp("ptb")
    stores = ResultStore(tmp / "port.jsonl"), JStore(tmp / "jax.jsonl")
    t_ptb.run_suite([(lp.name, (lambda _lp=lp: _lp))
                     for lp in optlp_scale_suite(**STAIR)], stores[0],
                    1e-10, 1e-6, oracle=True, device="cpu")
    j_ptb.run_suite([(lp.name, (lambda _lp=lp: _lp))
                     for lp in j_suite(**STAIR)], stores[1], 1e-10, 1e-6,
                    oracle=True)
    return tmp, stores


def test_perturb_driver_records_equal_jax(perturb_stores):
    _, (ours, ref) = perturb_stores
    got, want = records(ours), records(ref)
    assert {m for _, m in want} == {"highs", "ptb", "ori"}
    assert_same_records(got, want)


def test_perturb_driver_arms_equal_highs(perturb_stores):
    _, (ours, _) = perturb_stores
    got = records(ours)
    for inst in {i for i, _ in got}:
        ref = got[(inst, "highs")]["obj_val"]
        for arm in ("ptb", "ori"):
            assert got[(inst, arm)]["status"] == "OPTIMAL"
            assert got[(inst, arm)]["obj_val"] == pytest.approx(
                ref, rel=HIGHS_RTOL, abs=HIGHS_RTOL), arm


def test_perturb_driver_resumes(perturb_stores, ptb):
    """A second run over the same store solves nothing again."""
    tmp, (ours, _) = perturb_stores
    _, t_ptb = ptb
    before = list(ours.rows())

    def boom():
        raise AssertionError("a solved instance was built again")

    t_ptb.run_suite([(lp.name, boom) for lp in optlp_scale_suite(**STAIR)],
                    ours, 1e-10, 1e-6, oracle=True, device="cpu")
    assert list(ours.rows()) == before


def test_results_md_equal_jax(perturb_stores, network_stores, tmp_path):
    """The report of the same stores is the same markdown, byte for
    byte."""
    _, (p_ours, _) = perturb_stores
    _, (n_ours, _) = network_stores
    j_md, t_md = _script("make_results_md"), _script("torch_make_results_md")
    goto = tmp_path / "goto.json"
    goto.write_text("seed=42\n" + json.dumps({
        "regular": False, "rows": [{}, {}, {}], "geo_cold_s": 12.5,
        "geo_e2e_steady_s": 5.25, "geo_e2e_incl_compile_s": 6.0,
        "geo_cold_pivots": 979969.0, "geo_crossover_pivots": 322395.0,
        "all_match": True}) + "\n")
    out = {}
    for tag, mod in (("jax", j_md), ("port", t_md)):
        md = tmp_path / tag / "RESULTS.md"
        mod.main(str(p_ours.path), str(md), str(tmp_path / tag / "fig"),
                 str(n_ours.path), str(n_ours.path), str(goto))
        out[tag] = md.read_bytes()
    assert out["port"] == out["jax"]
    assert b"GOTO-17" in out["port"] and b"irregular" in out["port"]


# -------------------------------------------------------------- the CLIs

def _cli(script, args, tmp_path):
    """A driver's command line in a fresh process: (rc, stdout, the JAX
    modules loaded when it ended)."""
    code = ("import json, runpy, sys\n"
            f"sys.argv = [{script!r}] + {args!r}\n"
            "rc = 0\n"
            "try:\n"
            f"    runpy.run_path({script!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code or 0\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.split('.')[0] == "
            "'smart_crossover_tpu']\n"
            "print(json.dumps({'rc': rc, 'bad': bad}), file=sys.stderr)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(ONE_THREAD)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stderr.strip().splitlines()[-1]), r.stdout


@pytest.mark.parametrize("mode", ["crossover", "total"])
def test_network_cli_cpu(mode, tmp_path):
    """`--problem mcf` on a GOTO-16 .min file in --data-dir."""
    data = tmp_path / "data"
    data.mkdir()
    write_dimacs_min(goto16()[0], data / "goto16.min")
    results = tmp_path / "net.jsonl"
    status, stdout = _cli(
        os.path.join(REPO, "scripts", "torch_run_network_crossover.py"),
        ["--problem", "mcf", "--test-object", mode, "--data-dir",
         str(data), "--results", str(results), "--device", "cpu"],
        tmp_path)
    assert status == {"rc": 0, "bad": []}
    rows = list(ResultStore(results).rows())
    assert rows and all(r["status"] == "OPTIMAL" for r in rows)
    assert "geo_rt(s)" in stdout


def test_perturb_cli_cpu(tmp_path):
    results = tmp_path / "ptb.jsonl"
    status, stdout = _cli(
        os.path.join(REPO, "scripts", "torch_run_perturb_crossover.py"),
        ["--generate", "optlp", "--scale", "0.01", "--families", "stair",
         "--num-per-family", "1", "--oracle", "--results", str(results),
         "--device", "cpu"], tmp_path)
    assert status == {"rc": 0, "bad": []}
    assert {r["method"] for r in ResultStore(results).rows()} == {
        "highs", "ptb", "ori"}
    assert "ptb vs ori" in stdout


def test_results_md_cli_loads_no_jax(perturb_stores, tmp_path):
    _, (p_ours, _) = perturb_stores
    status, stdout = _cli(
        os.path.join(REPO, "scripts", "torch_make_results_md.py"),
        [str(p_ours.path), str(tmp_path / "R.md"), str(tmp_path / "fig")],
        tmp_path)
    assert status == {"rc": 0, "bad": []}
    assert (tmp_path / "R.md").read_text().startswith(
        "# optLP-scale perturbation-crossover results")


@pytest.mark.parametrize("script, main_args", [
    ("torch_run_network_crossover", {}),
    ("torch_run_perturb_crossover", {"generate": "optlp", "scale": 0.01}),
])
def test_driver_without_card_stops(script, main_args, tmp_path, monkeypatch):
    """Without a card and without --device cpu the script raises before
    it writes a record, as the port's entry points do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _script(script)
    results = tmp_path / "r.jsonl"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(results=str(results), **main_args)
    assert not results.exists()
