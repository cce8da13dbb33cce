"""The benchmark's rows that run only when named
(``bench --cell goto17_cnet_mcf``, ``goto17_irregular_cnet_mcf``,
``serve_16x128x128x16``, ``ipm_stair_10000x36975``) against the JAX
repo's scripts and package, on the CPU.

Serving: the batches equal ``scripts/bench_serving.py::make_batch`` bit
for bit, and the reduced CPU row certifies every instance with the
certified objectives of the JAX pipeline (1e-9).  GOTO-17 at width 16, on
the degree-regular and the irregular class: the instance and its ``.min``
file equal the JAX package's, the cold core and CNET_MCF from one warm x
give the JAX package's objectives (1e-9).  The staircase LP at 2 periods
of 20 rows and 60 columns: the instance equals the JAX package's;
``ipm_big`` equals HiGHS (1e-7 (1 + |obj|)) with its host certificate on
the true bounds, and equals the JAX ``ipm_big`` where the LP has no free
column; with free columns the JAX ``ipm_big`` stalls (ROADMAP 3.12).  The
certificate itself on a free column and an infinite bound.  The CLI
prints each row's result line and loads no JAX module; without a card it
prints no result.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as root_bench

from smart_crossover_tpu.data import mcf_gen as j_gen
from smart_crossover_tpu.data.lp_gen import staircase_lp as j_staircase_lp
from smart_crossover_tpu.data.dimacs import read_dimacs_min as j_read
from smart_crossover_tpu.data.dimacs_write import write_dimacs_min as j_write
from smart_crossover_tpu.network_methods.algorithms import (
    network_crossover as j_network_crossover,
)
from smart_crossover_tpu.network_methods.certify import (
    certify_ot_basis_batch as j_certify,
)
from smart_crossover_tpu.parallel.batched import (
    batched_tnet_exact_device as j_exact,
)
from smart_crossover_tpu.solvers import ipm_fleet as j_ipm_fleet
from smart_crossover_tpu.solvers.solving import solve_mcf as j_solve_mcf
from smart_crossover_tpu_torch import (
    bench,
    bench_goto17,
    bench_ipm_stair,
    bench_serving,
)
from smart_crossover_tpu_torch.data.dimacs import read_dimacs_min
from smart_crossover_tpu_torch.data.dimacs_write import write_dimacs_min
from smart_crossover_tpu_torch.data.lp_gen import staircase_lp
from smart_crossover_tpu_torch.data.mcf_gen import goto_like_mcf
from smart_crossover_tpu_torch.network_methods.algorithms import (
    network_crossover,
)
from smart_crossover_tpu_torch.solvers import ipm_fleet
from smart_crossover_tpu_torch.solvers.pdhg_mcf import pdhg_mcf_device
from smart_crossover_tpu_torch.solvers.solving import solve_mcf
from tests.test_torch_network_simplex import same_native_core  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJ_RTOL = 1e-9          # the port's exact objectives against the JAX ones
ONE_THREAD = dict(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                  OPENBLAS_NUM_THREADS="1")
CELLS = ("serve_16x128x128x16", "goto17_cnet_mcf",
         "goto17_irregular_cnet_mcf", "ipm_stair_10000x36975")
MODULES = {"goto17_cnet_mcf": bench_goto17,
           "goto17_irregular_cnet_mcf": bench_goto17,
           "serve_16x128x128x16": bench_serving,
           "ipm_stair_10000x36975": bench_ipm_stair}
WIDTH = bench_goto17.CPU_SHAPE[1]
STAIR = bench_ipm_stair.CPU_SHAPE[:3]      # periods, rows, columns
STAIR_RTOL = bench_ipm_stair.OBJ_RTOL


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    """A script of ``scripts/`` as a module (they import jax only inside
    ``main``)."""
    spec = importlib.util.spec_from_file_location(
        f"_scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- serving

@pytest.mark.parametrize("shape, seed", [((16, 128, 128), 0),
                                         ((16, 128, 128), 15),
                                         ((3, 20, 30), 4),
                                         ((4, 16, 16), 2)])
def test_serving_batches_equal_the_script(shape, seed):
    ours = bench.make_batch(*shape, seed)
    ref = _script("bench_serving").make_batch(*shape, seed)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape, seed", [((3, 16, 16), 0), ((2, 36, 49), 5),
                                         ((4, 64, 64), 1), ((2, 12, 30), 3)])
def test_serving_batches_equal_bench_on_squares(shape, seed):
    """Where the root bench.py's grid runs (side int(sqrt(N)) divides N:
    every square), the script's generator gives its batch."""
    for a, b in zip(_script("bench_serving").make_batch(*shape, seed),
                    root_bench.make_batch(*shape, seed=seed)):
        np.testing.assert_array_equal(a, b)


def test_cpu_serving_row_certifies_with_jax_objectives():
    """The reduced CPU row (4 x 16^2, 3 dispatches): every instance
    certified, optimal on the device; the certified objectives equal
    those of the JAX batched_tnet_exact_device followed by the JAX
    certifier on the same float32 inputs, to 1e-9."""
    B, S, D, _, K, n_base = bench_serving.CPU_SHAPE
    row = bench_serving.run_row(bench_serving.CELL, B, S, D, 7, K, n_base,
                                dev=torch.device("cpu"))
    assert row["correct"] and row["n_certified"] == B * K
    assert row["all_optimal_device"] and row["engine"] == "mega"
    assert len(row["dispatch_ms"]) == K
    jobj = []
    for k in range(K):
        s, d, M = bench.make_batch(B, S, D, 7 + k)
        jout = j_exact(*(a.astype(np.float32) for a in (s, d, M)),
                       reg=bench.REG, sinkhorn_iters=bench.SINKHORN_ITERS,
                       max_pivots=bench.MAX_PIVOTS)
        certs = j_certify(np.asarray(jout[5]), s, d, M)
        assert all(c.ok for c in certs)
        jobj += [c.obj_val for c in certs]
    np.testing.assert_allclose(row["certified_obj"], jobj, rtol=OBJ_RTOL)


# ---------------------------------------------------------------- GOTO-17

@pytest.mark.parametrize("seed", [42, 43, 44])
def test_goto_instance_equals_jax(seed):
    ours = goto_like_mcf(WIDTH, WIDTH, extra_arc_factor=4, seed=seed,
                         regular=True)
    ref = j_gen.goto_like_mcf(WIDTH, WIDTH, extra_arc_factor=4, seed=seed,
                              regular=True)
    for f in ("tails", "heads", "c", "u", "b"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    assert ours.name == ref.name


def test_min_files_byte_identical(tmp_path):
    """The .min file each package writes for the width-16 instance is the
    same bytes, and the port reads back the instance it wrote."""
    ours = goto_like_mcf(WIDTH, WIDTH, extra_arc_factor=4, seed=42,
                         regular=True)
    ref = j_gen.goto_like_mcf(WIDTH, WIDTH, extra_arc_factor=4, seed=42,
                              regular=True)
    write_dimacs_min(ours, tmp_path / "port.min")
    j_write(ref, tmp_path / "jax.min")
    assert (tmp_path / "port.min").read_bytes() == \
        (tmp_path / "jax.min").read_bytes()
    back = read_dimacs_min(tmp_path / "port.min")
    for f in ("tails", "heads", "c", "u", "b"):
        np.testing.assert_array_equal(getattr(back, f), getattr(ours, f))


@pytest.fixture(scope="module")
def goto_pair(tmp_path_factory):
    """The width-16 instance read back from its .min file by each
    package."""
    path = tmp_path_factory.mktemp("goto") / "goto.min"
    write_dimacs_min(goto_like_mcf(WIDTH, WIDTH, extra_arc_factor=4,
                                   seed=42, regular=True), path)
    return read_dimacs_min(path), j_read(path)


@pytest.mark.usefixtures("same_native_core")
def test_goto_cold_objective_equals_jax(goto_pair):
    mcf, jmcf = goto_pair
    out = solve_mcf(mcf, method="network_simplex")
    ref = j_solve_mcf(jmcf, method="network_simplex")
    assert out.status == ref.status == "OPTIMAL"
    assert abs(out.obj_val - ref.obj_val) <= OBJ_RTOL * abs(ref.obj_val)


@pytest.mark.usefixtures("same_native_core")
def test_goto_cnet_mcf_from_one_warm_x_equals_jax(goto_pair):
    """CNET_MCF from the row's warm start (the port's pdhg_mcf_device in
    float32 on the CPU, 500 Halpern iterations) in both packages: the same
    objective, equal to the cold core's."""
    mcf, jmcf = goto_pair
    x, *_ = pdhg_mcf_device(mcf, tol=bench_goto17.WARM_TOL,
                            max_iters=bench_goto17.CPU_SHAPE[4],
                            mode="halpern", dtype=torch.float32,
                            device="cpu")
    out = network_crossover(x=x, mcf=mcf, method="cnet_mcf", device="cpu")
    ref = j_network_crossover(x=x, mcf=jmcf, method="cnet_mcf")
    cold = solve_mcf(mcf, method="network_simplex")
    assert out.status == ref.status == "OPTIMAL"
    assert abs(out.obj_val - ref.obj_val) <= OBJ_RTOL * abs(ref.obj_val)
    assert abs(out.obj_val - cold.obj_val) <= \
        bench_goto17.OBJ_RTOL * (1 + abs(cold.obj_val))


# ---------------------------------------------- GOTO-17, irregular class

def _goto(seed, regular=False):
    return (goto_like_mcf(WIDTH, WIDTH, extra_arc_factor=4, seed=seed,
                          regular=regular),
            j_gen.goto_like_mcf(WIDTH, WIDTH, extra_arc_factor=4, seed=seed,
                                regular=regular))


@pytest.mark.parametrize("seed", [42, 43, 44])
def test_goto_irregular_instance_equals_jax(seed):
    """The irregular class (the script's regular=0): the JAX package's
    arrays, an arc count of its own per seed."""
    ours, ref = _goto(seed)
    for f in ("tails", "heads", "c", "u", "b"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    assert ours.name == ref.name
    assert ours.n != _goto(seed, regular=True)[0].n


def test_goto_irregular_min_files_byte_identical(tmp_path):
    ours, ref = _goto(42)
    write_dimacs_min(ours, tmp_path / "port.min")
    j_write(ref, tmp_path / "jax.min")
    assert (tmp_path / "port.min").read_bytes() == \
        (tmp_path / "jax.min").read_bytes()
    back = read_dimacs_min(tmp_path / "port.min")
    for f in ("tails", "heads", "c", "u", "b"):
        np.testing.assert_array_equal(getattr(back, f), getattr(ours, f))


@pytest.fixture(scope="module")
def goto_irregular_pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("goto_irr") / "goto.min"
    write_dimacs_min(_goto(42)[0], path)
    return read_dimacs_min(path), j_read(path)


@pytest.mark.usefixtures("same_native_core")
def test_goto_irregular_cold_objective_equals_jax(goto_irregular_pair):
    mcf, jmcf = goto_irregular_pair
    out = solve_mcf(mcf, method="network_simplex")
    ref = j_solve_mcf(jmcf, method="network_simplex")
    assert out.status == ref.status == "OPTIMAL"
    assert abs(out.obj_val - ref.obj_val) <= OBJ_RTOL * abs(ref.obj_val)


@pytest.mark.usefixtures("same_native_core")
def test_goto_irregular_cnet_mcf_from_one_warm_x_equals_jax(
        goto_irregular_pair):
    mcf, jmcf = goto_irregular_pair
    x, *_ = pdhg_mcf_device(mcf, tol=bench_goto17.WARM_TOL,
                            max_iters=bench_goto17.CPU_SHAPE[4],
                            mode="halpern", dtype=torch.float32,
                            device="cpu")
    out = network_crossover(x=x, mcf=mcf, method="cnet_mcf", device="cpu")
    ref = j_network_crossover(x=x, mcf=jmcf, method="cnet_mcf")
    cold = solve_mcf(mcf, method="network_simplex")
    assert out.status == ref.status == "OPTIMAL"
    assert abs(out.obj_val - ref.obj_val) <= OBJ_RTOL * abs(ref.obj_val)
    assert abs(out.obj_val - cold.obj_val) <= \
        bench_goto17.OBJ_RTOL * (1 + abs(cold.obj_val))


# ------------------------------------------------------ the staircase LP

def _stair(free=True, seed=0, jax=False):
    """The row's CPU instance in standard form, densified: (lp, A_sp, A,
    b, c, l, u); ``free=False`` draws it with no free column."""
    gen = j_staircase_lp if jax else staircase_lp
    P, r, k = STAIR
    lp = gen(periods=P, rows_per_period=r, vars_per_period=k, seed=seed,
             **({} if free else {"frac_free": 0.0}))
    A_sp = lp.get_standard_A()
    return (lp, A_sp, A_sp.toarray(), lp.b, lp.get_standard_c(),
            *lp.get_standard_bounds())


def _highs(A_sp, b, c, l, u):
    return bench_ipm_stair.highs(A_sp, b, c, l, u)["obj"]


def test_stair_instance_equals_jax():
    ours, ref = _stair(), _stair(jax=True)
    assert ours[0].name == ref[0].name
    for a, r in zip(ours[2:], ref[2:]):
        np.testing.assert_array_equal(a, r)
    assert np.isinf(ours[5]).any() and np.isinf(ours[6]).any()


@pytest.fixture
def device_endgame(monkeypatch):
    """The row's CPU setting: the device endgame asked for."""
    monkeypatch.setenv("SCX_DEVICE_ENDGAME", "1")


@pytest.mark.usefixtures("device_endgame")
@pytest.mark.parametrize("seed", [0, 2])
def test_stair_ipm_big_equals_jax_and_highs_without_free(seed):
    """With no free column (finite lower bounds, some upper bounds
    infinite, on the same wide box in both packages) the port's ipm_big
    takes the JAX one's iterations to the same x (1e-8), both reach
    HiGHS's objective, and the port's pair passes the certificate on the
    true bounds."""
    _, A_sp, A, b, c, l, u = _stair(free=False, seed=seed)
    assert np.isinf(u).any() and np.isfinite(l).all()
    got = ipm_fleet.ipm_big(A, b, c, l, u, tol=1e-8, device="cpu")
    ref = j_ipm_fleet.ipm_big(A, b, c, l, u, tol=1e-8)
    obj = _highs(A_sp, b, c, l, u)
    assert got.status == ref.status == "OPTIMAL"
    assert (got.device_iters, got.endgame_iters) == \
        (ref.device_iters, ref.endgame_iters)
    np.testing.assert_allclose(got.x, ref.x, rtol=0, atol=1e-8)
    assert ipm_fleet.last_ne_stats is not None
    for v in (got.obj_val, ref.obj_val):
        assert abs(v - obj) <= STAIR_RTOL * (1 + abs(obj))
    assert bench_ipm_stair.certificate_ok(bench_ipm_stair.lp_certificate(
        A_sp, b, c, l, u, got.x, got.y))


@pytest.mark.usefixtures("device_endgame")
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stair_free_columns_port_optimal_jax_stalls(seed):
    """ROADMAP 3.12: with free columns the JAX ipm_big's wide box stalls
    (its primal residual stops near 1); the port's ipm_big, which leaves
    a free column unboxed with its scaling at the top, reaches
    HiGHS's objective with a passing certificate and no straggler."""
    _, A_sp, A, b, c, l, u = _stair(seed=seed)
    assert (~np.isfinite(l) & ~np.isfinite(u)).any()
    got = ipm_fleet.ipm_big(A, b, c, l, u, tol=1e-8, device="cpu")
    obj = _highs(A_sp, b, c, l, u)
    assert got.status == "OPTIMAL" and ipm_fleet.last_stragglers == 0
    assert abs(got.obj_val - obj) <= STAIR_RTOL * (1 + abs(obj))
    cert = bench_ipm_stair.lp_certificate(A_sp, b, c, l, u, got.x, got.y)
    assert bench_ipm_stair.certificate_ok(cert), cert
    ref = j_ipm_fleet.ipm_big(A, b, c, l, u, tol=1e-8)
    assert ref.status == "STALLED"
    assert abs(ref.obj_val - obj) > 1e-3 * (1 + abs(obj))


def test_stair_dense_stage_converges_with_free_columns():
    """The device stage alone in float64: the port converges where the
    JAX function's wide box stops unconverged."""
    from smart_crossover_tpu.solvers.ipm_batched import (
        ipm_dense_batched as j_batched,
    )
    from smart_crossover_tpu_torch.solvers.ipm_batched import (
        ipm_dense_batched,
    )

    _, A_sp, A, b, c, l, u = _stair()
    args = (A[None], b[None], c[None], l[None], u[None])
    got = ipm_dense_batched(*args, tol=1e-8, max_iters=60, device="cpu")
    ref = j_batched(*args, tol=1e-8, max_iters=60)
    assert bool(got["converged"][0]) and not bool(ref["converged"][0])
    obj = _highs(A_sp, b, c, l, u)
    assert abs(float(got["obj_val"][0]) - obj) <= STAIR_RTOL * (1 + abs(obj))


def test_certificate_free_column_and_infinite_bound():
    """min x1 + x2 + 0 x3 s.t. x1 - x2 + x3 = 1, x2 + x3 = 2 with x1 in
    [0, 4], x2 >= 0 (u = inf) and x3 free: the optimum x = (0, 0.5, 1.5),
    y = (-0.5, 0.5) passes; a dual that leaves a reduced cost facing the
    free column or the infinite bound is dual infeasible; an x on the
    IPMs' wide box on x2's infinite bound is flagged (a free column has
    no box)."""
    A = np.array([[1.0, -1.0, 1.0], [0.0, 1.0, 1.0]])
    b = np.array([1.0, 2.0])
    c = np.array([1.0, 1.0, 0.0])
    l = np.array([0.0, 0.0, -np.inf])
    u = np.array([4.0, np.inf, np.inf])
    x, y = np.array([0.0, 0.5, 1.5]), np.array([-0.5, 0.5])
    cert = bench_ipm_stair.lp_certificate(A, b, c, l, u, x, y)
    assert bench_ipm_stair.certificate_ok(cert), cert
    assert cert["primal_obj"] == pytest.approx(0.5)
    assert cert["dual_obj"] == pytest.approx(0.5)
    # y = (0, 0): rc = c, so the free column's rc is 0 but x2's reduced
    # cost 1 sits on its finite lower bound: feasible, with a gap
    cert = bench_ipm_stair.lp_certificate(A, b, c, l, u, x, np.zeros(2))
    assert cert["dual_infeasibility"] == 0.0 and cert["gap"] > 0.1
    # y = (0.5, 0): rc3 = -0.5 faces the free column, rc2 = 1.5 is fine
    cert = bench_ipm_stair.lp_certificate(A, b, c, l, u, x,
                                          np.array([0.5, 0.0]))
    assert cert["dual_infeasibility"] == pytest.approx(
        0.5 / (1 + np.sqrt(2)))
    # y = (-1, 2): rc2 = -2 faces x2's infinite upper bound
    cert = bench_ipm_stair.lp_certificate(A, b, c, l, u, x,
                                          np.array([-1.0, 2.0]))
    assert cert["dual_infeasibility"] > 0.5
    assert not bench_ipm_stair.certificate_ok(cert)
    # a bound violated, the wide box reached
    cert = bench_ipm_stair.lp_certificate(
        A, b, c, l, u, np.array([-1e-3, 0.5, 1.5]), y)
    assert cert["bound_violation"] == pytest.approx(1e-3)
    far = 0.6 * bench_ipm_stair.wide_box(b)
    cert = bench_ipm_stair.lp_certificate(
        A, b, c, l, u, np.array([0.0, far, 1.5]), y)
    assert cert["on_wide_box"] == 1 and not bench_ipm_stair.certificate_ok(
        cert)
    # the free column has no box
    cert = bench_ipm_stair.lp_certificate(
        A, b, c, l, u, np.array([0.0, 0.5, far]), y)
    assert cert["on_wide_box"] == 0


# -------------------------------------------------------------- the CLI

@pytest.fixture(scope="module", params=CELLS)
def cpu_cell(request):
    """`bench --cell <row> --device cpu` in a fresh process: the cell, its
    return code, stdout and the JAX modules loaded after it ran."""
    code = ("import json, sys\n"
            "from smart_crossover_tpu_torch.__main__ import main\n"
            f"rc = main(['bench', '--cell', '{request.param}', "
            "'--device', 'cpu'])\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.split('.')[0] in "
            "('smart_crossover_tpu', 'bench')]\n"
            "print(json.dumps({'rc': rc, 'bad': bad}), file=sys.stderr)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(ONE_THREAD)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return (request.param, json.loads(r.stderr.strip().splitlines()[-1]),
            r.stdout)


def test_cli_cell_cpu_prints_result(cpu_cell):
    cell, status, stdout = cpu_cell
    assert status["rc"] == 0
    lines = [json.loads(x) for x in stdout.strip().splitlines()]
    res = lines[-1]
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "detail"}
    det = res["detail"]
    assert det["backend"] == "cpu" and det["fallback"] is False
    assert "NOT comparable" in det["note"] and det["correct"]
    assert res["value"] > 0 and res["vs_baseline"] > 0
    assert not any(det["launches"].values())    # the plain versions ran
    if cell.startswith("goto17"):
        irregular = cell == "goto17_irregular_cnet_mcf"
        assert res["metric"] == "seconds_to_exact_vertex_goto17" + (
            "_irregular" if irregular else "")
        assert det["regular"] is not irregular
        assert res["unit"] == "s"
        assert [r["goto17"] for r in lines[:-1]] == [
            "instance", "cold", "warm", "crossover"]
        assert det["nodes"] == WIDTH ** 2 and det["warm_iters"] <= 500
        assert det["cold_status"] == det["crossover_status"] == "OPTIMAL"
        assert det["obj_match"] and det["warm_finite"]
        assert res["value"] == pytest.approx(det["warm_steady_s"]
                                             + det["crossover_s"])
        assert det["crossover"]["cg_rounds"] >= 1
        assert det["crossover"]["subproblem_s"] <= det["crossover_s"]
    elif cell == "ipm_stair_10000x36975":
        assert res["metric"] == "ipm_sparse_big_onchip"
        assert res["unit"] == "s" and res["value"] == det["warm_s"]
        assert [r["ipm_stair"] for r in lines[:-1]] == [
            "instance", "first", "warm", "baseline"]
        assert (det["periods"], det["rows_per_period"],
                det["cols_per_period"]) == STAIR
        assert det["m"] == 40 and det["free_columns"] >= 1
        assert det["status"] == "OPTIMAL" and det["device_iters"] > 0
        assert det["ne_stats"] is not None and det["stragglers"] == 0
        assert bench_ipm_stair.certificate_ok(det["certificate"])
        assert det["obj_rel_to_baseline"] <= STAIR_RTOL
        assert det["baseline"]["status"] == "OPTIMAL"
        assert det["highs"] is None         # the oracle is off by default
        assert res["vs_baseline"] == pytest.approx(
            det["baseline"]["s"] / det["warm_s"])
    else:
        assert res["metric"] == "sustained_certified_exact_serving"
        assert res["unit"] == "instances/s"
        assert det["n_certified"] == det["total_instances"] == 12
        assert len(det["dispatch_ms"]) == 3
        assert res["value"] == pytest.approx(
            12 / (det["device_wall_s"] + det["certify_wall_s"]))
        assert lines[0]["serving"] == cell


def test_cli_cell_loads_no_jax(cpu_cell):
    _, status, _ = cpu_cell
    assert status["bad"] == []


@pytest.mark.parametrize("cell", CELLS)
def test_cell_without_card_prints_no_result(cell, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--cell", cell]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


@pytest.mark.parametrize("cell", CELLS)
def test_cell_not_correct_exits_1(cell, monkeypatch, capsys):
    """A row that is not correct prints its result and exits 1."""
    mod = MODULES[cell]
    run_row = mod.run_row
    monkeypatch.setattr(mod, "run_row", lambda *a, **kw: {
        **run_row(*a, **kw), "correct": False})
    assert bench.main(["--cell", cell, "--device", "cpu"]) == 1
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["detail"]["correct"] is False


def test_stair_oracle_option(monkeypatch, capsys):
    """`--oracle` runs the script's HiGHS solve in the staircase row, and
    the row holds its objective to it."""
    assert bench.main(["--cell", "ipm_stair_10000x36975", "--device",
                       "cpu", "--oracle"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    det = json.loads(lines[-1])["detail"]
    assert json.loads(lines[-2])["ipm_stair"] == "highs"
    assert det["highs"]["status"] == 0 and det["correct"]
    assert abs(det["obj"] - det["highs"]["obj"]) <= STAIR_RTOL * (
        1 + abs(det["highs"]["obj"]))
