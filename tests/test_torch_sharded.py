"""The port's mesh-sharded pipelines against the JAX package's.

One gloo job per mesh width (1, 2 and 4 ranks, module-scoped): each rank
(``tests/torch_sharded_worker.py``, torch only) runs every sharded function
of ``smart_crossover_tpu_torch.parallel`` in float64 on the CPU and writes
its results; each test here holds every rank's results to the JAX sharded
function run in this process on a mesh of the same width over the
conftest's virtual CPU devices.  The ranks meet on a FileStore in a
temporary directory, one torch thread each, and a job that does not end
in time is killed and fails.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
from scipy.optimize import linprog

from smart_crossover_tpu.parallel import (
    batched_tnet_exact as j_batched_tnet_exact,
    make_mesh as j_make_mesh,
    sharded_batched_tnet as j_sharded_batched_tnet,
    sharded_batched_tnet_exact_device as j_sharded_exact_device,
    sharded_mcf_flow_indicators as j_sharded_ranking,
    sharded_pdhg as j_sharded_pdhg,
    sharded_projector as j_sharded_projector,
    sharded_sinkhorn_plan as j_sharded_sinkhorn_plan,
    sharded_sorted_flows as j_sharded_sorted_flows,
    sharded_tnet_single as j_sharded_tnet_single,
)
from smart_crossover_tpu.parallel.scenarios import (
    lp_scenario_sweep as j_lp_scenario_sweep,
    mcf_scenario_sweep as j_mcf_scenario_sweep,
)
from smart_crossover_tpu.solvers.ipm_fleet import (
    ipm_big as j_ipm_big,
    ipm_fleet as j_ipm_fleet,
)
from smart_crossover_tpu_torch.network_methods.certify import (
    certify_ot_basis_batch,
)
from tests.torch_sharded_worker import CASES, ENGINES, TNET_CASES

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_sharded_worker.py"
WIDTHS = (1, 2, 4)
JOB_TIMEOUT_S = 240

# float64 on both sides; the sums run in other orders (gloo, XLA)
PROJ_ATOL = 1e-10       # CG at tol 1e-12 (at 1e-8 iterates drift ~3e-9)
PLAN_ATOL = 1e-10       # the Sinkhorn plan
RANK_ATOL = 1e-10       # the MCF flow indicators
PDHG_ATOL = 1e-8        # x and y after 1000 fixed-step iterations
TNET_ATOL = 1e-9        # the sharded TNET vertex (same tree, same pushes)
BTNET_ATOL = 1e-9       # the batch-sharded TNET vertices and objectives
OBJ_RTOL = 1e-9         # certified / exact objectives
IPM_ATOL = 1e-8         # the fleet barrier's iterates (equal iterations)
HIGHS_RTOL = 1e-6       # the fleet barrier's objectives vs HiGHS (the
                        # JAX package's bound in tests/test_scenarios.py)
VERTEX_RTOL = 1e-7      # exact vertices vs HiGHS


@pytest.fixture(scope="module", params=WIDTHS, ids=lambda w: f"w{w}")
def job(request, tmp_path_factory):
    """(width, [results of rank 0, ..., rank width-1])."""
    w = request.param
    tmp = tmp_path_factory.mktemp(f"sharded_w{w}")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(w), str(tmp / "store"),
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=REPO) for r in range(w)]
    deadline = time.monotonic() + JOB_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {w}-rank gloo job did not end in "
                    f"{JOB_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}/{w}: rc {p.returncode}\n{err}"
    return w, [dict(np.load(tmp / f"r{r}.npz")) for r in range(w)]


def _meshes(w):
    """The JAX meshes of the worker's: (1, w) model, (w, 1) batch."""
    devs = jax.devices()[:w]
    return (j_make_mesh(n_batch=1, n_model=w, devices=devs),
            j_make_mesh(n_batch=w, n_model=1, devices=devs))


def test_workers_never_import_jax(job):
    for res in job[1]:
        assert res["jax_imported"].size == 0, res["jax_imported"]
        assert res["errors"].size == 0, res["errors"]


def test_projector_matches_jax(job):
    w, results = job
    (Y, v), kw = CASES["projector"]
    want = np.asarray(j_sharded_projector(_meshes(w)[0], Y, v, **kw))
    for res in results:
        np.testing.assert_allclose(res["projector"], want, rtol=0,
                                   atol=PROJ_ATOL)
    assert np.linalg.norm(Y @ want) < 1e-9 * np.linalg.norm(Y @ v)


def test_sinkhorn_plan_matches_jax(job):
    w, results = job
    (s, d, M), kw = CASES["sinkhorn"]
    want = np.asarray(j_sharded_sinkhorn_plan(_meshes(w)[0], s, d, M, **kw))
    for res in results:
        np.testing.assert_allclose(res["sinkhorn"], want, rtol=0,
                                   atol=PLAN_ATOL)


def test_ranking_matches_jax(job):
    w, results = job
    args, _ = CASES["ranking"]
    mesh = _meshes(w)[0]
    want = np.asarray(j_sharded_ranking(mesh, *args))
    queue, ind = j_sharded_sorted_flows(mesh, *args)
    for res in results:
        np.testing.assert_allclose(res["ranking"], want, rtol=0,
                                   atol=RANK_ATOL)
        np.testing.assert_allclose(res["ranking_sorted_ind"], ind, rtol=0,
                                   atol=RANK_ATOL)
        np.testing.assert_array_equal(res["ranking_queue"], queue)


@pytest.mark.parametrize("case", ["pdhg_eq", "pdhg_mixed"])
def test_pdhg_matches_jax(job, case):
    w, results = job
    (A, b, c, l, u, sense), kw = CASES[case]
    x, y = j_sharded_pdhg(_meshes(w)[0], A, b, c, l, u, sense, **kw)
    for res in results:
        np.testing.assert_allclose(res[case + "_x"], x, rtol=0,
                                   atol=PDHG_ATOL)
        np.testing.assert_allclose(res[case + "_y"], y, rtol=0,
                                   atol=PDHG_ATOL)


@pytest.mark.parametrize("case", TNET_CASES)
def test_tnet_single_matches_jax(job, case):
    """The same vertex, tree support and push count on every rank."""
    w, results = job
    (s, d, M), kw = CASES[case]
    X, push = j_sharded_tnet_single(_meshes(w)[0], s, d, M, **kw)
    for res in results:
        np.testing.assert_allclose(res[case + "_X"], X, rtol=0,
                                   atol=TNET_ATOL)
        np.testing.assert_array_equal(res[case + "_X"] > 1e-10, X > 1e-10)
        assert int(res[case + "_push"]) == push
    Xp = results[0][case + "_X"]
    np.testing.assert_allclose(Xp.sum(1), s, atol=1e-8)
    np.testing.assert_allclose(Xp.sum(0), d, atol=1e-8)
    assert Xp.min() >= -1e-10 and (Xp > 1e-10).sum() <= sum(M.shape) - 1


def test_batched_tnet_matches_jax(job):
    w, results = job
    (s, d, M), kw = CASES["btnet"]
    X, push, obj = j_sharded_batched_tnet(_meshes(w)[1], s, d, M, **kw)
    for res in results:
        np.testing.assert_allclose(res["btnet_X"], np.asarray(X), rtol=0,
                                   atol=BTNET_ATOL)
        np.testing.assert_allclose(res["btnet_obj"], np.asarray(obj),
                                   rtol=BTNET_ATOL)
        np.testing.assert_array_equal(res["btnet_push"], np.asarray(push))


@pytest.fixture(scope="module")
def exact_jax():
    """The JAX batch-sharded exact route ('parent', on an 8-wide batch
    mesh) and its certified objectives; the host route's objectives."""
    (s, d, M), kw = CASES["exact"]
    mesh = j_make_mesh(n_batch=8, n_model=1)
    out = j_sharded_exact_device(mesh, s, d, M, max_pivots=500, **kw)
    certs = certify_ot_basis_batch(np.asarray(out[5]), s, d, M)
    assert all(c.ok for c in certs) and np.asarray(out[4]).all()
    _, host_obj, _, host_opt = j_batched_tnet_exact(s, d, M, **kw,
                                                    mesh=mesh)
    assert host_opt.all()
    return np.array([c.obj_val for c in certs]), host_obj


@pytest.mark.parametrize("engine", ENGINES)
def test_exact_device_route_certified(job, exact_jax, engine):
    """Every rank's gathered bases certify in f64 at the JAX route's
    certified objectives."""
    (s, d, M), _ = CASES["exact"]
    for res in job[1]:
        assert res[f"exact_{engine}_optimal"].all()
        certs = certify_ot_basis_batch(res[f"exact_{engine}_Bm"], s, d, M)
        assert all(c.ok for c in certs), [c.reason for c in certs]
        np.testing.assert_allclose([c.obj_val for c in certs], exact_jax[0],
                                   rtol=OBJ_RTOL)


def test_batched_tnet_exact_mesh_matches_jax(job, exact_jax):
    w, results = job
    (s, d, M), kw = CASES["exact"]
    _, obj, _, opt = j_batched_tnet_exact(s, d, M, **kw,
                                          mesh=_meshes(w)[1])
    assert opt.all()
    for res in results:
        assert str(res["exact_host_engine"]) == "host"
        assert res["exact_host_optimal"].all()
        np.testing.assert_allclose(res["exact_host_obj"], obj, rtol=OBJ_RTOL)
        np.testing.assert_allclose(res["exact_host_obj"], exact_jax[1],
                                   rtol=OBJ_RTOL)


@pytest.mark.parametrize("refine", [False, True])
def test_ipm_fleet_batch_branch_matches_jax(job, refine):
    w, results = job
    (A, b, c, l, u), kw = CASES["fleet_batch"]
    want = j_ipm_fleet(A, b, c, l, u, refine=refine, mesh=_meshes(w)[1],
                       **kw)
    tag = f"fleet_batch_{'refined' if refine else 'device'}"
    for res in results:
        np.testing.assert_array_equal(res[tag + "_iters"], want.device_iters)
        np.testing.assert_allclose(res[tag + "_x"], want.x, rtol=0,
                                   atol=IPM_ATOL)
        np.testing.assert_allclose(res[tag + "_y"], want.y, rtol=0,
                                   atol=IPM_ATOL)
        assert list(res[tag + "_status"]) == list(want.status)


def test_ipm_fleet_column_branch_matches_jax(job):
    """B = 1 below the model width (2 and 4): A's columns split over the
    ranks, every reduction over n all-reduced; each rank's x, y and
    iteration count against JAX's column-sharded device stage."""
    w, results = job
    (A, b, c, l, u), kw = CASES["fleet_col"]
    want = j_ipm_fleet(A, b, c, l, u, refine=False, mesh=_meshes(w)[0],
                       **kw)
    for res in results:
        np.testing.assert_array_equal(res["fleet_col_iters"],
                                      want.device_iters)
        np.testing.assert_allclose(res["fleet_col_x"], want.x, rtol=0,
                                   atol=IPM_ATOL)
        np.testing.assert_allclose(res["fleet_col_y"], want.y, rtol=0,
                                   atol=IPM_ATOL)


def test_ipm_big_mesh_matches_jax(job):
    w, results = job
    (A, b, c, l, u), kw = CASES["fleet_col"]
    want = j_ipm_big(A[0], b[0], c[0], l[0], u[0], mesh=_meshes(w)[0], **kw)
    assert want.status == "OPTIMAL"
    for res in results:
        assert str(res["big_status"]) == "OPTIMAL"
        assert int(res["big_device_iters"]) == want.device_iters
        np.testing.assert_allclose(res["big_x"], want.x, rtol=0,
                                   atol=IPM_ATOL)
        np.testing.assert_allclose(float(res["big_obj"]), want.obj_val,
                                   rtol=OBJ_RTOL)


def test_lp_scenario_sweep_mesh_matches_jax_and_highs(job):
    w, results = job
    (A, b_sc, c, l, u), _ = CASES["sweep"]
    want = j_lp_scenario_sweep(A, b_sc[0], c, l, u, b_scenarios=b_sc,
                               mesh=_meshes(w)[1])
    ref = np.array([linprog(c, A_eq=A, b_eq=bk, bounds=list(zip(l, u)),
                            method="highs").fun for bk in b_sc])
    for res in results:
        assert list(res["sweep_status"]) == ["OPTIMAL"] * len(b_sc)
        np.testing.assert_allclose(res["sweep_obj"], want["obj"],
                                   rtol=OBJ_RTOL)
        assert np.all(np.abs(res["sweep_obj"] - ref)
                      < HIGHS_RTOL * (1 + np.abs(ref)))


# ---- host sweeps and the package surface (no process group)

def test_mcf_scenario_sweep_matches_jax_and_highs():
    """tests/test_parallel.py's warm chain on transshipment_mcf(60): the
    JAX objectives, HiGHS on one scenario, and far fewer warm pivots."""
    from smart_crossover_tpu.data.mcf_gen import transshipment_mcf as j_gen
    from smart_crossover_tpu_torch.data.mcf_gen import transshipment_mcf
    from smart_crossover_tpu_torch.parallel import mcf_scenario_sweep

    mcf, jmcf = transshipment_mcf(m=60, seed=2), j_gen(m=60, seed=2)
    bs = np.stack([mcf.b * (1.0 + 0.02 * k) for k in range(6)])
    warm = mcf_scenario_sweep(mcf, b_scenarios=bs, warm_chain=True)
    cold = mcf_scenario_sweep(mcf, b_scenarios=bs, warm_chain=False)
    want = j_mcf_scenario_sweep(jmcf, b_scenarios=bs, warm_chain=True)
    assert warm["status"] == ["OPTIMAL"] * 6
    np.testing.assert_allclose(warm["obj"], want["obj"], rtol=OBJ_RTOL)
    np.testing.assert_allclose(warm["obj"], cold["obj"], rtol=OBJ_RTOL)
    assert warm["pivots"][1:].sum() < 0.5 * cold["pivots"][1:].sum()
    ref = linprog(mcf.c, A_eq=mcf.A.toarray(), b_eq=bs[3],
                  bounds=[(0, ub) for ub in mcf.u], method="highs")
    assert abs(warm["obj"][3] - ref.fun) < 1e-7
    with pytest.raises(ValueError, match="provide"):
        mcf_scenario_sweep(mcf)


def test_lp_scenario_sweep_matches_jax_and_highs():
    """tests/test_scenarios.py's sweep without a mesh on the CPU: the
    fleet barrier and the exact vertices against JAX and HiGHS."""
    from smart_crossover_tpu_torch.parallel import lp_scenario_sweep

    (A, b_sc, c, l, u), _ = CASES["sweep"]
    out = lp_scenario_sweep(A, b_sc[0], c, l, u, b_scenarios=b_sc,
                            device="cpu")
    outv = lp_scenario_sweep(A, b_sc[0], c, l, u, b_scenarios=b_sc,
                             exact_vertices=True, device="cpu")
    want = j_lp_scenario_sweep(A, b_sc[0], c, l, u, b_scenarios=b_sc)
    assert out["status"] == ["OPTIMAL"] * len(b_sc) and outv["optimal"].all()
    np.testing.assert_allclose(out["obj"], want["obj"], rtol=OBJ_RTOL)
    for k, bk in enumerate(b_sc):
        ref = linprog(c, A_eq=A, b_eq=bk, bounds=list(zip(l, u)),
                      method="highs").fun
        assert abs(out["obj"][k] - ref) < HIGHS_RTOL * (1 + abs(ref))
        assert abs(outv["obj"][k] - ref) < VERTEX_RTOL * (1 + abs(ref))


def test_no_multi_device_stub_left():
    """The multi-device names are the ported functions: no source file of
    the port raises NotImplementedError, and each sharded name lives in
    the module of the same name as the JAX package's."""
    import inspect

    import smart_crossover_tpu.parallel as jp
    import smart_crossover_tpu_torch.parallel as tp

    pkg = REPO / "smart_crossover_tpu_torch"
    hits = [str(f) for f in pkg.rglob("*.py")
            if "NotImplementedError" in f.read_text()]
    assert not hits, hits
    for name in jp.__all__:
        jobj = getattr(jp, name)
        if not callable(jobj):
            continue
        tobj = getattr(tp, name)
        assert tobj.__module__.replace("smart_crossover_tpu_torch", "") == \
            jobj.__module__.replace("smart_crossover_tpu", ""), name
        assert "Not ported" not in (inspect.getdoc(tobj) or ""), name
