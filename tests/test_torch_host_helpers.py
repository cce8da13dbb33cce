"""The port's host helpers and package surface against the JAX package's:
the solver caller, file handling, result store, OT generators, analysis
and figures, checkpoints, utils, parameters and the native build (host
copies), the names of every JAX ``__all__``, and the JAX positional
parameter order of every public function present in both packages."""
import gzip
import importlib
import inspect
import pkgutil
import struct

import numpy as np
import pytest
import torch
from scipy.optimize import linprog

import smart_crossover_tpu as J
import smart_crossover_tpu_torch as T
from smart_crossover_tpu import models as jm
from smart_crossover_tpu_torch import models as tm


def _lp(rng, m=6, n=15):
    """As tests/test_caller.py::test_caller_lp_workflow."""
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    kw = dict(A=A, b=b, c=rng.standard_normal(n), l=np.zeros(n),
              u=np.ones(n), sense=np.full(m, "="))
    return jm.GeneralLP(**kw), tm.GeneralLP(**kw)


# ---- solvers/caller.py

def test_solver_caller_matches_jax(rng):
    from smart_crossover_tpu.solvers.caller import (
        generate_solver_caller as j_gen,
    )
    from smart_crossover_tpu_torch.solvers.caller import (
        SolverCaller,
        generate_solver_caller,
    )

    jlp, tlp = _lp(rng)
    j, t = j_gen("GRB"), generate_solver_caller("GRB")
    j.read_genlp(jlp)
    t.read_genlp(tlp)
    j.run_barrier()
    t.run_barrier()
    assert t.return_status() == j.return_status() == "OPTIMAL"
    assert t.return_obj_val() == pytest.approx(j.return_obj_val(), abs=1e-9)
    np.testing.assert_allclose(t.return_x(), j.return_x(), atol=1e-9)
    ref = linprog(tlp.c, A_eq=tlp.A, b_eq=tlp.b, bounds=(0, 1),
                  method="highs")
    assert t.return_obj_val() == pytest.approx(ref.fun, abs=1e-7)
    warm = SolverCaller()
    warm.read_genlp(tlp)
    warm.add_warm_start_basis(t.return_basis())
    warm.run_primal_simplex()
    assert warm.return_iter_count() <= 1
    assert t.get_A().shape == j.get_A().shape
    with pytest.raises(ValueError):
        generate_solver_caller("XPRESS")
    with pytest.raises(RuntimeError, match="no solve"):
        SolverCaller().return_x()


# ---- data/filehandling.py, data/results.py

def test_file_handler_matches_jax(tmp_path):
    from smart_crossover_tpu.data.filehandling import FileHandler as JFH
    from smart_crossover_tpu_torch.data import random_sparse_lp, write_mps
    from smart_crossover_tpu_torch.data.filehandling import FileHandler

    for k in range(2):
        write_mps(random_sparse_lp(m=20, n=60, seed=k, name=f"lp{k}"),
                  tmp_path / f"lp{k}.mps")
    j, t = JFH(tmp_path), FileHandler(tmp_path)
    assert t.model_paths() == j.model_paths()
    for jl, tl in zip(j.read_all(), t.read_all()):
        assert t.get_model_report(tl) == j.get_model_report(jl)
    assert t.get_model_by_name("lp1").n == 60
    with pytest.raises(FileNotFoundError):
        t.get_model_by_name("nope")
    jw = j.write_presolved_models(tmp_path / "j")
    tw = t.write_presolved_models(tmp_path / "t")
    assert [p.name for p in tw] == [p.name for p in jw]
    for a, b in zip(jw, tw):
        assert a.read_text() == b.read_text()


def _fill(store):
    rng = np.random.default_rng(0)
    for k in range(6):
        base = float(rng.uniform(10, 100))
        store.record(f"inst{k}", "ori", status="OPTIMAL", runtime=base,
                     obj_val=1.0 + k, iter_count=np.int64(10 + k))
        store.record(f"inst{k}", "ptb", status="OPTIMAL", runtime=base / 5,
                     obj_val=1.0 + k + 1e-10)
        store.record(f"inst{k}", "tnet", status="OPTIMAL",
                     runtime=base / 8, obj_val=1.0 + k)
    store.record("inst9", "ori", status="TIME_LIMIT", runtime=3600.0,
                 obj_val=None)
    store.record("inst9", "ptb", status="OPTIMAL", runtime=4.0, obj_val=9.0)
    return store


def _stores(tmp_path):
    from smart_crossover_tpu.data.results import ResultStore as JRS
    from smart_crossover_tpu_torch.data import ResultStore

    return (_fill(JRS(tmp_path / "j" / "r.jsonl")),
            _fill(ResultStore(tmp_path / "t" / "r.jsonl")))


def _rows(store):
    return [{k: v for k, v in r.items() if k != "ts"} for r in store.rows()]


def test_result_store_matches_jax(tmp_path):
    from smart_crossover_tpu.data.results import (
        read_results_from_pickle as j_read,
    )
    from smart_crossover_tpu_torch.data.results import (
        read_results_from_pickle,
        write_results_to_pickle,
    )

    j, t = _stores(tmp_path)
    assert _rows(t) == _rows(j)
    assert t.solved() == j.solved() and t.solved("ptb") == j.solved("ptb")
    assert t.is_solved("inst9", "ori") and not t.is_solved("inst9", "tnet")
    obj = {"a": np.arange(3), "b": [1, 2]}
    write_results_to_pickle(obj, tmp_path / "p" / "r.pkl")
    for read in (read_results_from_pickle, j_read):
        back = read(tmp_path / "p" / "r.pkl")
        np.testing.assert_array_equal(back["a"], obj["a"])


# ---- data/ot_gen.py

def _same_ot(a, b):
    assert a.name == b.name
    for k in ("s", "d", "M"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_ot_generators_match_jax():
    from smart_crossover_tpu.data import ot_gen as j
    from smart_crossover_tpu_torch.data import ot_gen as t

    np.testing.assert_array_equal(t.synthetic_digits(6, seed=3),
                                  j.synthetic_digits(6, seed=3))
    for a, b in zip(t.mnist_like_ot_suite(3, side=14, amplify=2),
                    j.mnist_like_ot_suite(3, side=14, amplify=2)):
        _same_ot(a, b)
    for a, b in zip(t.random_ot_batch(2, 5, 7, seed=4),
                    j.random_ot_batch(2, 5, 7, seed=4)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        t.grid_l1_cost((3, 4), [0, 5], (2, 2), [1, 3]),
        j.grid_l1_cost((3, 4), [0, 5], (2, 2), [1, 3]))


def _write_idx(path, imgs):
    head = struct.pack(">IIII", 2051, *imgs.shape)
    data = head + imgs.astype(np.uint8).tobytes()
    if path.suffix == ".gz":
        with gzip.open(path, "wb") as fh:
            fh.write(data)
    else:
        path.write_bytes(data)


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_load_mnist_images_from_idx(tmp_path, monkeypatch, suffix):
    """An IDX3 file the test writes (raw and gzipped) loads to the JAX
    package's pixels, and the real-MNIST suite built from it equals the
    JAX package's; a missing path gives None."""
    from smart_crossover_tpu.data import ot_gen as j
    from smart_crossover_tpu_torch.data import ot_gen as t

    monkeypatch.delenv("SCX_MNIST_PATH", raising=False)
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (8, 6, 6)) * (rng.uniform(size=(8, 6, 6))
                                               > 0.5)
    path = tmp_path / f"imgs-idx3-ubyte{suffix}"
    _write_idx(path, imgs)
    got = t.load_mnist_images(str(path))
    np.testing.assert_array_equal(got, j.load_mnist_images(str(path)))
    np.testing.assert_array_equal(got, imgs.astype(np.float64))
    for a, b in zip(t.mnist_ot_suite(3, mnist_path=str(path)),
                    j.mnist_ot_suite(3, mnist_path=str(path))):
        _same_ot(a, b)
    assert t.load_mnist_images(str(tmp_path / "missing")) is None


# ---- analysis

def test_analysis_matches_jax(tmp_path):
    import smart_crossover_tpu.analysis as ja
    import smart_crossover_tpu_torch.analysis as ta

    j, t = _stores(tmp_path)
    assert ta.geo_mean([1.0, 4.0, 9.0]) == ja.geo_mean([1.0, 4.0, 9.0])
    assert ta.fill_timeouts([1.0, None, 3.0], ["OPTIMAL", None, "X"]) == \
        ja.fill_timeouts([1.0, None, 3.0], ["OPTIMAL", None, "X"])
    assert ta.summarize(t) == ja.summarize(j)
    assert ta.compare(t, "ptb", "ori") == ja.compare(j, "ptb", "ori")
    assert ta.table(ta.summarize(t)) == ja.table(ja.summarize(j))
    assert ta.to_dataframe(t).drop(columns="ts").equals(
        ja.to_dataframe(j).drop(columns="ts"))
    assert ta.pivot_table(t).equals(ja.pivot_table(j))


@pytest.mark.parametrize("figure,kw", [
    ("runtime_comparison_figure", dict(ours="ptb", baseline="ori")),
    ("perturb_comparison_figure", {}),
    ("speedup_ratio_figure", {}),
    ("network_comparison_figure", dict(methods=("tnet", "ptb", "ori"))),
])
def test_figures_match_jax(tmp_path, figure, kw):
    """tests/test_analysis_plots.py's store: each figure is written and has
    the JAX package's axes, titles and bar heights."""
    from smart_crossover_tpu.analysis import plots as jp
    from smart_crossover_tpu_torch.analysis import plots as tp

    j, t = _stores(tmp_path)
    fj = getattr(jp, figure)(j, save_to=str(tmp_path / "j.png"), **kw)
    ft = getattr(tp, figure)(t, save_to=str(tmp_path / "t.png"), **kw)
    assert (tmp_path / "t.png").exists()
    assert len(ft.axes) == len(fj.axes)
    for at, aj in zip(ft.axes, fj.axes):
        assert at.get_title() == aj.get_title()
        np.testing.assert_array_equal([p.get_height() for p in at.patches],
                                      [p.get_height() for p in aj.patches])


# ---- utils, checkpoint, parameters, native build

def test_checkpoint_resume_pdhg(rng, tmp_path):
    """tests/test_pdhg.py:101 on the port: checkpoint a short solve's
    iterate, resume ``pdhg_solve`` from it through x0 / y0, finish."""
    from smart_crossover_tpu.utils.checkpoint import load_state as j_load
    from smart_crossover_tpu_torch import pdhg_solve
    from smart_crossover_tpu_torch.utils.checkpoint import (
        load_state,
        save_state,
    )

    m, n = 8, 20
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    c = rng.standard_normal(n)
    part = pdhg_solve(A, b, c, np.zeros(n), np.ones(n), tol=1e-12,
                      max_iters=2000, device="cpu")
    save_state(tmp_path / "ck" / "pdhg.npz", x=part.x, y=part.y)
    st = load_state(tmp_path / "ck" / "pdhg.npz")
    jst = j_load(tmp_path / "ck" / "pdhg.npz")
    np.testing.assert_array_equal(st["x"], part.x)
    np.testing.assert_array_equal(jst["y"], part.y)
    done = pdhg_solve(A, b, c, np.zeros(n), np.ones(n), tol=1e-7,
                      max_iters=200_000, x0=st["x"], y0=st["y"],
                      device="cpu")
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, 1), method="highs")
    assert done.status == "OPTIMAL"
    assert done.obj_val == pytest.approx(ref.fun, abs=1e-4)


def test_utils_and_parameters_match_jax(tmp_path, monkeypatch):
    import smart_crossover_tpu.parameters as jpar
    import smart_crossover_tpu.utils as ju
    import smart_crossover_tpu_torch.parameters as tpar
    import smart_crossover_tpu_torch.utils as tu

    assert tu.get_project_root() == ju.get_project_root()
    assert tu.get_data_dir_path() == ju.get_data_dir_path()
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "pyproject.toml").write_text("")
    monkeypatch.chdir(tmp_path / "a" / "b")
    assert tu.get_project_root() == tmp_path == ju.get_project_root()
    assert tu.Timer is T.Timer
    for name in dir(jpar):
        if name.isupper():
            assert getattr(tpar, name) == getattr(jpar, name), name


def test_native_build_into_build_dir(capsys):
    from smart_crossover_tpu_torch import native
    from smart_crossover_tpu_torch.native.build import build

    path = build()
    assert path == native.library_path() and path.exists()
    assert path.parent.name == "smart_crossover_tpu_torch"
    assert path.parent.parent.name == "build"
    assert "netsimplex.cpp" in capsys.readouterr().out


# ---- the package surface

SURFACES = ["", ".solvers", ".ops", ".parallel", ".data"]


@pytest.mark.parametrize("sub", SURFACES)
def test_jax_all_names_resolve(sub):
    """Every name of the JAX package's ``__all__`` resolves in the port to
    the same kind of object, a function for a function, even after every
    submodule of the port was imported (a submodule of the same name must
    not take the function's place); each multi-device name is the function
    of the port's module of the JAX function's module name."""
    for m in pkgutil.walk_packages(T.__path__, T.__name__ + "."):
        importlib.import_module(m.name)
    jmod = importlib.import_module("smart_crossover_tpu" + sub)
    tmod = importlib.import_module("smart_crossover_tpu_torch" + sub)
    assert set(jmod.__all__) <= set(tmod.__all__)
    for name in jmod.__all__:
        obj, jobj = getattr(tmod, name), getattr(jmod, name)
        assert not inspect.ismodule(obj), f"{sub}.{name} is a module"
        if not inspect.ismodule(jobj):   # the JAX package's own shadowing
            assert inspect.isclass(obj) == inspect.isclass(jobj), name
            assert callable(obj) == callable(jobj), name
            if not callable(jobj):
                assert type(obj) is type(jobj), name
        if name.startswith("sharded_") or name in ("make_mesh",
                                                  "mcf_scenario_sweep"):
            assert obj.__module__ == jobj.__module__.replace(
                "smart_crossover_tpu", "smart_crossover_tpu_torch"), name
    if sub == ".parallel":
        assert (tmod.BATCH_AXIS, tmod.MODEL_AXIS) == \
            (jmod.BATCH_AXIS, jmod.MODEL_AXIS)


def _modules(pkg):
    out = {"": pkg.__name__}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        out[m.name[len(pkg.__name__):]] = m.name
    return out


#: modules of both packages whose public functions differ by design:
#: ``config`` holds each package's own device policy (the JAX one asks its
#: backend, the port's take a device)
OWN_CONTRACT = {".config"}
SHARED = sorted(set(_modules(J)) & set(_modules(T)) - OWN_CONTRACT)


@pytest.mark.parametrize("rel", SHARED)
def test_jax_positional_order_is_a_prefix(rel):
    """ROADMAP 3.9: every public function or class of a module present in
    both packages takes the JAX parameters, by name and in order, as a
    prefix of the port's; the port's extras are keyword-only."""
    jmod = importlib.import_module("smart_crossover_tpu" + rel)
    tmod = importlib.import_module("smart_crossover_tpu_torch" + rel)
    for name, f in vars(jmod).items():
        if name.startswith("_") or not callable(f):
            continue
        f = inspect.unwrap(f)
        if getattr(f, "__module__", None) != jmod.__name__ \
                or not hasattr(tmod, name):
            continue
        try:
            pj = inspect.signature(f).parameters
        except (TypeError, ValueError):
            continue
        pt = list(inspect.signature(getattr(tmod, name)).parameters.values())
        assert [p.name for p in pt[:len(pj)]] == list(pj), (rel, name)
        extra = [p for p in pt[len(pj):]
                 if p.kind not in (p.KEYWORD_ONLY, p.VAR_KEYWORD)]
        assert not extra, (rel, name, [p.name for p in extra])


# ---- the TPU knobs kept as slots (ROADMAP 3.9)

def test_use_pallas_choice(rng):
    """``use_pallas``: False runs the plain version, the CPU default; True
    asks for the CUDA kernel and raises without a card."""
    from smart_crossover_tpu_torch import (
        batched_tnet,
        pdhg_dense_batched,
        pdhg_solve,
    )

    A = rng.standard_normal((2, 4, 12))
    b = np.einsum("bmn,bn->bm", A, np.full((2, 12), 0.5))
    c, l, u = rng.standard_normal((2, 12)), np.zeros((2, 12)), \
        np.ones((2, 12))
    a = pdhg_dense_batched(A, b, c, l, u, 50, None, 8, device="cpu")
    f = pdhg_dense_batched(A, b, c, l, u, 50, False, device="cpu")
    assert all(torch.equal(a[k], f[k]) for k in ("x", "y", "x_avg"))
    s1 = pdhg_solve(A[0], b[0], c[0], l[0], u[0], max_iters=128,
                    device="cpu")
    s2 = pdhg_solve(A[0], b[0], c[0], l[0], u[0], max_iters=128,
                    use_pallas=False, device="cpu")
    np.testing.assert_array_equal(s1.x, s2.x)
    s, d = rng.uniform(0.5, 1.5, (1, 4)), rng.uniform(0.5, 1.5, (1, 5))
    d *= s.sum() / d.sum()
    M = rng.uniform(0, 1, (1, 4, 5))
    x1 = batched_tnet(s, d, M, 0.02, 50, "flow", False, device="cpu")[0]
    x2 = batched_tnet(s, d, M, 0.02, 50, device="cpu")[0]
    assert torch.equal(x1, x2)
    for call in (lambda: pdhg_dense_batched(A, b, c, l, u, 5, True,
                                            device="cpu"),
                 lambda: pdhg_solve(A[0], b[0], c[0], l[0], u[0],
                                    max_iters=64, use_pallas=True,
                                    device="cpu"),
                 lambda: batched_tnet(s, d, M, use_pallas=True,
                                      device="cpu")):
        with pytest.raises(ValueError, match="use_pallas=True"):
            call()


def test_layout_knobs_are_no_ops(rng):
    """``chunk_b`` and ``build_ancestor_matrix``'s ``dtype`` change
    nothing; ``certify_ot_basis_batch(threads=)`` certifies the same."""
    from smart_crossover_tpu_torch import (
        batched_tnet_exact_device,
        certify_ot_basis_batch,
    )
    from smart_crossover_tpu_torch.ops.transport_simplex_anc import (
        build_ancestor_matrix,
    )

    s, d = rng.uniform(0.5, 1.5, (3, 5)), rng.uniform(0.5, 1.5, (3, 6))
    d *= (s.sum(1) / d.sum(1))[:, None]
    M = rng.uniform(0, 1, (3, 5, 6))
    a = batched_tnet_exact_device(s, d, M, 0.005, 200, 5000, "parent",
                                  device="cpu")
    b = batched_tnet_exact_device(s, d, M, 0.005, 200, 5000, "parent", 1,
                                  device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    parent = torch.tensor([[0, 0, 1, 1]])
    assert torch.equal(build_ancestor_matrix(parent, torch.float32),
                       build_ancestor_matrix(parent))
    Bm = a[5].numpy()
    one = certify_ot_basis_batch(Bm, s, d, M)
    two = certify_ot_basis_batch(Bm, s, d, M, None, None, 2)
    assert [c.ok for c in one] == [c.ok for c in two] == [True] * 3
    for x, y in zip(one, two):
        np.testing.assert_array_equal(x.x, y.x)
