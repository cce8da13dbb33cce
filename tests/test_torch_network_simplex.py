"""The port's network simplex (numpy core and native C++ core), its build,
and the MCF flow ranking against the JAX package's originals (CPU)."""
import concurrent.futures as cf
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_crossover_tpu.data import mcf_gen as j_gen
from smart_crossover_tpu.models import Basis as JBasis
from smart_crossover_tpu.models import OptTransport as JOptTransport
from smart_crossover_tpu.ops.ranking import (
    mcf_flow_indicators as j_mcf_flow_indicators,
)
from smart_crossover_tpu.solvers.network_simplex import (
    _network_simplex_py as j_network_simplex_py,
)
from smart_crossover_tpu_torch import (
    Basis,
    MinCostFlow,
    OptTransport,
    sinkhorn,
)
from smart_crossover_tpu_torch import native
from smart_crossover_tpu_torch.data import mcf_gen
from smart_crossover_tpu_torch.network_methods import (
    OTManager,
    tree_basis_identify,
)
from smart_crossover_tpu_torch.ops.ranking import mcf_flow_indicators
from smart_crossover_tpu_torch.solvers.network_simplex import (
    _network_simplex_py,
    network_simplex,
    network_simplex_output,
)

MAX_ITER, TOL = 10_000_000, 1e-9


@pytest.fixture(scope="module")
def same_native_core():
    """Run the JAX package's network simplex on the port's native library,
    for a whole test module (its module-scoped fixtures included).

    The JAX loader caches its first answer per process: the prebuilt
    ``smart_crossover_tpu/native/libscxnative.so`` where it exists (it is
    not committed; ``tests/test_native.py`` builds it), else its numpy
    core, whose duals differ from the C++ core's.  Test modules that hold
    the two packages' network-simplex answers equal use this fixture so
    that both sides run one C++ core, built from byte-identical sources,
    whatever the order in which the workers build and load.  The loader's
    cache and the bridge's argument-types flag are restored afterwards."""
    import smart_crossover_tpu.native as j_native
    import smart_crossover_tpu.native.netsimplex as j_bridge

    j_src = Path(j_native.__file__).parent / "netsimplex.cpp"
    assert j_src.read_bytes() == native.SOURCE.read_bytes()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_LIB", native.library())
        mp.setattr(j_native, "_LOAD_ATTEMPTED", True)
        mp.setattr(j_bridge, "_configured", False)
        yield


def _ot(seed, ns, nd):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, ns)
    d = rng.uniform(0.5, 2.0, nd)
    d *= s.sum() / d.sum()
    return OptTransport(s, d, rng.uniform(0.0, 5.0, (ns, nd)))


def _cases(case):
    """(the port's MCF, the JAX package's, a warm basis or None); the OT
    case is warm-started from the tree basis TNET identifies from its
    Sinkhorn flow."""
    if case == "transshipment_60":
        return (mcf_gen.transshipment_mcf(m=60),
                j_gen.transshipment_mcf(m=60), None)
    if case == "goto_8x8":
        return mcf_gen.goto_like_mcf(8, 8), j_gen.goto_like_mcf(8, 8), None
    ot = _ot(7, 10, 12)
    mgr = OTManager(ot, device="cpu")
    _, ind = mgr.get_sorted_flows(sinkhorn(ot, reg=0.05, num_iters=200,
                                           device="cpu"))
    basis, _ = tree_basis_identify(mgr, ind)
    return ot.to_MCF(), JOptTransport(ot.s, ot.d, ot.M).to_MCF(), basis


@pytest.mark.parametrize("case", ["transshipment_60", "goto_8x8",
                                  "ot_tree_warm"])
def test_numpy_core_matches_jax_bit_for_bit(case):
    mcf, jmcf, basis = _cases(case)
    res = _network_simplex_py(mcf, basis, MAX_ITER, TOL)
    jbasis = None if basis is None else JBasis(basis.vbasis, basis.cbasis)
    jres = j_network_simplex_py(jmcf, jbasis, MAX_ITER, TOL)
    assert res.status == jres.status == "OPTIMAL"
    assert res.iter_count == jres.iter_count
    np.testing.assert_array_equal(res.x, jres.x)
    np.testing.assert_array_equal(res.y, jres.y)
    np.testing.assert_array_equal(res.basis.vbasis, jres.basis.vbasis)
    np.testing.assert_array_equal(res.basis.cbasis, jres.basis.cbasis)
    assert res.obj_val == jres.obj_val


@pytest.mark.parametrize("case", ["transshipment_60", "goto_8x8",
                                  "ot_tree_warm"])
def test_native_core_matches_numpy_oracle(case):
    mcf, _, basis = _cases(case)
    nat = network_simplex(mcf, warm_basis=basis)
    py = network_simplex(mcf, warm_basis=basis, use_native=False)
    assert nat.status == py.status == "OPTIMAL"
    assert nat.obj_val == pytest.approx(py.obj_val, rel=1e-10)
    np.testing.assert_allclose(mcf.A @ nat.x, mcf.b, atol=1e-8)
    # warm-started from its own optimal basis, no pivot is left
    assert network_simplex(mcf, warm_basis=nat.basis).iter_count == 0


def test_native_capacitated_infeasible_and_output():
    rng = np.random.default_rng(3)
    m, extra = 30, 120
    tails = np.concatenate([np.arange(m - 1), rng.integers(0, m, extra)])
    heads = np.concatenate([np.arange(1, m), rng.integers(0, m, extra)])
    loop = tails == heads
    heads[loop] = (heads[loop] + 1) % m
    b = rng.uniform(-1, 1, m)
    b -= b.mean()
    u = np.concatenate([np.full(m - 1, 50.0), rng.uniform(0.3, 2.0, extra)])
    mcf = MinCostFlow(tails=tails, heads=heads,
                      c=rng.uniform(0.5, 4.0, tails.size), u=u, b=b)
    nat = network_simplex(mcf)
    py = network_simplex(mcf, use_native=False)
    assert nat.status == py.status == "OPTIMAL"
    assert nat.obj_val == pytest.approx(py.obj_val, rel=1e-10)
    out = network_simplex_output(mcf)
    assert out.status == "OPTIMAL" and out.obj_val == nat.obj_val
    bad = MinCostFlow(tails=[0], heads=[1], c=[1.0], u=[0.5], b=[-2.0, 2.0])
    assert network_simplex(bad).status == "INFEASIBLE"
    assert network_simplex(bad, use_native=False).status == "INFEASIBLE"
    assert network_simplex_output(bad).x is None
    with pytest.raises(ValueError, match="arc statuses"):
        network_simplex(mcf, warm_basis=Basis(nat.basis.vbasis[:-1],
                                              nat.basis.cbasis))


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile raises, and
    leaves no library or temporary file behind."""
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_library(timeout=120)
    assert list((tmp_path / "build").iterdir()) == []


def test_concurrent_native_builds(tmp_path, monkeypatch):
    """Builds racing into one directory (test workers) each rename a whole
    library into place: one library, no temporary file left."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with cf.ThreadPoolExecutor(3) as pool:
        paths = list(pool.map(lambda _: native.build_library(timeout=240),
                              range(3)))
    assert len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    assert paths[0].name.startswith("libscx_netsimplex_")


@pytest.mark.parametrize("seed", [0, 1])
def test_mcf_flow_indicators_match_jax(seed):
    """Reversed arcs (x > u / 2), infinite capacities and out-of-bound
    flows (x < 0, x > u) all present."""
    rng = np.random.default_rng(seed)
    mcf = mcf_gen.transshipment_mcf(m=50, seed=seed)
    u = mcf.u.copy()
    u[rng.uniform(size=u.size) < 0.2] = np.inf
    x = rng.uniform(-0.1, 1.1, u.size) * np.where(np.isfinite(u), u, 3.0)
    assert (x > u / 2).any() and (x < 0).any() and (x > u).any()
    ind = mcf_flow_indicators(torch.from_numpy(x),
                              torch.from_numpy(mcf.tails),
                              torch.from_numpy(mcf.heads),
                              torch.from_numpy(u), mcf.m)
    jind = j_mcf_flow_indicators(jnp.asarray(x), jnp.asarray(mcf.tails),
                                 jnp.asarray(mcf.heads), jnp.asarray(u),
                                 mcf.m)
    np.testing.assert_allclose(ind.numpy(), np.asarray(jind), rtol=0,
                               atol=1e-12)
    assert (ind.numpy() > 0).any()


def test_same_native_core_pins_the_jax_loader(same_native_core):
    """Under the fixture, the JAX package's facade takes the C++ core even
    where its own library is absent or disabled, and answers as the
    port's native core does, duals included."""
    from smart_crossover_tpu.native import native_available
    from smart_crossover_tpu.solvers.network_simplex import (
        network_simplex as j_network_simplex,
    )

    assert native_available()
    mcf, jmcf, _ = _cases("transshipment_60")
    a = j_network_simplex(jmcf)
    b = network_simplex(mcf)
    assert a.status == b.status == "OPTIMAL"
    assert a.iter_count == b.iter_count
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
