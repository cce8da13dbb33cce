"""The port's network-crossover front door against the JAX package's (CPU,
float64): the Sinkhorn warm starts, tree basis identification,
``network_crossover`` (TNET, CNET_OT, CNET_MCF) on the inputs of
``tests/test_network_crossover.py``, and ``batched_tnet_exact``.  Pivot
counts are reported, not matched; objectives and statuses are."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from smart_crossover_tpu.models import MinCostFlow as JMinCostFlow
from smart_crossover_tpu.models import OptTransport as JOptTransport
from smart_crossover_tpu.network_methods import (
    network_crossover as j_network_crossover,
)
from smart_crossover_tpu.network_methods.managers import (
    OTManager as JOTManager,
)
from smart_crossover_tpu.network_methods.tree_bi import (
    tree_basis_identify as j_tree_basis_identify,
)
from smart_crossover_tpu.parallel import batched as jb
from smart_crossover_tpu.solvers.sinkhorn import (
    sinkhorn as j_sinkhorn,
    sinkhorn_potentials_annealed as j_annealed,
    sinkhorn_potentials_tol as j_tol,
)
from smart_crossover_tpu_torch import (
    MinCostFlow,
    OptTransport,
    batched_tnet,
    batched_tnet_exact,
    column_generation,
    network_crossover,
    sinkhorn,
    tnet_single,
)
from smart_crossover_tpu_torch.data.mcf_gen import transshipment_mcf
from smart_crossover_tpu_torch.network_methods import (
    OTManager,
    tree_basis_identify,
)
from smart_crossover_tpu_torch.parallel import batched as pb
from smart_crossover_tpu_torch.solvers.network_simplex import network_simplex
from smart_crossover_tpu_torch.solvers.sinkhorn import (
    sinkhorn_potentials_annealed,
    sinkhorn_potentials_tol,
)
from tests.test_torch_network_simplex import same_native_core  # noqa: F401

# the JAX side's network simplex runs the port's C++ core
pytestmark = pytest.mark.usefixtures("same_native_core")

CPU = "cpu"
OBJ_RTOL = 1e-9          # the port's exact objective against the JAX one
HIGHS_TOL = 1e-8         # either against HiGHS


def random_ot(rng, ns, nd):
    """tests/conftest.py::random_ot, as both packages' instances."""
    s = rng.uniform(0.5, 2.0, ns)
    d = rng.uniform(0.5, 2.0, nd)
    d *= s.sum() / d.sum()
    M = rng.uniform(0.0, 5.0, (ns, nd))
    return OptTransport(s, d, M), JOptTransport(s, d, M)


def highs(mcf, upper=None):
    bounds = [(0, None)] * mcf.n if upper is None else \
        [(0, u) for u in upper]
    res = linprog(mcf.c, A_eq=mcf.A.toarray(), b_eq=mcf.b, bounds=bounds,
                  method="highs")
    assert res.status == 0
    return res


def same_result(out, jout, ref):
    assert out.status == jout.status == "OPTIMAL"
    assert out.obj_val == pytest.approx(jout.obj_val, rel=OBJ_RTOL,
                                        abs=OBJ_RTOL)
    assert abs(out.obj_val - ref) <= HIGHS_TOL * max(1.0, abs(ref))
    assert np.all(np.asarray(out.x) >= -1e-9)


# ------------------------------------------------------------ warm starts

def _ot_batch(B, S, D, seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(1) / d.sum(1))[:, None]
    return s, d, rng.uniform(0.0, 1.0, (B, S, D))


@pytest.mark.parametrize("kw", [dict(reg=0.05, num_iters=300),
                                dict(reg=0.03, num_iters=200,
                                     round_plan=False),
                                dict(reg=0.2, num_iters=150,
                                     relative_reg=False)])
def test_sinkhorn_wrapper_matches_jax(kw):
    ot, jot = random_ot(np.random.default_rng(1), 10, 12)
    x = sinkhorn(ot, device=CPU, **kw)
    jx = np.asarray(j_sinkhorn(jot, **kw))
    assert x.dtype == np.float64 and x.shape == (120,)
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-9 * np.abs(jx).max())


def test_sinkhorn_wrapper_rejects_zero_mass():
    ot, _ = random_ot(np.random.default_rng(2), 3, 4)
    ot.s[0] = 0.0
    with pytest.raises(ValueError, match="strictly positive"):
        sinkhorn(ot, device=CPU)


def test_sinkhorn_annealed_matches_jax():
    s, d, M = _ot_batch(2, 9, 13, seed=3)
    reg = 0.05
    f, g = sinkhorn_potentials_annealed(
        *(torch.from_numpy(a) for a in (s, d, M)), reg, num_iters=200)
    for b in range(2):
        jf, jg = j_annealed(
            jnp.asarray(s[b]), jnp.asarray(d[b]), jnp.asarray(M[b]), reg,
            num_iters=200)
        for a, q in ((f[b], jf), (g[b], jg)):
            q = np.asarray(q)
            np.testing.assert_allclose(a.numpy(), q, rtol=0,
                                       atol=1e-9 * np.abs(q).max())


def test_sinkhorn_tol_matches_jax():
    """Per instance: the same stopping block and potentials; the two
    instances stop at different counts."""
    s, d, M = _ot_batch(2, 9, 13, seed=4)
    regs = np.array([0.1, 0.03])
    f, g, iters = sinkhorn_potentials_tol(
        *(torch.from_numpy(a) for a in (s, d, M)), torch.from_numpy(regs),
        tol=1e-9, max_iters=5000)
    for b in range(2):
        jf, jg, jit = j_tol(
            jnp.asarray(s[b]), jnp.asarray(d[b]), jnp.asarray(M[b]),
            regs[b], tol=1e-9, max_iters=5000)
        assert int(iters[b]) == int(jit)
        for a, q in ((f[b], jf), (g[b], jg)):
            q = np.asarray(q)
            np.testing.assert_allclose(a.numpy(), q, rtol=0,
                                       atol=1e-9 * np.abs(q).max())
    assert int(iters[0]) != int(iters[1])


def test_tree_basis_identify_matches_jax_at_64x64():
    """At a grid the JAX package does not pad, the Borůvka tree is unique:
    the same basis and push count from the same flow weights."""
    ot, jot = random_ot(np.random.default_rng(5), 64, 64)
    jmgr = JOTManager(jot)
    _, ind = jmgr.get_sorted_flows(np.asarray(j_sinkhorn(
        jot, reg=0.02, num_iters=200)))
    jbasis, jpush = j_tree_basis_identify(jmgr, ind)
    basis, push = tree_basis_identify(OTManager(ot, device=CPU), ind)
    assert push == jpush
    np.testing.assert_array_equal(basis.vbasis, jbasis.vbasis)
    np.testing.assert_array_equal(basis.cbasis, jbasis.cbasis)
    assert basis.num_basic > 64


# ----------------------------------------------------- network_crossover

@pytest.mark.parametrize("method", ["tnet", "cnet_ot"])
def test_ot_crossover_from_sinkhorn(method):
    ot, jot = random_ot(np.random.default_rng(42), 10, 12)
    stats = {}
    out = network_crossover(sinkhorn(ot, reg=0.05, num_iters=300,
                                     device=CPU),
                            ot=ot, method=method, device=CPU, stats=stats)
    jout = j_network_crossover(j_sinkhorn(jot, reg=0.05, num_iters=300),
                               ot=jot, method=method)
    same_result(out, jout, highs(ot.to_MCF()).fun)
    assert stats["cg_rounds"] >= 1 and not stats["direct_solve"]
    assert stats["cg_pivots"] + stats["push_iters"] == out.iter_count


def test_tnet_from_accurate_sinkhorn():
    ot, jot = random_ot(np.random.default_rng(42), 8, 8)
    out = network_crossover(sinkhorn(ot, reg=0.005, num_iters=3000,
                                     device=CPU),
                            ot=ot, method="tnet", device=CPU)
    jout = j_network_crossover(j_sinkhorn(jot, reg=0.005, num_iters=3000),
                               ot=jot, method="tnet")
    same_result(out, jout, highs(ot.to_MCF()).fun)


def _capacitated_mcf(rng):
    m, extra = 10, 25
    tails = np.array(list(range(m - 1)) + list(rng.integers(0, m, extra)))
    heads = np.array(list(range(1, m)) + list(rng.integers(0, m, extra)))
    fix = tails == heads
    heads[fix] = (heads[fix] + 1) % m
    b = rng.uniform(-1, 1, m)
    b -= b.mean()
    u = np.concatenate([np.full(m - 1, 50.0), rng.uniform(0.5, 2.0, extra)])
    c = rng.uniform(0.5, 4.0, tails.size)
    return tails, heads, c, u, b


def test_cnet_mcf_crossover():
    rng = np.random.default_rng(42)
    tails, heads, c, u, b = _capacitated_mcf(rng)
    mcf = MinCostFlow(tails=tails, heads=heads, c=c, u=u, b=b)
    ref = highs(mcf, u)
    x_noisy = np.clip(ref.x + rng.uniform(-0.05, 0.05, mcf.n), 0, u)
    out = network_crossover(x_noisy, mcf=mcf, method="cnet_mcf", device=CPU)
    jout = j_network_crossover(
        x_noisy, mcf=JMinCostFlow(tails=tails, heads=heads, c=c, u=u, b=b),
        method="cnet_mcf")
    same_result(out, jout, ref.fun)


def test_crossover_rejects_bad_input():
    """The JAX package's ValueErrors, raised before any device is used."""
    ot, _ = random_ot(np.random.default_rng(42), 3, 3)
    with pytest.raises(ValueError, match="Invalid method"):
        network_crossover(np.zeros(9), ot=ot, method="nope")
    with pytest.raises(ValueError, match="OptTransport"):
        network_crossover(np.zeros(9), method="tnet")
    with pytest.raises(ValueError, match="MinCostFlow"):
        network_crossover(np.zeros(9), method="cnet_mcf")
    with pytest.raises(ValueError, match="arcs"):
        network_crossover(np.zeros(7), ot=ot, method="tnet")
    with pytest.raises(ValueError, match="arcs"):
        network_crossover(np.zeros(3), mcf=ot.to_MCF(), method="cnet_mcf")


def test_crossover_defaults_to_the_card(monkeypatch):
    """Without device= the ranking goes to the CUDA card; with no card
    that raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ot, _ = random_ot(np.random.default_rng(42), 3, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        network_crossover(np.ones(9), ot=ot, method="tnet")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sinkhorn(ot)


def test_column_generation_queue_exhaustion():
    ot, _ = random_ot(np.random.default_rng(42), 4, 4)
    mgr = OTManager(ot, device=CPU)
    mgr.get_mcf()
    mgr.set_initial_basis()
    stats = {}
    out = column_generation(mgr, queue=np.array([], dtype=np.int64),
                            stats=stats)
    assert out.status == "CG_FAILED" and stats["cg_rounds"] == 0


def test_cnet_mcf_tolerates_supply_roundoff():
    mcf = transshipment_mcf(m=300, arcs_per_node=8, num_terminals=30, seed=4)
    b_round = np.array([float(f"{v:.8g}") for v in mcf.b])
    assert abs(b_round.sum()) > 1e-10
    mcf = dataclasses.replace(mcf, b=b_round)
    exact = network_simplex(mcf)
    assert exact.status == "OPTIMAL"
    rng = np.random.default_rng(42)
    x_warm = np.clip(exact.x + rng.normal(0, 1e-3, mcf.n), 0, mcf.u)
    out = network_crossover(x_warm, mcf=mcf, method="cnet_mcf", device=CPU)
    jmcf = JMinCostFlow(tails=mcf.tails, heads=mcf.heads, c=mcf.c, u=mcf.u,
                        b=mcf.b)
    jout = j_network_crossover(x_warm, mcf=jmcf, method="cnet_mcf")
    assert out.status == jout.status == "OPTIMAL"
    assert out.obj_val == pytest.approx(jout.obj_val, rel=OBJ_RTOL)
    assert out.obj_val == pytest.approx(exact.obj_val, rel=1e-6)


def test_crossover_recovers_from_garbage_warm_start():
    ot, jot = random_ot(np.random.default_rng(42), 12, 12)
    x_garbage = np.zeros(144)
    x_garbage[0] = 1e6
    out = network_crossover(x_garbage, ot=ot, method="cnet_ot", device=CPU)
    jout = j_network_crossover(x_garbage, ot=jot, method="cnet_ot")
    same_result(out, jout, highs(ot.to_MCF()).fun)


# ------------------------------------------------------ batched pipelines

def test_batched_tnet_numpy_and_tensor_inputs_agree():
    s, d, M = _ot_batch(2, 11, 14, seed=6)
    Xn, pn, on = batched_tnet(s, d, M, reg=0.05, sinkhorn_iters=100,
                              device=CPU)
    Xt, pt, ot_ = batched_tnet(*(torch.from_numpy(a) for a in (s, d, M)),
                               reg=0.05, sinkhorn_iters=100)
    assert Xn.device.type == "cpu" and Xn.dtype == torch.float64
    assert torch.equal(Xn, Xt) and torch.equal(pn, pt)
    assert torch.equal(on, ot_)
    x1, p1, o1 = tnet_single(s[0], d[0], M[0], reg=0.05, sinkhorn_iters=100,
                             device=CPU)
    assert torch.equal(x1, Xn[0]) and int(p1) == int(pn[0])


def test_reduced_cost_tree_weights_match_jax():
    """W = -(M/eps - f - g) is the JAX package's W over eps: the same tree,
    vertex and push count."""
    s, d, M = _ot_batch(2, 12, 17, seed=7)
    X, push, obj = batched_tnet(s, d, M, reg=0.05, sinkhorn_iters=150,
                                tree_weights="reduced_cost", device=CPU)
    for b in range(2):
        jX, jpush, jobj = jb.tnet_single(
            jnp.asarray(s[b]), jnp.asarray(d[b]), jnp.asarray(M[b]), 0.05,
            150, tree_weights="reduced_cost")
        assert int(push[b]) == int(jpush)
        np.testing.assert_allclose(X[b].numpy(), np.asarray(jX), rtol=0,
                                   atol=1e-9)
        assert float(obj[b]) == pytest.approx(float(jobj), rel=1e-9)
    with pytest.raises(ValueError, match="tree_weights"):
        batched_tnet(s, d, M, tree_weights="other", device=CPU)


@pytest.fixture(scope="module")
def exact_batch():
    s, d, M = _ot_batch(4, 12, 16, seed=8)
    jX, jobj, _, jopt = jb.batched_tnet_exact(s, d, M, reg=0.005,
                                              sinkhorn_iters=200,
                                              engine="host")
    assert np.asarray(jopt).all()
    return s, d, M, np.asarray(jobj)


@pytest.mark.parametrize("engine,max_pivots", [("host", None),
                                               ("mega", None),
                                               ("auto", None),
                                               ("mega", 2)])
def test_batched_tnet_exact_matches_jax_host(exact_batch, engine,
                                             max_pivots):
    s, d, M, jobj = exact_batch
    stats = {}
    X, obj, piv, opt = batched_tnet_exact(
        s, d, M, reg=0.005, sinkhorn_iters=200, engine=engine,
        max_pivots=max_pivots, device=CPU, stats=stats)
    assert opt.all() and X.shape == (4, 12, 16)
    np.testing.assert_allclose(obj, jobj, rtol=OBJ_RTOL)
    np.testing.assert_allclose((X * M).sum((1, 2)), obj, rtol=1e-12)
    assert stats["engine"] == ("host" if engine == "host" else "mega")
    if max_pivots is not None:
        # capped at 2 pivots, some instance failed and was repaired
        assert stats["repaired"] >= 1
    assert stats["device_s"] > 0 and stats["host_s"] > 0


def test_batched_tnet_exact_auto_falls_back_to_host(monkeypatch):
    """'auto' takes the host route where the pivot kernel's layout does
    not fit the shape."""
    def no_fit(B, S, D):
        raise ValueError("does not fit")

    monkeypatch.setattr(pb, "cluster_plan", no_fit)
    s, d, M = _ot_batch(2, 6, 7, seed=9)
    stats = {}
    _, _, _, opt = batched_tnet_exact(s, d, M, sinkhorn_iters=100,
                                      device=CPU, stats=stats)
    assert stats["engine"] == "host" and opt.all()


@pytest.mark.parametrize("engine", ["device", "parent", "anc", "packed",
                                    "mask"])
def test_batched_tnet_exact_device_engines(engine, exact_batch):
    """The tensor pivot engines through the certify-and-repair route
    ('device' is 'parent'): every instance optimal, at the JAX package's
    certified objectives (its host route)."""
    s, d, M, jobj = exact_batch
    stats = {}
    X, obj, piv, opt = batched_tnet_exact(s, d, M, reg=0.005,
                                          sinkhorn_iters=200, engine=engine,
                                          device=CPU, stats=stats)
    assert opt.all() and X.shape == M.shape
    np.testing.assert_allclose(obj, jobj, rtol=OBJ_RTOL)
    assert stats["engine"] == ("parent" if engine == "device" else engine)
    assert stats["repaired"] == 0


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mesh=object(), engine="nope"), ValueError, "unknown engine"),
    (dict(engine="nope"), ValueError, "unknown engine"),
])
def test_batched_tnet_exact_unported_options_raise(kw, exc, match):
    s, d, M = _ot_batch(1, 4, 5, seed=10)
    with pytest.raises(exc, match=match):
        batched_tnet_exact(s, d, M, device=CPU, **kw)
