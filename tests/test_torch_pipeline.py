"""The port's TNET pipelines against the JAX package's (CPU): the warm
start, the exact slice end to end, and state carried across with
``interop.from_reference``."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_crossover_tpu.network_methods.certify import (
    certify_ot_basis_batch as j_certify,
)
from smart_crossover_tpu.ops.mst import boruvka_bipartite_mst as j_mst
from smart_crossover_tpu.ops.transport_simplex_mega import (
    batched_transport_simplex_mega as j_mega,
)
from smart_crossover_tpu.parallel import batched as jb
from smart_crossover_tpu_torch import (
    batched_tnet,
    batched_tnet_exact_device,
    batched_transport_simplex_mega,
    certify_ot_basis_batch,
    tnet_single,
)
from smart_crossover_tpu_torch.interop import from_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(B, S, D, seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(1) / d.sum(1))[:, None]
    M = rng.uniform(0.0, 1.0, (B, S, D))
    return s, d, M


@pytest.mark.parametrize("shape", [(2, 13, 29), (2, 24, 40)])
def test_batched_tnet_matches_jax_fused_route(shape):
    """The fused-Sinkhorn route of batched_tnet, as the JAX package runs it
    with use_pallas=True (interpret mode, f64): same vertex and push
    count."""
    s, d, M = _batch(*shape, seed=31)
    jX, jpush, jobj = jb.batched_tnet(s, d, M, reg=0.05, sinkhorn_iters=150,
                                      use_pallas=True)
    X, push, obj = batched_tnet(*(torch.from_numpy(a) for a in (s, d, M)),
                                reg=0.05, sinkhorn_iters=150)
    np.testing.assert_array_equal(push.numpy(), np.asarray(jpush))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-10)
    np.testing.assert_allclose(obj.numpy(), np.asarray(jobj), rtol=1e-10)


def test_tnet_single_matches_jax():
    """One instance: the port folds eps into M (fused route), the JAX
    package divides by eps (XLA route); in f64 both reach the same
    vertex."""
    s, d, M = _batch(1, 24, 40, seed=32)
    jX, jpush, jobj = jb.tnet_single(jnp.asarray(s[0]), jnp.asarray(d[0]),
                                     jnp.asarray(M[0]), 0.05, 150)
    X, push, obj = tnet_single(*(torch.from_numpy(a[0]) for a in (s, d, M)),
                               reg=0.05, sinkhorn_iters=150)
    assert int(push) == int(jpush)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(obj), float(jobj), rtol=1e-9)


@pytest.mark.parametrize("shape", [(2, 13, 29), (3, 24, 40), (2, 48, 24)])
def test_exact_slice_matches_jax_mega(shape):
    """The slice end to end: the port's batched_tnet_exact_device (plain
    versions on the CPU) and the JAX package's (engine='mega') both
    certify every instance, with the same optimal f64 objectives."""
    s, d, M = _batch(*shape, seed=33)
    kw = dict(reg=0.005, sinkhorn_iters=200, max_pivots=20000)
    out = batched_tnet_exact_device(s, d, M, **kw)
    jout = jb.batched_tnet_exact_device(s, d, M, engine="mega", **kw)
    assert out[4].all() and np.asarray(jout[4]).all()
    certs = certify_ot_basis_batch(out[5].numpy(), s, d, M)
    jcerts = j_certify(np.asarray(jout[5]), s, d, M)
    assert all(c.ok for c in certs) and all(c.ok for c in jcerts)
    np.testing.assert_allclose([c.obj_val for c in certs],
                               [c.obj_val for c in jcerts], rtol=1e-9)
    # the device objective (float32 flows) is close to the certified one
    np.testing.assert_allclose(out[1].numpy(), [c.obj_val for c in certs],
                               rtol=1e-5)


def test_reference_warm_start_carried_across():
    """The JAX pipeline's own warm start (X0 and its Borůvka basis), carried
    over with from_reference, walks the same pivots in the port."""
    s, d, M = (a.astype(np.float32) for a in _batch(2, 24, 40, seed=34))
    X0, Bm0 = [], []
    for b in range(2):
        x, _, _ = jb.tnet_single(jnp.asarray(s[b]), jnp.asarray(d[b]),
                                 jnp.asarray(M[b]), 0.005, 150)
        X0.append(np.asarray(x))
        Bm0.append(np.asarray(j_mst((x > 1e-12).astype(x.dtype))))
    X0, Bm0 = np.stack(X0), np.stack(Bm0)
    jX, jB, jp, jo = j_mega(X0, Bm0, M, max_pivots=5000)
    ref = from_reference(X0=X0, Bm=Bm0, M=M)
    assert ref["X0"].dtype == torch.float32 and ref["Bm"].dtype == torch.bool
    X, Bm, piv, opt = batched_transport_simplex_mega(
        ref["X0"], ref["Bm"], ref["M"], max_pivots=5000)
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(opt.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(Bm.numpy(), np.asarray(jB))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-6)


def test_from_reference_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown arrays"):
        from_reference(X=np.zeros(3))
    got = from_reference(parent=np.arange(4, dtype=np.int32),
                         dep=np.zeros(4, np.int64))
    assert got["parent"].dtype == torch.int32
    assert got["dep"].dtype == torch.int64


@pytest.mark.parametrize("engine", ["parent", "anc", "packed", "mask", "auto"])
def test_unported_engines_raise(engine):
    s, d, M = _batch(1, 4, 5, seed=35)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        batched_tnet_exact_device(s, d, M, engine=engine)


def test_port_never_imports_jax():
    """Importing every module of the port loads neither jax nor the JAX
    package."""
    code = (
        "import pkgutil, sys\n"
        "import smart_crossover_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'smart_crossover_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_jax_reference_runs_on_cpu():
    assert jax.default_backend() == "cpu"
