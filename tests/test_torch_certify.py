"""The port's numpy certifier against the JAX package's, on the same bases:
the same verdict, objective rtol 1e-12, the same diagnostics."""
import numpy as np
import pytest
import torch

from smart_crossover_tpu.network_methods import certify as jcert
from smart_crossover_tpu_torch.network_methods import certify as tcert
from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
from smart_crossover_tpu_torch.parallel.batched import (
    batched_tnet_exact_device,
)


def _instances(B, S, D, seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(1) / d.sum(1))[:, None]
    M = rng.uniform(0.0, 5.0, (B, S, D))
    return rng, s, d, M


def _agree(a, b):
    assert a.ok == b.ok
    assert a.reason.split("=")[0] == b.reason.split("=")[0]
    if np.isfinite(b.obj_val):
        np.testing.assert_allclose(a.obj_val, b.obj_val, rtol=1e-12)
        np.testing.assert_allclose(a.x, b.x, rtol=1e-12, atol=1e-15)
        for k in ("max_feas_err", "min_flow", "min_rcost"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       rtol=1e-9, atol=1e-12)
    else:
        assert np.isnan(a.obj_val)


@pytest.mark.parametrize("shape", [(13, 29), (24, 40), (48, 24)])
def test_certify_optimal_and_suboptimal_bases(shape):
    """Optimal bases (from the port's exact pipeline) certify; spanning
    trees of random weights fail on flows or reduced costs.  Both
    certifiers say the same of each."""
    S, D = shape
    rng, s, d, M = _instances(3, S, D, seed=21)
    W = torch.from_numpy(rng.uniform(0, 1, (3, S, D)))
    trees = boruvka_bipartite_mst(W).numpy()
    opt_bases = batched_tnet_exact_device(s, d, M, sinkhorn_iters=100,
                                          device="cpu")[5]
    bases = np.concatenate([trees, opt_bases.numpy()])
    ss, dd, MM = (np.concatenate([a, a]) for a in (s, d, M))
    t = tcert.certify_ot_basis_batch(bases, ss, dd, MM)
    j = jcert.certify_ot_basis_batch(bases, ss, dd, MM)
    for a, b in zip(t, j):
        _agree(a, b)
    assert all(c.ok for c in t[3:]) and not any(c.ok for c in t[:3])


def test_certify_rejects_non_trees_like_jax():
    _, s, d, M = _instances(1, 6, 7, seed=22)
    short = np.zeros((6, 7), bool)
    short[0, :] = True                      # 7 arcs, want 12
    cyc = np.zeros((6, 7), bool)
    cyc[:, 0] = True
    cyc[0, :] = True
    cyc[1, 1] = True                        # 12 arcs with a cycle
    for Bm in (short, cyc):
        _agree(tcert.certify_ot_basis(Bm, s[0], d[0], M[0]),
               jcert.certify_ot_basis(Bm, s[0], d[0], M[0]))


def test_certify_tolerances_pass_through():
    _, s, d, M = _instances(2, 13, 29, seed=23)
    trees = boruvka_bipartite_mst(torch.from_numpy(M)).numpy()
    t = tcert.certify_ot_basis_batch(trees, s, d, M, feas_tol=1e3,
                                     rcost_tol=1e3)
    j = jcert.certify_ot_basis_batch(trees, s, d, M, feas_tol=1e3,
                                     rcost_tol=1e3)
    assert all(c.ok for c in t)
    for a, b in zip(t, j):
        _agree(a, b)
