"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where torch sees no CUDA device (the
check runs in the fixture, not at import).  On a card:

    python -m pytest tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest
import torch

from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
from smart_crossover_tpu_torch.ops.sinkhorn_fused import (
    sinkhorn_plan_fused,
    sinkhorn_plan_fused_plain,
)
from smart_crossover_tpu_torch.ops.transport_simplex_mega import (
    mega_setup,
    rebuild_plan,
    transport_simplex_mega,
    transport_simplex_mega_plain,
)
from smart_crossover_tpu_torch.network_methods.certify import (
    certify_ot_basis_batch,
)
from smart_crossover_tpu_torch.parallel.batched import (
    batched_tnet,
    batched_tnet_exact_device,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _batch(B, S, D, seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(1) / d.sum(1))[:, None]
    M = rng.uniform(0.0, 1.0, (B, S, D))
    return s, d, M


@pytest.mark.parametrize("shape", [(3, 13, 29), (4, 64, 100)])
def test_sinkhorn_kernel_matches_plain(cuda, shape):
    s, d, M = (torch.tensor(a, dtype=torch.float32, device=cuda)
               for a in _batch(*shape, seed=41))
    Mn = (M / (0.05 * M.amax((1, 2)))[:, None, None]).contiguous()
    n0 = _build.kernel_launch_counts()["sinkhorn_fused"]
    plan, f, g = sinkhorn_plan_fused(s, d, Mn, 1.0, 300)
    torch.cuda.synchronize()
    assert _build.kernel_launch_counts()["sinkhorn_fused"] == n0 + 1
    pp, pf, pg = sinkhorn_plan_fused_plain(s, d, Mn, 1.0, 300)
    # float32 with sums in another order: potentials in eps units
    assert (f - pf).abs().max().item() <= 1e-3
    assert (g - pg).abs().max().item() <= 1e-3
    assert (plan - pp).abs().max().item() <= 1e-3 * pp.abs().max().item()


def test_sinkhorn_kernel_rejects_bad_input(cuda):
    s, d, M = (torch.tensor(a, dtype=torch.float64, device=cuda)
               for a in _batch(1, 8, 8, seed=42))
    with pytest.raises(ValueError, match="float32"):
        sinkhorn_plan_fused(s, d, M, 1.0, 3)


@pytest.mark.parametrize("shape", [(1, 2, 2), (5, 7, 300), (3, 13, 29),
                                   (4, 64, 100)])
def test_mega_kernel_matches_plain(cuda, shape):
    s, d, M = (torch.tensor(a, dtype=torch.float32, device=cuda)
               for a in _batch(*shape, seed=43))
    # one shared warm start: the slice's TNET vertex and its support tree
    X0, _, _ = batched_tnet(s, d, M, reg=0.005, sinkhorn_iters=300)
    st = mega_setup(X0, boruvka_bipartite_mst((X0 > 1e-12).float()), M)
    n0 = _build.kernel_launch_counts()["transport_simplex_mega"]
    k = transport_simplex_mega(st, max_pivots=5000)
    torch.cuda.synchronize()
    assert _build.kernel_launch_counts()["transport_simplex_mega"] == n0 + 1
    p = transport_simplex_mega_plain(st, max_pivots=5000)
    assert bool(k[6].all()) and bool(p[6].all())
    S, D = shape[1:]
    Mt = st["M"].double()
    obj_k = (rebuild_plan(k[0], k[1], S, D).double() * Mt).sum((1, 2))
    obj_p = (rebuild_plan(p[0], p[1], S, D).double() * Mt).sum((1, 2))
    torch.testing.assert_close(obj_k, obj_p, rtol=1e-5, atol=0)


def test_kernels_are_deterministic(cuda):
    """Two launches on the same input give bit-identical results (fixed
    reduction order, no atomics)."""
    s, d, M = (torch.tensor(a, dtype=torch.float32, device=cuda)
               for a in _batch(4, 33, 65, seed=45))
    Mn = (M / (0.005 * M.amax((1, 2)))[:, None, None]).contiguous()
    a = sinkhorn_plan_fused(s, d, Mn, 1.0, 200)
    b = sinkhorn_plan_fused(s, d, Mn, 1.0, 200)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    X0 = batched_tnet(s, d, M, reg=0.005, sinkhorn_iters=200)[0]
    st = mega_setup(X0, boruvka_bipartite_mst((X0 > 1e-12).float()), M)
    a = transport_simplex_mega(st)
    b = transport_simplex_mega(st)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_exact_pipeline_certifies_on_card(cuda):
    s, d, M = _batch(4, 64, 100, seed=44)
    _build.reset_kernel_launch_counts()
    out = batched_tnet_exact_device(s, d, M, sinkhorn_iters=500,
                                    max_pivots=20000, device=cuda)
    counts = _build.kernel_launch_counts()
    assert counts["sinkhorn_fused"] == 1
    assert counts["transport_simplex_mega"] == 1
    assert bool(out[4].all())
    certs = certify_ot_basis_batch(out[5].cpu().numpy(), s, d, M)
    assert all(c.ok for c in certs)
