"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where torch sees no CUDA device (the
check runs in the fixture, not at import).  On a card:

    python -m pytest tests/test_torch_kernels_cuda.py -q
"""
import functools

import numpy as np
import pytest
import torch

from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
from smart_crossover_tpu_torch.ops.sinkhorn_fused import (
    sinkhorn_plan_fused,
    sinkhorn_plan_fused_plain,
)
from smart_crossover_tpu_torch.ops import transport_simplex_mega as tsm
from smart_crossover_tpu_torch.ops.transport_simplex_mega import (
    mega_setup,
    rebuild_plan,
    transport_simplex_mega_plain,
    transport_simplex_mega_state,
)
from smart_crossover_tpu_torch.network_methods.certify import (
    certify_ot_basis_batch,
)
from smart_crossover_tpu_torch.parallel.batched import (
    batched_tnet,
    batched_tnet_exact,
    batched_tnet_exact_device,
)
from smart_crossover_tpu_torch.network_methods import tree_bi
from smart_crossover_tpu_torch.ops import certify as certify_kernel
from smart_crossover_tpu_torch.ops.tree import (
    bipartite_tree_solve,
    bipartite_tree_solve_plain,
    build_parent_from_mask,
    build_parent_from_mask_plain,
    push_to_bfs,
    push_to_bfs_plain,
)
from smart_crossover_tpu_torch.utils import trace
from tests import certify_cases as cc
from tests import push_cases
from tests.ot_grids import digit_grid, dotmark

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


def _k1_inputs(B, S, D, seed):
    s, d, M = (torch.tensor(a, dtype=torch.float32, device="cuda")
               for a in _batch(B, S, D, seed))
    return s, d, (M / (0.05 * M.amax((1, 2)))[:, None, None]).contiguous()


def _k1_close(k, p):
    assert (k[1] - p[1]).abs().max().item() <= 1e-3
    assert (k[2] - p[2]).abs().max().item() <= 1e-3
    assert (k[0] - p[0]).abs().max().item() <= 1e-3 * p[0].abs().max().item()


# (shape, cluster size forced or None for the plan's, resident rows per rank
# forced below a rank's rows): C = 1 (B = 140 does not fit in pairs), 2, 7,
# 8, 16; rows partly in global memory; S, D not multiples of 32 (nor of 4)
# and S != D; S < C (ranks with no rows); D > 1024 (rows read twice); B = 1
@pytest.mark.parametrize("shape,C,n_res", [
    ((140, 13, 29), 1, None),
    ((64, 64, 100), 2, None),
    ((16, 40, 61), 8, None),
    ((16, 40, 64), 7, None),
    ((4, 33, 67), 16, None),
    ((3, 37, 300), 4, 3),
    ((2, 70, 90), 8, 1),
    ((2, 5, 70), 16, None),
    ((2, 24, 1100), 2, 5),
    ((1, 50, 31), None, None),
])
def test_sinkhorn_kernel_layouts_match_plain(cuda, shape, C, n_res):
    from smart_crossover_tpu_torch.ops import sinkhorn_fused as sf

    B, S, D = shape
    s, d, Mn = _k1_inputs(B, S, D, seed=51)
    budget = sf.SMEM_PER_BLOCK if n_res is None else \
        sf.sinkhorn_smem_bytes(S, D, C, n_res)
    n0 = _build.kernel_launch_counts()["sinkhorn_fused"]
    k = sinkhorn_plan_fused(s, d, Mn, 1.0, 200, smem_budget=budget,
                            cluster_size=C)
    torch.cuda.synchronize()
    assert _build.kernel_launch_counts()["sinkhorn_fused"] == n0 + 1
    plan = dict(sf.LAST_LAUNCH)
    if C is not None:
        assert plan["cluster_size"] == C
    rows = -(-S // plan["cluster_size"])
    assert plan["n_res"] == (rows if n_res is None else n_res)
    _k1_close(k, sinkhorn_plan_fused_plain(s, d, Mn, 1.0, 200))


def test_sinkhorn_layouts_agree_bit_for_bit(cuda):
    """At one C, any residency runs the same arithmetic in the same
    order: identical results."""
    from smart_crossover_tpu_torch.ops import sinkhorn_fused as sf

    s, d, Mn = _k1_inputs(3, 45, 77, seed=52)
    ref = sinkhorn_plan_fused(s, d, Mn, 1.0, 150, cluster_size=4)
    for n_res in (5, 2, 0):
        budget = sf.sinkhorn_smem_bytes(45, 77, 4, n_res)
        out = sinkhorn_plan_fused(s, d, Mn, 1.0, 150, cluster_size=4,
                                  smem_budget=budget)
        assert all(torch.equal(a, q) for a, q in zip(out, ref))


def test_sinkhorn_plan_on_card(cuda):
    """The plan the wrapper takes from the card's resident clusters: C = 2
    at 64 x 256^2 (all of M in shared memory, one wave), C = 1 for a batch
    that pairs of blocks would run in more waves."""
    from smart_crossover_tpu_torch.ops import sinkhorn_fused as sf

    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("plan expectations are for a 132-SM card")
    sinkhorn_plan_fused(*_k1_inputs(64, 256, 256, seed=53), 1.0, 2)
    plan = dict(sf.LAST_LAUNCH)
    assert plan["cluster_size"] == 2 and plan["m_in_smem"] == 1.0
    assert plan["waves"] == 1 and plan["max_active_clusters"] >= 64
    sinkhorn_plan_fused(*_k1_inputs(140, 13, 29, seed=53), 1.0, 2)
    assert sf.LAST_LAUNCH["cluster_size"] == 1


def test_sinkhorn_kernel_rejects_bad_input(cuda):
    s, d, M = (torch.tensor(a, dtype=torch.float64, device=cuda)
               for a in _batch(1, 8, 8, seed=42))
    with pytest.raises(ValueError, match="float32"):
        sinkhorn_plan_fused(s, d, M, 1.0, 3)


def test_sinkhorn_kernel_raises_without_a_plan(cuda):
    """No layout fits, or the card refuses the cluster size: the wrapper
    raises and runs nothing else."""
    s, d, Mn = _k1_inputs(1, 4, 300, seed=54)
    n0 = _build.kernel_launch_counts()["sinkhorn_fused"]
    with pytest.raises(ValueError, match="no cluster layout"):
        sinkhorn_plan_fused(s, d, Mn, 1.0, 3, smem_budget=1024)
    with pytest.raises(ValueError, match="no cluster layout"):
        sinkhorn_plan_fused(s, d, Mn, 1.0, 3, cluster_size=17)
    assert _build.kernel_launch_counts()["sinkhorn_fused"] == n0


def _nw_state(B, S, D, seed):
    """Northwest-corner starts (far from optimal, so the kernel walks many
    pivots) on uniform costs, float32 on the card."""
    rng = np.random.default_rng(seed)
    M = rng.uniform(0.0, 1.0, (B, S, D)).astype(np.float32)
    X = np.zeros((B, S, D), np.float32)
    Bm = np.zeros((B, S, D), bool)
    for b in range(B):
        s = rng.uniform(0.5, 1.5, S)
        d = rng.uniform(0.5, 1.5, D)
        s /= s.sum()
        d /= d.sum()
        i = j = 0
        while True:
            t = min(s[i], d[j])
            X[b, i, j], Bm[b, i, j] = t, True
            s[i] -= t
            d[j] -= t
            if i == S - 1 and j == D - 1:
                break
            if j == D - 1 or (i < S - 1 and s[i] <= d[j]):
                i += 1
            else:
                j += 1
    return mega_setup(*(torch.tensor(a, device="cuda") for a in (X, Bm, M)))


def _tnet_state(B, S, D, seed):
    """The slice's own warm start: the TNET vertex and its support tree."""
    s, d, M = (torch.tensor(a, dtype=torch.float32, device="cuda")
               for a in _batch(B, S, D, seed))
    X0, _, _ = batched_tnet(s, d, M, reg=0.005, sinkhorn_iters=300)
    return mega_setup(X0, boruvka_bipartite_mst((X0 > 1e-12).float()), M)


def _budget(S, D, C, layout):
    """A shared-memory budget that forces the layout: both slices in
    shared memory, N in global memory, or N and the mask in global memory."""
    if layout == "smem":
        return tsm.SMEM_PER_BLOCK
    return tsm._STATIC_SMEM + tsm.mega_smem_bytes(S, D, C, False,
                                                  layout == "n_global")


# (start, shape, layout, cluster size on a 132-SM card): C = 1 (B = 133),
# 2 and 8; D not a multiple of 4 (29, 67, 5); V not a multiple of 32; N
# and then the mask in global memory
@pytest.mark.parametrize("start,shape,layout,C", [
    ("tnet", (1, 2, 2), "smem", 8),
    ("tnet", (5, 7, 300), "smem", 8),
    ("tnet", (3, 13, 29), "smem", 8),
    ("tnet", (4, 64, 100), "smem", 8),
    ("nw", (133, 3, 5), "smem", 1),
    ("nw", (40, 13, 29), "smem", 2),
    ("nw", (16, 40, 61), "smem", 8),
    ("nw", (16, 33, 67), "n_global", 8),
    ("nw", (4, 33, 67), "all_global", 8),
])
def test_mega_kernel_matches_plain(cuda, start, shape, layout, C):
    B, S, D = shape
    st = (_tnet_state if start == "tnet" else _nw_state)(*shape, seed=43)
    budget = _budget(S, D, C, layout)
    n0 = _build.kernel_launch_counts()["transport_simplex_mega"]
    k = transport_simplex_mega_state(st, max_pivots=5000,
                                     smem_budget=budget)
    torch.cuda.synchronize()
    assert _build.kernel_launch_counts()["transport_simplex_mega"] == n0 + 1
    plan = tsm.LAST_LAUNCH
    if torch.cuda.get_device_properties(0).multi_processor_count == 132:
        assert plan["cluster_size"] == C
    assert plan["n_in_smem"] == (layout == "smem")
    assert plan["mask_in_smem"] == (layout != "all_global")
    p = transport_simplex_mega_plain(st, max_pivots=5000)
    assert bool(k[6].all()) and bool(p[6].all())
    Mt = st["M"].double()
    obj_k = (rebuild_plan(k[0], k[1], S, D).double() * Mt).sum((1, 2))
    obj_p = (rebuild_plan(p[0], p[1], S, D).double() * Mt).sum((1, 2))
    torch.testing.assert_close(obj_k, obj_p, rtol=1e-5, atol=0)


def test_mega_kernel_raises_beyond_its_cap(cuda):
    V = tsm.max_kernel_nodes() + 1
    st = _nw_state(1, 2, V - 2, seed=46)
    with pytest.raises(ValueError, match="shared-memory limit"):
        transport_simplex_mega_state(st)


def test_kernels_are_deterministic(cuda):
    """Two launches on the same input give bit-identical results (fixed
    reduction order, no atomics)."""
    s, d, M = (torch.tensor(a, dtype=torch.float32, device=cuda)
               for a in _batch(4, 33, 65, seed=45))
    Mn = (M / (0.005 * M.amax((1, 2)))[:, None, None]).contiguous()
    a = sinkhorn_plan_fused(s, d, Mn, 1.0, 200)
    b = sinkhorn_plan_fused(s, d, Mn, 1.0, 200)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for C in (2, 8, 16):                       # a cluster of C per instance
        a = sinkhorn_plan_fused(s, d, Mn, 1.0, 200, cluster_size=C)
        b = sinkhorn_plan_fused(s, d, Mn, 1.0, 200, cluster_size=C)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    X0 = batched_tnet(s, d, M, reg=0.005, sinkhorn_iters=200)[0]
    st = mega_setup(X0, boruvka_bipartite_mst((X0 > 1e-12).float()), M)
    a = transport_simplex_mega_state(st)
    b = transport_simplex_mega_state(st)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    st = _nw_state(16, 40, 61, seed=45)        # a cluster of 8 per instance
    a = transport_simplex_mega_state(st)
    b = transport_simplex_mega_state(st)
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


@pytest.mark.parametrize("shape", [(1, 784, 784), (1, 100, 130)])
def test_sinkhorn_kernel_single_instance_matches_plain(cuda, shape):
    """B = 1, as sinkhorn(ot) launches it: at 784^2 the plan takes the
    largest cluster; D = 130 is not a multiple of 4 (padded rows)."""
    from smart_crossover_tpu_torch.ops import sinkhorn_fused as sf

    s, d, Mn = _k1_inputs(*shape, seed=61)
    n0 = _build.kernel_launch_counts()["sinkhorn_fused"]
    k = sinkhorn_plan_fused(s, d, Mn, 1.0, 300)
    torch.cuda.synchronize()
    assert _build.kernel_launch_counts()["sinkhorn_fused"] == n0 + 1
    assert sf.LAST_LAUNCH["shape"] == list(shape)
    _k1_close(k, sinkhorn_plan_fused_plain(s, d, Mn, 1.0, 300))


def test_network_crossover_on_card_matches_cpu(cuda):
    """The verify flow on the card (sinkhorn through K1, float32 ranking
    and tree identification) reaches the CPU port's exact objective."""
    from smart_crossover_tpu_torch import (
        OptTransport, network_crossover, sinkhorn)

    rng = np.random.default_rng(62)
    s = rng.uniform(0.5, 2.0, 64)
    d = rng.uniform(0.5, 2.0, 64)
    d *= s.sum() / d.sum()
    ot = OptTransport(s, d, rng.uniform(0.0, 5.0, (64, 64)))
    _build.reset_kernel_launch_counts()
    x = sinkhorn(ot, reg=0.02, num_iters=500)
    assert _build.kernel_launch_counts()["sinkhorn_fused"] == 1
    out = network_crossover(x, ot=ot, method="tnet")
    ref = network_crossover(sinkhorn(ot, reg=0.02, num_iters=500,
                                      device="cpu"),
                            ot=ot, method="tnet", device="cpu")
    assert out.status == ref.status == "OPTIMAL"
    assert out.obj_val == pytest.approx(ref.obj_val, rel=1e-9)


# ------------------------------------------------------ dense-LP kernels

def _lp(m, n, seed):
    """A feasible bounded equality LP and a PDHG start state, float32 on
    the card."""
    from smart_crossover_tpu_torch.solvers.pdhg import estimate_opnorm

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    b = A @ rng.uniform(0.2, 0.8, n)
    c = A.T @ rng.standard_normal(m) + np.abs(rng.standard_normal(n)) + 0.05
    A, b, c = (torch.tensor(v, dtype=torch.float32, device="cuda")
               for v in (A, b, c))
    l, u = torch.zeros_like(c), torch.ones_like(c)
    eq = torch.ones_like(b)
    eq[: m // 4] = 0.0                        # a quarter '<' rows
    x, y = torch.zeros_like(c), torch.zeros_like(b)
    return A, b, c, l, u, eq, x, y, A @ x, estimate_opnorm(A)


def _rel(a, b):
    return (a - b).abs().max().item() / (1.0 + b.abs().max().item())


# float32 on both sides with sums in another order.  The adaptive step
# rule divides by a cancelling sum (curv), which carries ~1e-3 relative
# rounding in float32: over one chunk eta moves by up to ~2e-3 between
# the kernel and the plain version (H100), the vectors by ~1e-3
CHUNK_RTOL = 1e-2


@pytest.mark.parametrize("shape", [(512, 2048), (37, 300)])
def test_pdhg_chunk_kernel_matches_plain(cuda, shape):
    from smart_crossover_tpu_torch.ops.pdhg_chunk import (
        pdhg_chunk, pdhg_chunk_plain)

    A, b, c, l, u, eq, x, y, Ax, opn = _lp(*shape, seed=46)
    z = torch.zeros_like
    st = pdhg_chunk_plain(A, b, c, l, u, eq, x, y, Ax, z(x), z(y), 0.0,
                          0.9 / opn, 1.0, 0, opn, chunk=128)
    args = (A, b, c, l, u, eq, *st, 1.0, 128, opn)
    n0 = _build.kernel_launch_counts()["pdhg_chunk"]
    k = pdhg_chunk(*args)
    again = pdhg_chunk(*args)
    torch.cuda.synchronize()
    assert _build.kernel_launch_counts()["pdhg_chunk"] == n0 + 2
    # the plain version in float64: at 37 x 300 the float32 plain version's
    # own eta lies 2.2e-2 from it (H100), the kernel's 5e-4
    p = pdhg_chunk_plain(*(v.double() if torch.is_tensor(v) else v
                           for v in args))
    for a, q in zip(k, p):                    # x, y, Ax, xs, ys, wsum, eta
        assert _rel(a.double(), q) <= CHUNK_RTOL
    assert all(torch.equal(a, q) for a, q in zip(k, again))


def _halpern_args(shape, seed):
    """Anchors at the start, the iterate 96 plain iterations on; omega =
    1.3 and the Halpern index 96 for the chunk."""
    from smart_crossover_tpu_torch.ops.pdhg_chunk import halpern_chunk_plain

    A, b, c, l, u, eq, x, y, Ax, opn = _lp(*shape, seed=seed)
    step = 0.99 / opn
    x1, y1, Ax1, _ = halpern_chunk_plain(A, b, c, l, u, eq, x, y, Ax, x, y,
                                         Ax, 1.0, 0.0, step, chunk=96)
    return (A, b, c, l, u, eq, x1, y1, Ax1, x, y, Ax, 1.3, 96.0, step)


# (shape, cluster size, resident rows per rank), None: the plan's.  The
# plan's layouts, then forced C = 1, 2, 3 and 16 with all, part or none of A
# in shared memory; C > m leaves ranks with no rows, n = 301 is ragged
@pytest.mark.parametrize("shape,C,n_res", [
    ((512, 2048), None, None), ((37, 300), None, None),
    ((37, 300), 1, None), ((37, 300), 1, 20), ((37, 300), 1, 0),
    ((37, 300), 2, 0), ((37, 300), 2, None), ((37, 300), 2, 9),
    ((37, 300), 3, 6), ((37, 300), 3, 0),
    ((37, 300), 16, None), ((37, 300), 16, 1),
    ((6, 301), 16, None), ((6, 301), 16, 0)])
def test_halpern_chunk_kernel_matches_plain(cuda, shape, C, n_res):
    """'<' rows (a quarter), omega != 1, a mid-window Halpern index."""
    from smart_crossover_tpu_torch.ops import pdhg_cluster as pc
    from smart_crossover_tpu_torch.ops.pdhg_chunk import (
        halpern_chunk, halpern_chunk_plain)

    m, n = shape
    args = _halpern_args(shape, seed=47)
    force = {} if C is None else {"cluster_size": C}
    if n_res is not None:
        force["smem_budget"] = pc.halpern_cluster_smem_bytes(m, n, C, n_res)
    n0 = _build.kernel_launch_counts()["halpern_chunk"]
    k = halpern_chunk(*args, **force)
    plan = dict(pc.LAST_LAUNCH["halpern_chunk"])
    again = halpern_chunk(*args, **force)
    torch.cuda.synchronize()
    assert _build.kernel_launch_counts()["halpern_chunk"] == n0 + 2
    if C is not None:
        assert plan["cluster_size"] == C and plan["scatter"]
    if n_res is not None:
        assert plan["n_res"] == n_res
    p = halpern_chunk_plain(*args)
    for a, q in zip(k[:3], p[:3]):
        assert _rel(a, q) <= CHUNK_RTOL
    assert k[3].item() == float(p[3]) == 160.0
    assert all(torch.equal(a, q) for a, q in zip(k, again))


def test_halpern_residency_is_bit_identical(cuda):
    """At one C, rows in shared memory or read from global memory run the
    same arithmetic in the same order: identical results."""
    from smart_crossover_tpu_torch.ops import pdhg_cluster as pc
    from smart_crossover_tpu_torch.ops.pdhg_chunk import halpern_chunk

    args = _halpern_args((37, 301), seed=61)
    for C in (1, 3, 16):
        ref = halpern_chunk(*args, cluster_size=C)
        assert pc.LAST_LAUNCH["halpern_chunk"]["n_res"] == -(-37 // C)
        for n_res in (-(-37 // C) // 2, 0):
            out = halpern_chunk(*args, cluster_size=C,
                                smem_budget=pc.halpern_cluster_smem_bytes(
                                    37, 301, C, n_res))
            assert pc.LAST_LAUNCH["halpern_chunk"]["n_res"] == n_res
            assert all(torch.equal(a, q) for a, q in zip(out, ref))


@pytest.mark.parametrize("shape", [(32, 64, 256), (3, 17, 70),
                                   (1, 17, 70)])
def test_pdhg_batched_kernel_matches_plain(cuda, shape):
    from smart_crossover_tpu_torch.solvers.pdhg_batched import (
        _opnorms, pdhg_batched_cuda, pdhg_fixed_batched_plain)

    B, m, n = shape
    rng = np.random.default_rng(48)
    A = rng.standard_normal((B, m, n))
    b = np.einsum("bmn,bn->bm", A, rng.uniform(0.1, 0.9, (B, n)))
    c = rng.standard_normal((B, n))
    A, b, c = (torch.tensor(v, dtype=torch.float32, device="cuda")
               for v in (A, b, c))
    l, u = torch.zeros_like(c), torch.ones_like(c)
    opn = _opnorms(A)
    n0 = _build.kernel_launch_counts()["pdhg_batched"]
    k = pdhg_batched_cuda(A, b, c, l, u, opn, 50)
    again = pdhg_batched_cuda(A, b, c, l, u, opn, 50)
    torch.cuda.synchronize()
    assert _build.kernel_launch_counts()["pdhg_batched"] == n0 + 2
    p = pdhg_fixed_batched_plain(A, b, c, l, u, opn, torch.zeros_like(c),
                                 torch.zeros_like(b), 50)
    for a, q in zip(k, p):                    # x, y, x_avg, y_avg
        assert _rel(a, q) <= CHUNK_RTOL
    assert all(torch.equal(a, q) for a, q in zip(k, again))


def _fleet(B, m, n, seed):
    from smart_crossover_tpu_torch.solvers.pdhg_batched import _opnorms

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n))
    b = np.einsum("bmn,bn->bm", A, rng.uniform(0.1, 0.9, (B, n)))
    c = rng.standard_normal((B, n))
    A, b, c = (torch.tensor(v, dtype=torch.float32, device="cuda")
               for v in (A, b, c))
    l, u = torch.zeros_like(c), torch.ones_like(c)
    return A, b, c, l, u, _opnorms(A)


# every cluster size the plan can take, forced: C > m leaves ranks with no
# rows, n = 70 is ragged (not a multiple of 4)
@pytest.mark.parametrize("shape,C", [((3, 17, 70), C) for C in range(1, 17)]
                         + [((1, 5, 70), 8), ((1, 5, 70), 16)])
def test_pdhg_batched_kernel_cluster_sizes_match_plain(cuda, shape, C):
    from smart_crossover_tpu_torch.ops import pdhg_cluster as pc
    from smart_crossover_tpu_torch.solvers.pdhg_batched import (
        pdhg_batched_cuda, pdhg_fixed_batched_plain)

    A, b, c, l, u, opn = _fleet(*shape, seed=55)
    n0 = _build.kernel_launch_counts()["pdhg_batched"]
    k = pdhg_batched_cuda(A, b, c, l, u, opn, 50, cluster_size=C)
    again = pdhg_batched_cuda(A, b, c, l, u, opn, 50, cluster_size=C)
    torch.cuda.synchronize()
    assert _build.kernel_launch_counts()["pdhg_batched"] == n0 + 2
    assert pc.LAST_LAUNCH["pdhg_batched"]["cluster_size"] == C
    p = pdhg_fixed_batched_plain(A, b, c, l, u, opn, torch.zeros_like(c),
                                 torch.zeros_like(b), 50)
    for a, q in zip(k, p):                    # x, y, x_avg, y_avg
        assert _rel(a, q) <= CHUNK_RTOL
    assert all(torch.equal(a, q) for a, q in zip(k, again))


# (shape, C, plain iterations before the chunk): the main-path layout from a
# mid-run state; forced cluster sizes, C > m and ragged n from the start,
# where the float32 trajectories of small LPs have not yet drifted apart
@pytest.mark.parametrize("shape,C,warm", [
    ((512, 2048), 16, 128), ((37, 300), 1, 0), ((37, 300), 3, 0),
    ((37, 300), 8, 0), ((37, 300), 16, 0), ((6, 301), 16, 0)])
def test_pdhg_chunk_kernel_cluster_sizes_match_plain(cuda, shape, C, warm):
    """'<' rows (a quarter), omega != 1, forced cluster sizes."""
    from smart_crossover_tpu_torch.ops import pdhg_cluster as pc
    from smart_crossover_tpu_torch.ops.pdhg_chunk import (
        pdhg_chunk, pdhg_chunk_plain)

    A, b, c, l, u, eq, x, y, Ax, opn = _lp(*shape, seed=56)
    z = torch.zeros_like
    st = pdhg_chunk_plain(A, b, c, l, u, eq, x, y, Ax, z(x), z(y), 0.0,
                          0.9 / opn, 1.0, 0, opn, chunk=warm)
    args = (A, b, c, l, u, eq, *st, 1.3, warm, opn)
    k = pdhg_chunk(*args, cluster_size=C)
    assert pc.LAST_LAUNCH["pdhg_chunk"]["cluster_size"] == C
    again = pdhg_chunk(*args, cluster_size=C)
    torch.cuda.synchronize()
    p = pdhg_chunk_plain(*args)
    for a, q in zip(k, p):                    # x, y, Ax, xs, ys, wsum, eta
        assert _rel(a, q) <= CHUNK_RTOL
    assert all(torch.equal(a, q) for a, q in zip(k, again))


def test_pdhg_cluster_residency_is_bit_identical(cuda):
    """At one C, rows in shared memory or read from global memory run the
    same arithmetic in the same order: identical results."""
    from smart_crossover_tpu_torch.ops import pdhg_cluster as pc
    from smart_crossover_tpu_torch.ops.pdhg_chunk import (
        pdhg_chunk, pdhg_chunk_plain)
    from smart_crossover_tpu_torch.solvers.pdhg_batched import (
        pdhg_batched_cuda)

    A, b, c, l, u, opn = _fleet(4, 40, 100, seed=57)
    ref = pdhg_batched_cuda(A, b, c, l, u, opn, 200, cluster_size=4)
    assert pc.LAST_LAUNCH["pdhg_batched"]["n_res"] == 10
    for n_res in (7, 1, 0):
        out = pdhg_batched_cuda(
            A, b, c, l, u, opn, 200, cluster_size=4,
            smem_budget=pc.pdhg_cluster_smem_bytes(40, 100, 4, n_res))
        assert pc.LAST_LAUNCH["pdhg_batched"]["n_res"] == n_res
        assert all(torch.equal(a, q) for a, q in zip(out, ref))
    A, b, c, l, u, eq, x, y, Ax, opn = _lp(37, 301, seed=58)
    z = torch.zeros_like
    args = (A, b, c, l, u, eq, x, y, Ax, z(x), z(y), 0.0, 0.9 / opn, 1.0, 0,
            opn)
    ref = pdhg_chunk(*args, cluster_size=3)
    for n_res in (5, 0):
        out = pdhg_chunk(
            *args, cluster_size=3,
            smem_budget=pc.pdhg_cluster_smem_bytes(37, 301, 3, n_res))
        assert pc.LAST_LAUNCH["pdhg_chunk"]["n_res"] == n_res
        assert all(torch.equal(a, q) for a, q in zip(out, ref))
    p = pdhg_chunk_plain(*args)
    for a, q in zip(ref, p):
        assert _rel(a, q) <= CHUNK_RTOL


def test_pdhg_cluster_plan_on_card(cuda):
    """The layouts the wrappers take from the card at the main-path shapes:
    one wave each; K5 at 64 x 256 x 512 in pairs of blocks, at 32 x 64 x
    256 one block per LP, K3 and K4 at 512 x 2048 in the largest cluster
    with the scatter combine."""
    from smart_crossover_tpu_torch.ops import pdhg_cluster as pc
    from smart_crossover_tpu_torch.ops.pdhg_chunk import (
        halpern_chunk, pdhg_chunk)
    from smart_crossover_tpu_torch.solvers.pdhg_batched import (
        pdhg_batched_cuda)

    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("plan expectations are for a 132-SM card")
    pdhg_batched_cuda(*_fleet(64, 256, 512, seed=59), 2)
    plan = pc.LAST_LAUNCH["pdhg_batched"]
    assert plan["cluster_size"] == 2 and plan["waves"] == 1
    pdhg_batched_cuda(*_fleet(32, 64, 256, seed=59), 2)
    plan = pc.LAST_LAUNCH["pdhg_batched"]
    assert plan["cluster_size"] == 1 and plan["a_in_smem"] == 1.0
    A, b, c, l, u, eq, x, y, Ax, opn = _lp(512, 2048, seed=59)
    pdhg_chunk(A, b, c, l, u, eq, x, y, Ax, x, y, 0.0, 0.01, 1.0, 0, opn,
               chunk=2)
    assert pc.LAST_LAUNCH["pdhg_chunk"]["cluster_size"] == 16
    halpern_chunk(A, b, c, l, u, eq, x, y, Ax, x, y, Ax, 1.0, 0.0, 0.01,
                  chunk=2)
    plan = pc.LAST_LAUNCH["halpern_chunk"]
    assert plan["cluster_size"] == 16 and plan["scatter"]
    assert plan["n_res"] == 25 and plan["waves"] == 1
    # the same shape again: the plan made once is reused
    halpern_chunk(A, b, c, l, u, eq, x, y, Ax, x, y, Ax, 1.0, 2.0, 0.01,
                  chunk=2)
    assert pc.LAST_LAUNCH["halpern_chunk"] is plan


def test_pdhg_cluster_kernels_raise_without_a_plan(cuda):
    from smart_crossover_tpu_torch.ops.pdhg_chunk import (
        halpern_chunk, pdhg_chunk)
    from smart_crossover_tpu_torch.solvers.pdhg_batched import (
        pdhg_batched_cuda)

    A, b, c, l, u, opn = _fleet(1, 4, 300, seed=60)
    n0 = _build.kernel_launch_counts()
    with pytest.raises(ValueError, match="no cluster layout"):
        pdhg_batched_cuda(A, b, c, l, u, opn, 3, smem_budget=1024)
    with pytest.raises(ValueError, match="no cluster layout"):
        pdhg_batched_cuda(A, b, c, l, u, opn, 3, cluster_size=17)
    A, b, c, l, u, eq, x, y, Ax, opn = _lp(16, 40, seed=60)
    with pytest.raises(ValueError, match="no cluster layout"):
        pdhg_chunk(A, b, c, l, u, eq, x, y, Ax, x, y, 0.0, 0.01, 1.0, 0, opn,
                   smem_budget=512)
    with pytest.raises(ValueError, match="no cluster layout"):
        halpern_chunk(A, b, c, l, u, eq, x, y, Ax, x, y, Ax, 1.0, 0.0, 0.01,
                      smem_budget=512)
    with pytest.raises(ValueError, match="no cluster layout"):
        halpern_chunk(A, b, c, l, u, eq, x, y, Ax, x, y, Ax, 1.0, 0.0, 0.01,
                      cluster_size=17)
    assert _build.kernel_launch_counts() == n0


def test_pdhg_kernels_reject_bad_input(cuda):
    from smart_crossover_tpu_torch.ops.pdhg_chunk import pdhg_chunk

    A, b, c, l, u, eq, x, y, Ax, opn = _lp(16, 40, seed=49)
    with pytest.raises(ValueError, match="float32"):
        pdhg_chunk(A.double(), b, c, l, u, eq, x, y, Ax, x, y, 0.0, 0.01,
                   1.0, 0, opn)


def test_lp_paths_reach_exact_vertices_on_card(cuda):
    """pdhg_solve (both modes) and batched_lp_crossover on the card, each
    through its kernel, to vertices equal to HiGHS's objective."""
    from scipy.optimize import linprog

    from smart_crossover_tpu_torch.parallel.batched_lp import (
        batched_lp_crossover)
    from smart_crossover_tpu_torch.solvers.pdhg import pdhg_solve

    rng = np.random.default_rng(50)
    m, n = 24, 96
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    b = A @ rng.uniform(0.2, 0.8, n)
    c = A.T @ rng.standard_normal(m) + np.abs(rng.standard_normal(n)) + 0.05
    l, u = np.zeros(n), np.ones(n)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, 1), method="highs").fun
    for mode, name in (("adaptive", "pdhg_chunk"),
                       ("halpern", "halpern_chunk")):
        _build.reset_kernel_launch_counts()
        res = pdhg_solve(A, b, c, l, u, tol=1e-4, mode=mode, device=cuda)
        assert _build.kernel_launch_counts()[name] > 0
        assert res.status == "OPTIMAL"
        assert abs(res.obj_val - ref) <= 1e-3 * (1 + abs(ref))
    Af = np.stack([A, A[::-1]])
    bf, cf = np.stack([b, b[::-1]]), np.stack([c, c])
    _build.reset_kernel_launch_counts()
    out = batched_lp_crossover(Af, bf, cf, np.stack([l, l]),
                               np.stack([u, u]), warm_engine="pdhg",
                               pdhg_iters=2000, device=cuda)
    assert _build.kernel_launch_counts()["pdhg_batched"] == 1
    assert out["optimal"].all()
    np.testing.assert_allclose(out["obj"], [ref, ref], rtol=1e-8)


@pytest.mark.parametrize("engine", ["parent", "anc", "packed", "mask"])
def test_tensor_engines_on_card_match_cpu(cuda, engine):
    """The tensor pivot engines in float32 on the card (K1 for the warm
    start) walk the pivots of the same engine on the CPU in float32 from
    the card's warm start, and every basis certifies."""
    from smart_crossover_tpu_torch.parallel.batched import ENGINES

    s64, d64, M64 = _batch(3, 24, 40, seed=45)
    s, d, M = (torch.tensor(a, dtype=torch.float32, device=cuda)
               for a in (s64, d64, M64))
    X0, _, _ = batched_tnet(s, d, M, 0.005, 300)
    Bm0 = boruvka_bipartite_mst((X0 > 1e-12).float())
    X, Bm, piv, opt = ENGINES[engine](X0, Bm0, M, max_pivots=5000)
    cX, cB, cpiv, copt = ENGINES[engine](X0.cpu(), Bm0.cpu(), M.cpu(),
                                         max_pivots=5000)
    assert opt.all() and copt.all()
    assert torch.equal(piv.cpu(), cpiv) and torch.equal(Bm.cpu(), cB)
    assert all(c.ok for c in certify_ot_basis_batch(Bm.cpu().numpy(), s64,
                                                    d64, M64))


@pytest.mark.parametrize("mode", ["halpern", "adaptive"])
def test_sparse_first_order_on_card(cuda, mode):
    """pdhg_mcf_device and pdhg_solve on a sparse A in float32 on the card
    launch no dense PDHG kernel and reach the same point as the CPU run in
    float32 to 1e-3 (relative to 1 + the largest value)."""
    import scipy.sparse as ssp

    from smart_crossover_tpu_torch.data.mcf_gen import goto_like_mcf
    from smart_crossover_tpu_torch.solvers.pdhg import pdhg_solve
    from smart_crossover_tpu_torch.solvers.pdhg_mcf import pdhg_mcf_device

    mcf = goto_like_mcf(16, 16, 4, regular=True, seed=3)
    _build.reset_kernel_launch_counts()
    x, y, it, _, _ = pdhg_mcf_device(mcf, mode=mode, max_iters=500,
                                     tol=0.0)
    cx, cy, cit, _, _ = pdhg_mcf_device(mcf, mode=mode, max_iters=500,
                                        tol=0.0, device="cpu",
                                        dtype=torch.float32)
    assert it == cit == 500
    for got, want in ((x, cx), (y, cy)):
        assert np.abs(got - want).max() <= 1e-3 * (1 + np.abs(want).max())
    res = pdhg_solve(ssp.csr_matrix(mcf.A), mcf.b, mcf.c, np.zeros(mcf.n),
                     mcf.u, tol=1e-3, max_iters=20_000, mode=mode)
    assert res.status == "OPTIMAL" and np.isfinite(res.x).all()
    counts = _build.kernel_launch_counts()
    assert counts["pdhg_chunk"] == counts["halpern_chunk"] == 0


def _ipm_fleet(B, m, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n))
    b = np.einsum("bmn,bn->bm", A, rng.uniform(0.2, 0.8, (B, n)))
    return A, b, rng.standard_normal((B, n)), np.zeros((B, n)), \
        np.ones((B, n))


def test_ipm_dense_batched_on_card_matches_cpu(cuda):
    """The batched IPM in float32 on the card stops at its mu_exit near
    the float64 CPU run's point: objectives within 1e-3 relative, x within
    1e-2 (float32 Cholesky at cond ~ 1/mu)."""
    from smart_crossover_tpu_torch.solvers.ipm_batched import (
        ipm_dense_batched,
    )

    args = _ipm_fleet(8, 16, 48, seed=31)
    got = ipm_dense_batched(*args, tol=1e-5, max_iters=60)
    want = ipm_dense_batched(*args, tol=1e-5, max_iters=60, device="cpu")
    assert got["x"].is_cuda and got["x"].dtype == torch.float32
    assert bool(torch.isfinite(got["x"]).all())
    go, wo = got["obj_val"].double().cpu(), want["obj_val"]
    assert ((go - wo).abs() <= 1e-3 * (1 + wo.abs())).all()
    assert (got["x"].double().cpu() - want["x"]).abs().max() <= 1e-2
    assert (got["iters"].cpu() > 0).all()


def test_ipm_fleet_on_card_reaches_optimal(cuda):
    from scipy.optimize import linprog

    from smart_crossover_tpu_torch import ipm_fleet

    A, b, c, l, u = _ipm_fleet(6, 8, 20, seed=32)
    res = ipm_fleet(A, b, c, l, u, tol=1e-8)
    assert res.status == ["OPTIMAL"] * 6
    for i in range(6):
        ref = linprog(c[i], A_eq=A[i], b_eq=b[i], bounds=(0, 1),
                      method="highs")
        assert abs(res.obj[i] - ref.fun) <= 1e-7


def test_ne_offload_form_on_card(cuda, monkeypatch):
    import scipy.sparse as ssp

    from smart_crossover_tpu_torch.solvers import ne_offload

    A = ssp.random(1100, 3000, density=0.02, random_state=3, format="csr")
    monkeypatch.delenv("SCX_NE_OFFLOAD", raising=False)
    assert ne_offload.maybe_device_ne(A) is None
    monkeypatch.setenv("SCX_NE_OFFLOAD", "1")
    ne = ne_offload.maybe_device_ne(A)
    assert ne is not None and ne._A.is_cuda and ne._A.dtype == torch.float64
    d = np.random.default_rng(4).uniform(0.1, 10.0, 3000)
    Ad = np.asarray(A.todense())
    want = (Ad * d) @ Ad.T
    got = ne.form(d)
    assert got.dtype == np.float64 and ne.forms == 1
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_ipm_leaves_tf32_off_inside(cuda, monkeypatch):
    """With the caller's TF32 on, the IPM's products still run in full
    float32 (seen at its Cholesky), and the caller's setting comes back."""
    from smart_crossover_tpu_torch.solvers.ipm_batched import (
        ipm_dense_batched,
    )

    seen = []
    chol = torch.linalg.cholesky_ex

    def spy(M, *a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return chol(M, *a, **k)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", spy)
    prev = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        args = _ipm_fleet(4, 64, 256, seed=33)
        tf = ipm_dense_batched(*args, tol=1e-5, max_iters=60)
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32
        torch.set_float32_matmul_precision("highest")
        full = ipm_dense_batched(*args, tol=1e-5, max_iters=60)
        assert torch.equal(tf["x"], full["x"])
    finally:
        torch.set_float32_matmul_precision(prev)


def _big(B, S, D, seed, dtype=torch.float32):
    return lambda: (push_cases.tree_flows(B, S, D, seed, dtype=dtype,
                                          device="cuda"), {})


# cases built on the card: the main path's batch, and rows too many for a
# block's shared memory, whose row minima go to global scratch
CARD_CASES = {
    "tree_16x1024x1024": _big(16, 1024, 1024, seed=71),
    "scratch_1x29000x3": _big(1, 29000, 3, seed=81),
    "scratch_float64_2x20000x4": _big(2, 20000, 4, seed=82, dtype=torch.float64),
}


@pytest.mark.parametrize("case", [*push_cases.CASES, *CARD_CASES])
def test_push_kernel_matches_plain(cuda, case):
    """One launch of the push kernel gives the host-driven loop's X and
    per-instance steps exactly.  The cases of ``tests/push_cases.py`` are
    built on the CPU, where the plain loop is held to the JAX package on
    the same tensors."""
    if case in CARD_CASES:
        X, kw = CARD_CASES[case]()
    else:
        X, kw = push_cases.CASES[case]()
        X = X.to(cuda)
    n0 = _build.kernel_launch_counts()["tree_push"]
    Xk, ik = push_to_bfs(X, **kw)
    torch.cuda.synchronize()
    assert _build.kernel_launch_counts()["tree_push"] == n0 + 1
    Xp, ip = push_to_bfs_plain(X, **kw)
    assert Xk.dtype == X.dtype and ik.dtype == torch.int64
    assert torch.equal(ik, ip) and torch.equal(Xk, Xp)
    per_block = _build.library().scx_tree_push_scratch_bytes(
        X.shape[1], int(X.dtype == torch.float64))
    assert (per_block > 0) == case.startswith("scratch")
    if case == "max_iter_1":
        assert ik.tolist() == [1] * X.shape[0]
    elif case == "feasible_beside_long":
        assert int(ik[0]) == 0 and int(ik[1]) > 0
    else:
        assert int(ik.max()) > 0
    if case != "max_iter_1":
        assert bool((Xk >= -kw.get("tol", 0.0)).all())


def test_push_kernel_counts_in_the_trace(cuda):
    X = push_cases.tree_flows(3, 137, 141, seed=79, device="cuda")
    n0 = _build.kernel_launch_counts()["tree_push"]
    with trace.recording() as st:
        with trace.span("scx.push", X.device):
            _, iters = push_to_bfs(X)
    c = st.summary()["scx.push"]["counters"]
    assert c == {"push.steps": int(iters.max())}
    assert _build.kernel_launch_counts()["tree_push"] == n0 + 1


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int64])
def test_push_refuses_other_dtypes_on_the_card(cuda, dtype):
    """On the card the push is the kernel or an error, never the plain
    loop."""
    X = push_cases.tree_flows(1, 13, 29, seed=83, device="cuda")
    n0 = _build.kernel_launch_counts()["tree_push"]
    with pytest.raises(TypeError, match="float32 or float64"):
        push_to_bfs(X.to(dtype))
    assert _build.kernel_launch_counts()["tree_push"] == n0


def test_exact_route_is_unchanged_by_the_push_kernel(cuda, monkeypatch):
    """The batched route returns the same vertices, bases and objectives
    with the push on the kernel and on the host-driven loop."""
    s, d, M = dotmark(4, 32, seed=80)

    def route():
        n0 = _build.kernel_launch_counts()["tree_push"]
        out = batched_tnet_exact_device(s, d, M, reg=0.005,
                                        sinkhorn_iters=1000,
                                        max_pivots=20000, device=cuda)
        torch.cuda.synchronize()
        return out, _build.kernel_launch_counts()["tree_push"] - n0

    kernel, n_kernel = route()
    monkeypatch.setattr(tree_bi, "push_to_bfs", push_to_bfs_plain)
    plain, n_plain = route()
    assert (n_kernel, n_plain) == (1, 0)
    for a, b in zip(kernel, plain):
        assert torch.equal(a, b)
    assert bool(kernel[4].all())



def _boruvka_tree(s, d, seed, live=False):
    """Borůvka's tree of random weights on the card (the strided view the
    route hands on), with the route's masses; ``live`` weights the arcs
    between nonzero masses up, as the route does."""
    B, S = s.shape
    D = d.shape[1]
    rng = np.random.default_rng(seed)
    W = torch.tensor(rng.uniform(0.0, 1.0, (B, S, D)), dtype=torch.float32,
                     device="cuda")
    if live:
        W += torch.tensor((s > 0)[:, :, None] & (d > 0)[:, None, :],
                          device="cuda")
    return boruvka_bipartite_mst(W), s, d


def _mask_case(trees, seed):
    """Numpy masks (B, S, D) on the card, with random masses."""
    m = np.asarray(trees)
    s, d, _ = _batch(*m.shape, seed=seed)
    return torch.from_numpy(m).to("cuda"), s, d


def _path(S):
    """The path row 0, column 0, row 1, column 1, ...: depth 2 S - 1."""
    m = np.zeros((1, S, S), bool)
    i = np.arange(S)
    m[0, i, i] = True
    m[0, i[1:], i[:-1]] = True
    return m


def _star(S, D):
    m = np.zeros((1, S, D), bool)
    m[0, 0, :] = True
    m[0, :, 0] = True
    return m


def _unit_sources(B, S, D, seed):
    """The mask engine's cycle solves, signed: +1 and -1 at two rows and
    at two columns of random trees."""
    mask, _, _ = _boruvka_tree(np.ones((B, S)), np.ones((B, D)), seed)
    rng = np.random.default_rng(seed)
    s, d = np.zeros((B, S)), np.zeros((B, D))
    for b in range(B):
        i = rng.choice(S, 2, replace=False)
        j = rng.choice(D, 2, replace=False)
        s[b, i], d[b, j] = (1.0, -1.0), (-1.0, 1.0)
    return mask, s, d


# the route's shapes: DOTmark-like 16 x 1024^2, the grid's 16 x 784^2 with
# its zero masses, MNIST-pair TNET requests (B = 1); one row or column; the
# deepest tree (a path from row 0, depth V - 1), a monotone staircase path
# and a star (depth 2); the mask
# engine's signed unit sources; and a tree too large for a block's shared
# memory, whose arrays go to global scratch
WALK_CASES = {
    "dotmark_16x1024x1024": lambda: _boruvka_tree(
        *dotmark(16, 32, seed=110)[:2], seed=111),
    "grid_16x784x784": lambda: _boruvka_tree(
        *digit_grid(16, 28, 112, 4)[:2], seed=113, live=True),
    "pair_1x73x79": lambda: _boruvka_tree(*_batch(1, 73, 79, 114)[:2],
                                          seed=115),
    "pair_1x166x155": lambda: _boruvka_tree(*_batch(1, 166, 155, 116)[:2],
                                            seed=117),
    "rows_4x1x37": lambda: _boruvka_tree(*_batch(4, 1, 37, 118)[:2],
                                         seed=119),
    "cols_4x41x1": lambda: _boruvka_tree(*_batch(4, 41, 1, 120)[:2],
                                         seed=121),
    "path_1x300x300": lambda: _mask_case(_path(300), seed=123),
    "staircase_1x300x280": lambda: _mask_case(
        [cc.staircase(300, 280, np.random.default_rng(122))], seed=137),
    "star_1x300x280": lambda: _mask_case(_star(300, 280), seed=124),
    "unit_sources_8x64x80": lambda: _unit_sources(8, 64, 80, seed=125),
    "scratch_1x4000x4000": lambda: _boruvka_tree(
        *_batch(1, 4000, 4000, 126)[:2], seed=127),
}


@functools.lru_cache(maxsize=None)
def _walk_case(case):
    return WALK_CASES[case]()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(WALK_CASES))
def test_tree_walk_matches_plain(cuda, case, dtype):
    """One launch of ``csrc/tree_walk.cu`` a call.  The parent vector
    equals the plain BFS's element for element (a tree rooted at node 0 has
    one).  The flows lie on the tree's arcs; in float64 within 1e-12 of
    the plain loop's, the standard ``tests/test_torch_tree.py`` holds the
    plain loop to against the JAX package.  In float32 the kernel sums each
    subtree in float64 and rounds once, so it lies within one float32
    rounding of the plain loop run in float64 on the same masses; the
    float32 plain loop rounds at every leaf elimination, on partial sums
    as large as the flows, so the two float32 versions agree within 16
    float32 ulps of the instance's largest flow.  Masses rounded to float32
    no longer balance: the walk leaves the gap |sum s - sum d| at its root
    (the node of largest |mass|), the plain loop at the last node it
    eliminates, so the flows on the path between the two differ by that
    gap too.  Wherever the float64 plain loop's flow is exactly 0 (an arc
    whose side away from the root holds only zero masses) the kernel's is
    exactly 0 too."""
    mask, s, d = _walk_case(case)
    B, S, D = mask.shape
    n0 = _build.kernel_launch_counts()["tree_walk"]
    parent = build_parent_from_mask(mask)
    assert _build.kernel_launch_counts()["tree_walk"] == n0 + 1
    assert parent.dtype == torch.int64 and parent.shape == (B, S + D)
    assert torch.equal(parent, build_parent_from_mask_plain(mask))
    st, dt = (torch.tensor(a, dtype=dtype, device=cuda) for a in (s, d))
    X = bipartite_tree_solve(mask, st, dt)
    torch.cuda.synchronize()
    assert _build.kernel_launch_counts()["tree_walk"] == n0 + 2
    assert X.dtype == dtype and X.shape == (B, S, D)
    assert not bool(((X != 0) & ~mask).any())
    Xp = bipartite_tree_solve_plain(mask, st, dt)
    X64 = bipartite_tree_solve_plain(mask, st.double(), dt.double())
    assert not bool(((X != 0) & (X64 == 0)).any())
    big = X64.abs().amax((1, 2), keepdim=True)
    gap = (st.double().sum(1) - dt.double().sum(1)).abs()[:, None, None]
    if dtype == torch.float64:
        assert float((X - Xp).abs().max()) <= 1e-12
    else:
        assert bool(((X.double() - X64).abs()
                     <= 2.0**-23 * X64.abs() + gap + 2.0**-40 * big).all())
        assert bool(((X - Xp).double().abs()
                     <= 16 * 2.0**-23 * big + gap).all())
    per_block = _build.library().scx_tree_walk_scratch_bytes(
        S, D, int(dtype == torch.float64))
    assert (per_block > 0) == case.startswith("scratch")


def _eccentricity(parent, root):
    """Hops from ``root`` to the farthest node of the tree given by its
    parent vector, by a breadth-first search on the host."""
    adj = [[] for _ in parent]
    for v, p in enumerate(parent):
        if v != p:
            adj[v].append(p)
            adj[p].append(v)
    dist = {root: 0}
    queue = [root]
    for v in queue:
        for u in adj[v]:
            if u not in dist:
                dist[u] = dist[v] + 1
                queue.append(u)
    return max(dist.values())


def test_tree_walk_repeats_bit_for_bit_and_counts(cuda):
    """Repeat launches give the same bits; while the tracer records, the
    open span counts the deepest instance's walk depth."""
    mask, s, d = _walk_case("dotmark_16x1024x1024")
    st, dt = (torch.tensor(a, dtype=torch.float32, device=cuda)
              for a in (s, d))
    a = bipartite_tree_solve(mask, st, dt)
    b = bipartite_tree_solve(mask, st, dt)
    assert torch.equal(a, b)
    assert torch.equal(build_parent_from_mask(mask),
                       build_parent_from_mask(mask))
    small, s3, d3 = _boruvka_tree(*_batch(3, 137, 141, 128)[:2], seed=129)
    with trace.recording() as rec:
        with trace.span("scx.tree_solve", small.device):
            bipartite_tree_solve(small, torch.tensor(s3, device=cuda),
                                 torch.tensor(d3, device=cuda))
        with trace.span("scx.simplex_setup", small.device):
            parent = build_parent_from_mask(small)
    # the parent vector's walk starts at node 0, the flows' at the first
    # node of largest |mass|
    parent = parent.tolist()
    masses = np.concatenate([s3, d3], 1)
    sm = rec.summary()
    assert sm["scx.simplex_setup"]["counters"] == {"tree_walk.depth": max(
        _eccentricity(p, 0) for p in parent)}
    assert sm["scx.tree_solve"]["counters"] == {"tree_walk.depth": max(
        _eccentricity(p, int(np.argmax(np.abs(m))))
        for p, m in zip(parent, masses))}
    path, _, _ = _walk_case("path_1x300x300")
    with trace.recording() as rec:
        with trace.span("scx.simplex_setup", path.device):
            build_parent_from_mask(path)
    assert rec.summary()["scx.simplex_setup"]["counters"] == {
        "tree_walk.depth": 300 + 300 - 1}


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int64])
def test_tree_solve_refuses_other_dtypes_on_the_card(cuda, dtype):
    """On the card the tree solve is the kernel or an error, never the
    plain loop."""
    mask, s, d = _walk_case("pair_1x73x79")
    n0 = _build.kernel_launch_counts()["tree_walk"]
    with pytest.raises(TypeError, match="float32 or float64"):
        bipartite_tree_solve(mask, torch.tensor(s, device=cuda).to(dtype),
                             torch.tensor(d, device=cuda).to(dtype))
    assert _build.kernel_launch_counts()["tree_walk"] == n0


def test_tree_walk_refuses_max_rounds_on_the_card(cuda):
    """``max_rounds`` bounds only the plain loops: on the card, where the
    kernel walks every tree to its end, both functions refuse it before
    any launch rather than ignore it."""
    mask, s, d = _walk_case("pair_1x73x79")
    n0 = _build.kernel_launch_counts()["tree_walk"]
    with pytest.raises(ValueError, match="max_rounds"):
        build_parent_from_mask(mask, max_rounds=4)
    with pytest.raises(ValueError, match="max_rounds"):
        bipartite_tree_solve(mask, torch.tensor(s, device=cuda),
                             torch.tensor(d, device=cuda), max_rounds=4)
    assert _build.kernel_launch_counts()["tree_walk"] == n0


@pytest.mark.parametrize("kind", ["wrong_counts", "cycle", "scattered"])
def test_tree_walk_refuses_non_trees(cuda, kind):
    """A mask without S + D - 1 arcs, or whose arcs leave a node
    unreached from row 0, raises ``ValueError`` in both functions."""
    S, D = 34, 26
    if kind == "wrong_counts":
        m, match = cc.wrong_counts(S, D, seed=130), "S \\+ D - 1 arcs"
    elif kind == "cycle":
        m, match = cc.cycles(S, D, seed=131), "unreached"
    else:
        m, match = cc.scattered(S, D, seed=132), "no spanning tree"
    tree = cc.random_tree(S, D, np.random.default_rng(133))[None]
    mask = torch.from_numpy(np.concatenate([tree, m])).to(cuda)
    s, d, _ = _batch(mask.shape[0], S, D, seed=134)
    with pytest.raises(ValueError, match=match):
        build_parent_from_mask(mask)
    with pytest.raises(ValueError, match=match):
        bipartite_tree_solve(mask, torch.tensor(s, device=cuda),
                             torch.tensor(d, device=cuda))


def test_grid_warm_start_pushes_as_the_plain_loop(cuda, monkeypatch):
    """16 x 784^2 digit pairs with their blank pixels kept: the route's
    warm start (K1, ranking, Borůvka, tree solve, push) takes the plain
    loop's push steps on the kernel's tree flows, instance for instance,
    within 1%: the float32 flows of the two differ by a few roundings,
    which may break a tie of the push another way (on an H100 the steps
    were equal).  Arcs whose far side holds only zero masses carry exactly
    0, so the push never stalls on a flow of a few roundings (rooted at
    row 0, a blank corner pixel, the walk put the masses' float32 gap on
    that pixel's arc, and the push ran to its 100,000-step cap)."""
    s, d, M = (torch.tensor(a, dtype=torch.float32, device=cuda)
               for a in digit_grid(16, 28, 138, 4))
    kernel = batched_tnet(s, d, M, reg=0.005, sinkhorn_iters=1000)[1]
    monkeypatch.setattr(tree_bi, "bipartite_tree_solve",
                        bipartite_tree_solve_plain)
    plain = batched_tnet(s, d, M, reg=0.005, sinkhorn_iters=1000)[1]
    print("push steps, kernel", kernel.tolist(), "plain", plain.tolist())
    assert bool(((kernel - plain).abs() <= 0.01 * plain).all())


def test_exact_route_is_unchanged_by_the_tree_walk_kernel(cuda, monkeypatch):
    """The exact route (``batched_tnet_exact``, engine ``mega``) with the
    tree solve and K2's parent vector on the kernel (two launches a call)
    and on the plain loops (none): every instance certified on both sides,
    none repaired, and the same optimal objectives to 1e-9."""
    s, d, M = dotmark(4, 32, seed=135)

    def route():
        n0 = _build.kernel_launch_counts()["tree_walk"]
        stats = {}
        out = batched_tnet_exact(s, d, M, engine="mega", device=cuda,
                                 stats=stats)
        return out, stats, _build.kernel_launch_counts()["tree_walk"] - n0

    kernel, k_stats, n_kernel = route()
    monkeypatch.setattr(tree_bi, "bipartite_tree_solve",
                        bipartite_tree_solve_plain)
    monkeypatch.setattr(tsm, "build_parent_from_mask",
                        build_parent_from_mask_plain)
    plain, p_stats, n_plain = route()
    assert (n_kernel, n_plain) == (2, 0)
    assert bool(kernel[3].all()) and bool(plain[3].all())
    assert k_stats["repaired"] == p_stats["repaired"] == 0
    np.testing.assert_allclose(kernel[1], plain[1], rtol=1e-9)


def test_tnet_request_makes_one_tree_walk_launch(cuda):
    """A TNET request on the card solves its tree flows in one launch and
    builds no parent vector."""
    from smart_crossover_tpu_torch import (
        OptTransport, network_crossover, sinkhorn)

    rng = np.random.default_rng(136)
    s = rng.uniform(0.5, 2.0, 73)
    d = rng.uniform(0.5, 2.0, 79)
    d *= s.sum() / d.sum()
    ot = OptTransport(s, d, rng.uniform(0.0, 5.0, (73, 79)))
    x = sinkhorn(ot, reg=0.02, num_iters=500)
    _build.reset_kernel_launch_counts()
    out = network_crossover(x, ot=ot, method="tnet")
    assert out.status == "OPTIMAL"
    assert _build.kernel_launch_counts()["tree_walk"] == 1


@pytest.mark.parametrize("case", ["digits_784", "digits_784_all_cells",
                                  "dotmark_1024"])
def test_mega_kernel_counts_pivots_as_plain(cuda, case):
    """16 x 784^2 digit pairs with the zero pixels kept and DOTmark-like
    16 x 1024^2, from the route's warm start: the kernel's stats (pivots,
    optimal, degenerate pivots) and final bases equal the plain
    version's, instance for instance (the costs are integers, so every
    potential and reduced cost is exact in float32 on both).  'digits_784'
    is the state the route hands K2 (the cells at zero-mass nodes priced
    out, under the pivot cap); 'digits_784_all_cells' prices every cell,
    so most pivots are degenerate and some instances reach the cap."""
    digits = case.startswith("digits")
    s, d, M = (digit_grid(16, 28, 91, 4) if digits
               else dotmark(16, 32, seed=92))
    s, d, M = (torch.tensor(a, dtype=torch.float32, device=cuda)
               for a in (s, d, M))
    X0 = batched_tnet(s, d, M, reg=0.005, sinkhorn_iters=1000)[0]
    live = (s > 0)[:, :, None] & (d > 0)[:, None, :]
    Bm0 = boruvka_bipartite_mst(2 * (X0 > 1e-12).float() + live.float())
    Mk = M if case != "digits_784" else torch.where(
        live | Bm0, M, tsm.ZERO_MASS_COST)
    st = mega_setup(X0, Bm0, Mk)
    k = transport_simplex_mega_state(st, max_pivots=20000)
    p = transport_simplex_mega_plain(st, max_pivots=20000)
    print(case, "pivots", k[5].tolist(), "degenerate", k[7].tolist())
    for i in (4, 5, 6, 7):
        assert torch.equal(k[i], p[i]), i
    if case == "digits_784_all_cells":
        assert int(k[7].sum()) * 2 > int(k[5].sum())
    else:
        assert bool(k[6].all()) and int(k[5].max()) < 20000


def test_exact_route_takes_zero_masses_on_card(cuda):
    """The batched route on 16 x 784^2 digit pairs with the zero pixels
    kept: every instance optimal under the pivot cap and certified in
    float64, none refused by the basis check; the zero-mass nodes and
    K2's counts in the trace."""
    s, d, M = digit_grid(16, 28, 93, 4)
    with trace.recording() as rec:
        out = batched_tnet_exact_device(s, d, M, reg=0.005,
                                        sinkhorn_iters=1000,
                                        max_pivots=20000, device=cuda)
    assert bool(out[4].all()) and int(out[3].max()) < 20000
    certs = certify_ot_basis_batch(out[5].cpu().numpy(), s, d, M)
    assert all(c.ok for c in certs), [c.reason for c in certs]
    c = rec.summary()["scx.route"]["counters"]
    print("route counters", c)
    assert c["route.refused"] == 0
    assert c["route.zero_nodes"] == int((s == 0).sum() + (d == 0).sum())
    assert c["k2.pivots"] == int(out[3].sum())
    assert 0 <= c["k2.degenerate"] <= c["k2.pivots"]


def _agree_scipy(a, b):
    """The kernel's certificate ``a`` against the SciPy certifier's ``b``,
    at ``tests/test_torch_certify.py::_agree``'s tolerances; both name a
    failed tree solve so, each in its own words after the colon."""
    assert a.ok == b.ok
    key = lambda c: c.reason.split(":")[0].split("=")[0]  # noqa: E731
    assert key(a) == key(b), (a.reason, b.reason)
    if np.isfinite(b.obj_val):
        np.testing.assert_allclose(a.obj_val, b.obj_val, rtol=1e-12)
        np.testing.assert_allclose(a.x, b.x, rtol=1e-12, atol=1e-15)
        for k in ("max_feas_err", "min_flow", "min_rcost"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       rtol=1e-9, atol=1e-12)
    else:
        assert np.isnan(a.obj_val) and not a.x.any()


@functools.lru_cache(maxsize=None)
def _route_bases(kind):
    """The route's optimal bases: 16 DOTmark-like pairs at 1024^2, or 16
    digit pairs on the 784-pixel grid with their blank pixels kept (about
    80% zero masses, star-shaped trees)."""
    s, d, M = (dotmark(16, 32, seed=95) if kind == "dotmark"
               else digit_grid(16, 28, 96, 4))
    out = batched_tnet_exact_device(s, d, M, reg=0.005, sinkhorn_iters=1000,
                                    max_pivots=20000, device="cuda")
    assert bool(out[4].all())
    return out[5].cpu().numpy(), s, d, M


def _counts(S, D, seed):
    return (cc.wrong_counts(S, D, seed), *cc.masses(2, S, D, seed + 1))


def _cycle(S, D, seed):
    return (cc.cycles(S, D, seed), *cc.masses(1, S, D, seed + 1))


# (bases, whether every instance certifies); "scratch" cases do not fit a
# block's shared memory
CERTIFY_CASES = {
    "route_dotmark_16x1024x1024": (lambda: _route_bases("dotmark"), True),
    "route_digits_16x784x784": (lambda: _route_bases("digits"), True),
    "planted_3x64x100": (lambda: cc.planted(3, 64, 100, seed=97), True),
    "random_trees_4x64x100": (lambda: cc.random_trees(4, 64, 100, seed=98),
                              False),
    "wrong_counts_2x37x53": (lambda: _counts(37, 53, seed=99), False),
    "cycle_1x6x7": (lambda: _cycle(6, 7, seed=100), False),
    "cycle_1x30x20": (lambda: _cycle(30, 20, seed=101), False),
    "scratch_planted_2x2200x2200": (lambda: cc.planted(2, 2200, 2200,
                                                       seed=102), True),
    "scratch_random_1x3000x1500": (
        lambda: cc.random_trees(1, 3000, 1500, seed=103), False),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", list(CERTIFY_CASES))
def test_certify_kernel_matches_scipy(cuda, case, dtype):
    """One launch certifies the batch as the SciPy certifier does each
    instance: the same verdict and reason, the vertex, objective and
    diagnostics within the CPU parity test's tolerances; M read in float32
    or float64 as given."""
    make, all_ok = CERTIFY_CASES[case]
    Bm, s, d, M = make()
    M = M.astype(dtype)
    n0 = _build.kernel_launch_counts()["certify"]
    got = certify_ot_basis_batch(Bm, s, d, M)
    assert _build.kernel_launch_counts()["certify"] == n0 + 1
    want = certify_ot_basis_batch(Bm, s, d, M, device="cpu")
    for a, b in zip(got, want):
        _agree_scipy(a, b)
    assert [c.ok for c in got] == [all_ok] * len(got)
    per_block = _build.library().scx_certify_scratch_bytes(
        M.shape[1], M.shape[2], int(dtype == np.float64))
    assert (per_block > 0) == case.startswith("scratch")


def test_certify_kernel_repeats_bit_for_bit_and_counts(cuda):
    """Repeat launches give the same bits; one launch a batch, its span
    timed by CUDA events and ``certify.device`` = the batch size."""
    Bm, s, d, M = cc.planted(5, 300, 200, seed=104)
    with trace.recording() as st:
        certify_ot_basis_batch(Bm, s, d, M)
    sm = st.summary()
    assert sm["scx.certify_kernel"]["calls"] == 1
    assert sm["scx.certify_kernel"]["event_s"] > 0
    assert sm["scx.certify"]["counters"] == {"certify.device": 5,
                                             "certify.rejected": 0}
    a = certify_kernel.certify_batch_cuda(Bm, s, d, M, cuda)
    b = certify_kernel.certify_batch_cuda(Bm, s, d, M, cuda)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()


def test_certify_takes_card_tensors_where_they_lie(cuda):
    """Masks and costs already on the card are read there, with the same
    certificates as from host arrays; ``device='cpu'`` launches nothing."""
    Bm, s, d, M = _route_bases("digits")
    host = certify_ot_basis_batch(Bm, s, d, M)
    n0 = _build.kernel_launch_counts()["certify"]
    card = certify_ot_basis_batch(torch.from_numpy(Bm).to(cuda), s, d,
                                  torch.from_numpy(M).to(cuda))
    assert _build.kernel_launch_counts()["certify"] == n0 + 1
    for a, b in zip(card, host):
        assert (a.ok, a.reason, a.obj_val) == (b.ok, b.reason, b.obj_val)
        assert np.array_equal(a.x, b.x)
    certify_ot_basis_batch(Bm[:2], s[:2], d[:2], M[:2], device="cpu")
    assert _build.kernel_launch_counts()["certify"] == n0 + 1


@pytest.mark.parametrize("shape", [(34, 26), (200, 300)])
def test_certify_kernel_refuses_scattered_arcs(cuda, shape):
    """S + D - 1 random cells, nodes left without an arc: a failed tree
    solve, refused, the vertex zeros.  (No SciPy oracle here: its sparse
    LU crashed the process on such masks.)"""
    S, D = shape
    Bm = cc.scattered(S, D, seed=105)
    s, d, M = cc.masses(1, S, D, seed=106)
    (c,) = certify_ot_basis_batch(Bm, s, d, M)
    assert not c.ok and c.reason.startswith("tree solve failed")
    assert np.isnan(c.obj_val) and not c.x.any()
