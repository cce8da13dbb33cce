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
