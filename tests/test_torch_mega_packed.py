"""The K2 kernel's design, checked on the CPU: its bit-packed tree update
(word algebra with the popcount LCA) against the plain version's byte
update, pivot by pivot; its cluster plan; and the port's device default."""
import numpy as np
import pytest
import torch

from smart_crossover_tpu_torch import batched_tnet_exact_device
from smart_crossover_tpu_torch.config import resolve_device
from smart_crossover_tpu_torch.ops import transport_simplex_mega as tsm
from smart_crossover_tpu_torch.solvers.pdhg import pdhg_solve
from smart_crossover_tpu_torch.solvers.pdhg_batched import pdhg_dense_batched

from tests.test_torch_transport_simplex_mega import _batch


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100])
def test_pack_bits_round_trip(n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.uniform(size=(3, 5, n)) < 0.5)
    w = tsm.pack_bits(x)
    assert w.shape == (3, 5, (n + 31) // 32)
    assert int(w.min()) >= 0 and int(w.max()) < 2 ** 32
    assert torch.equal(tsm.unpack_bits(w, n), x)
    # bit k % 32 of word k // 32
    k = n - 1
    assert torch.equal(((w[..., k // 32] >> (k % 32)) & 1).bool(), x[..., k])


# (13, 29): V = 42; (48, 24): V = 72; (20, 45): V = 65, not a multiple of
# 32 either; (24, 40): V = 64, whole words
@pytest.mark.parametrize("shape", [(13, 29), (48, 24), (20, 45), (24, 40)])
def test_packed_update_matches_byte_update(shape, monkeypatch):
    """Whole solves of northwest-corner starts: before each pivot the
    packed update runs on the packed N; after the plain version's byte
    update, the unpacked result equals the byte N exactly and dep is
    equal, at every step of every instance."""
    X, Bm, M = _batch(*shape, B=3)
    st = tsm.mega_setup(*(torch.from_numpy(a) for a in (X, Bm, M)))
    S = shape[0]
    V = sum(shape)
    byte_pivot = tsm._pivot
    steps = []

    def checked(st, go, dmin, ei, ej):
        want = {}
        Nw = tsm.pack_bits(st["N"])
        for b in torch.nonzero(go)[:, 0].tolist():
            want[b] = tsm.packed_pivot_rows(Nw[b], st["dep"][b], st["Xv"][b],
                                            S, int(ei[b]), int(ej[b]))
        byte_pivot(st, go, dmin, ei, ej)
        for b, (Nw_b, dep_b) in want.items():
            assert torch.equal(tsm.unpack_bits(Nw_b, V), st["N"][b])
            assert torch.equal(dep_b, st["dep"][b])
        steps.append(len(want))

    monkeypatch.setattr(tsm, "_pivot", checked)
    out = tsm.transport_simplex_mega_plain(st, max_pivots=2000)
    assert bool(out[6].all())
    assert sum(steps) == int(out[5].sum()) > 3 * 20


def test_cluster_plan_main_path_shapes():
    big = tsm.cluster_plan(16, 784, 784)
    assert big["cluster_size"] == 8
    assert big["n_in_smem"] and big["mask_in_smem"]
    small = tsm.cluster_plan(64, 256, 256)
    assert small["cluster_size"] == 2
    assert small["n_in_smem"] and small["mask_in_smem"]


@pytest.mark.parametrize("B,S,D", [
    (1, 2, 2), (16, 784, 784), (64, 256, 256), (133, 3, 5), (40, 13, 29),
    (3, 2500, 2500), (500, 2500, 2500), (7, 1, 4999), (2, 300, 7)])
def test_cluster_plan_covers_rows_and_fits(B, S, D):
    plan = tsm.cluster_plan(B, S, D)
    C = plan["cluster_size"]
    assert C in (1, 2, 4, 8)
    if C > 1:
        assert B * C <= 132 or not tsm.mega_smem_bytes(
            S, D, C // 2, True, True) <= tsm.SMEM_PER_BLOCK - 1024
    for n, ranges in ((S, plan["m_ranges"]), (S + D, plan["n_ranges"])):
        assert len(ranges) == C
        cover = [r for lo, hi in ranges for r in range(lo, hi)]
        assert cover == list(range(n))           # disjoint, in order
    assert plan["smem_bytes"] + tsm._STATIC_SMEM <= 232_448
    assert plan["smem_bytes"] == tsm.mega_smem_bytes(
        S, D, C, plan["n_in_smem"], plan["mask_in_smem"])
    assert plan["words_n"] == (S + D + 31) // 32


def test_cluster_plan_fills_the_card():
    """B*C <= 132 wherever C > 1, and C is the largest such power of two
    when everything fits at any C."""
    for B in (1, 2, 3, 8, 16, 17, 33, 64, 66, 67, 132, 133, 1000):
        C = tsm.cluster_plan(B, 40, 50)["cluster_size"]
        assert C == 1 or B * C <= 132
        assert C == 8 or B * C * 2 > 132


def test_cluster_plan_layouts_follow_the_budget():
    S, D = 33, 67
    full = tsm.cluster_plan(4, S, D)
    assert full["n_in_smem"] and full["mask_in_smem"]
    C = full["cluster_size"]
    n_glob = tsm.cluster_plan(
        4, S, D, tsm._STATIC_SMEM + tsm.mega_smem_bytes(S, D, C, False, True))
    assert not n_glob["n_in_smem"] and n_glob["mask_in_smem"]
    both = tsm.cluster_plan(
        4, S, D, tsm._STATIC_SMEM + tsm.mega_smem_bytes(S, D, C, False, False))
    assert not both["n_in_smem"] and not both["mask_in_smem"]
    # slices that only fit at a larger C raise C above what fills the card
    big = tsm.cluster_plan(200, 1200, 1200)
    assert big["cluster_size"] > 1 and big["n_in_smem"]


def test_cluster_plan_raises_beyond_its_cap():
    cap = tsm.max_kernel_nodes()
    assert cap >= 5000                   # every V the one-block kernel took
    tsm.cluster_plan(1, cap // 2, cap - cap // 2)
    with pytest.raises(ValueError, match=f"V <= {cap}"):
        tsm.cluster_plan(1, cap // 2, cap + 1 - cap // 2)


def test_entry_points_default_to_the_card(monkeypatch):
    """numpy inputs and no device: the card, or a raise without one;
    device="cpu" runs the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None, np.zeros(3)) == torch.device("cuda")
    assert resolve_device(None, torch.zeros(3)) == torch.device("cpu")
    assert resolve_device("cpu", np.zeros(3)) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(9)
    s = rng.uniform(0.5, 1.5, (1, 4))
    d = rng.uniform(0.5, 1.5, (1, 5))
    d *= s.sum() / d.sum()
    M = rng.uniform(0, 1, (1, 4, 5))
    A = rng.standard_normal((2, 3, 6))
    b = np.einsum("bmn,bn->bm", A, np.full((2, 6), 0.5))
    c, l, u = rng.standard_normal((2, 6)), np.zeros((2, 6)), np.ones((2, 6))
    calls = [lambda **kw: batched_tnet_exact_device(s, d, M, **kw),
             lambda **kw: pdhg_solve(A[0], b[0], c[0], l[0], u[0],
                                     max_iters=64, **kw),
             lambda **kw: pdhg_dense_batched(A, b, c, l, u, iters=8, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")
    out = batched_tnet_exact_device(s, d, M, device="cpu")
    assert out[0].device.type == "cpu" and bool(out[4].all())
