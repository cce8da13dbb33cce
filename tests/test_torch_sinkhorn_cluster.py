"""The cluster Sinkhorn kernel's layout plan and its rank decomposition,
on the CPU.

``sinkhorn_plan_fused_split`` is the kernel's arithmetic in tensor form:
the column LSE from C ranks' partial maxima and partial sums, combined in
rank order.  In f64 it is held to the plain version at 1e-12 and to the
TPU kernel in interpret mode at 1e-9, as tests/test_torch_sinkhorn.py
holds the plain version.
"""
import re

import numpy as np
import pytest
import torch

from smart_crossover_tpu.ops.sinkhorn_pallas import sinkhorn_plan_pallas
from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch.ops import sinkhorn_fused as sf
from smart_crossover_tpu_torch.ops.sinkhorn_fused import (
    sinkhorn_cluster_plan,
    sinkhorn_plan_fused_plain,
    sinkhorn_plan_fused_split,
    sinkhorn_smem_bytes,
)

BUDGET = sf.SMEM_PER_BLOCK


def _batch(B, S, D, seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(1) / d.sum(1))[:, None]
    M = rng.uniform(0.0, 5.0, (B, S, D))
    return s, d, M


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# C = 1 is the plain column LSE; 16 > S leaves ranks with no rows; 3 is no
# kernel size but the decomposition holds for any C
@pytest.mark.parametrize("shape,C", [
    ((2, 13, 29), 1), ((2, 13, 29), 2), ((3, 24, 40), 4), ((2, 48, 24), 8),
    ((2, 13, 29), 16), ((1, 5, 7), 16), ((2, 24, 40), 3)])
def test_split_matches_plain_f64(shape, C):
    s, d, M = _t(*_batch(*shape, seed=11))
    want = sinkhorn_plan_fused_plain(s, d, M, 0.4, 100)
    got = sinkhorn_plan_fused_split(s, d, M, 0.4, 100, C)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-12,
                               atol=1e-300)


@pytest.mark.parametrize("shape,C", [((2, 13, 29), 2), ((3, 24, 40), 8),
                                     ((2, 48, 24), 16)])
def test_split_matches_pallas_interpret(shape, C):
    """The decomposition against the TPU kernel in interpret mode (x64),
    plan rtol 1e-9, on the pipeline's call (eps folded into M, reg 1)."""
    s, d, M = _batch(*shape, seed=12)
    Mn = M / (0.05 * M.max(axis=(1, 2)))[:, None, None]
    want = np.asarray(sinkhorn_plan_pallas(s, d, Mn, 1.0, num_iters=150))
    plan, _, _ = sinkhorn_plan_fused_split(*_t(s, d, Mn), 1.0, 150, C)
    np.testing.assert_allclose(plan.numpy(), want, rtol=1e-9, atol=1e-300)


def test_split_of_a_rank_without_rows_adds_nothing():
    """Ranks with no rows post (-inf, 0): the result is C = S's."""
    s, d, M = _t(*_batch(1, 5, 9, seed=13))
    a = sinkhorn_plan_fused_split(s, d, M, 0.5, 40, 5)
    b = sinkhorn_plan_fused_split(s, d, M, 0.5, 40, 16)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# resident clusters the H100 reported for the 784^2 layouts (one block
# per SM); other sizes count as refused
_CARD = {1: 132, 2: 66, 4: 30, 6: 17, 7: 15, 8: 15, 16: 7}


def _card(C, n_res):
    return _CARD.get(C, 0)


def test_plan_main_path_shapes():
    small = sinkhorn_cluster_plan(64, 256, 256)
    assert small["cluster_size"] == 2
    assert small["n_res"] == 128 and small["m_in_smem"] == 1.0
    assert small["waves"] == 1 and small["smem_bytes"] <= BUDGET
    assert sinkhorn_cluster_plan(64, 256, 256, active=_card) == small
    big = sinkhorn_cluster_plan(16, 784, 784)      # 132 // C resident
    assert big["cluster_size"] == 8 and big["waves"] == 1
    assert big["n_res"] == 63 and big["rows_in_smem"] == 8 * 63


def test_plan_takes_fewest_waves_then_most_in_smem():
    """With the card's counts 16 clusters of 7 or 8 need two waves and of
    16 three; the plan takes C = 6, the largest share of M among the
    one-wave layouts."""
    plan = sinkhorn_cluster_plan(16, 784, 784, active=_card)
    assert plan["cluster_size"] == 6 and plan["waves"] == 1
    assert plan["max_active_clusters"] == 17
    assert plan["rows_in_smem"] == 6 * plan["n_res"]
    # 40 instances: only C = 1 and 2 run them in one wave
    plan = sinkhorn_cluster_plan(40, 784, 784, active=_card)
    assert plan["cluster_size"] == 2 and plan["waves"] == 1
    # 200 instances: two waves at C = 1 beat four at C = 2
    plan = sinkhorn_cluster_plan(200, 784, 784, active=_card)
    assert plan["cluster_size"] == 1 and plan["waves"] == 2
    # equal waves and all of M resident either way: the larger C
    plan = sinkhorn_cluster_plan(14, 784, 784,
                                 active=lambda C, n: 15 if C == 8 else 0)
    assert plan["cluster_size"] == 8 and plan["waves"] == 1


def test_plan_c1_for_large_batches_and_largest_c_for_one():
    assert sinkhorn_cluster_plan(140, 13, 29)["cluster_size"] == 1
    assert sinkhorn_cluster_plan(140, 13, 29, active=_card)["cluster_size"] \
        == 1
    one = sinkhorn_cluster_plan(1, 50, 31)
    assert one["cluster_size"] == 16 and one["m_in_smem"] == 1.0
    few = sinkhorn_cluster_plan(2, 5, 70)          # ranks with no rows
    assert few["cluster_size"] == 16 and few["n_res"] == 1


@pytest.mark.parametrize("B,S,D", [
    (1, 2, 2), (16, 784, 784), (64, 256, 256), (140, 13, 29), (3, 2500, 900),
    (500, 1000, 1000), (7, 1, 4999), (2, 300, 7), (4, 33, 1100)])
def test_plan_covers_rows_and_fits(B, S, D):
    for active in (None, _card):
        plan = sinkhorn_cluster_plan(B, S, D, active=active)
        C = plan["cluster_size"]
        assert 1 <= C <= 16
        ranges = plan["row_ranges"]
        assert len(ranges) == C
        assert [r for lo, hi in ranges for r in range(lo, hi)] == \
            list(range(S))
        assert plan["n_res"] <= -(-S // C)
        assert plan["rows_in_smem"] == sum(min(hi - lo, plan["n_res"])
                                           for lo, hi in ranges)
        assert plan["smem_bytes"] == sinkhorn_smem_bytes(S, D, C,
                                                         plan["n_res"])
        assert plan["smem_bytes"] <= BUDGET
        # one more resident row would not fit
        if plan["n_res"] < -(-S // C):
            assert sinkhorn_smem_bytes(S, D, C, plan["n_res"] + 1) > BUDGET


def test_plan_follows_a_lowered_budget():
    S, D, C = 37, 300, 4
    full = sinkhorn_cluster_plan(3, S, D, cluster_size=C)
    assert full["n_res"] == 10 and full["m_in_smem"] == 1.0
    assert sinkhorn_smem_bytes(S, D, C, 10) == 4 * (10 * 300 + 5 * 300 + 4096
                                                    + 2 * 10)
    for k in (0, 1, 3, 9):
        plan = sinkhorn_cluster_plan(3, S, D, sinkhorn_smem_bytes(S, D, C, k),
                                     cluster_size=C)
        assert plan["n_res"] == k and plan["rows_in_smem"] == C * k
        assert plan["smem_bytes"] == sinkhorn_smem_bytes(S, D, C, k)
    # a budget that no C meets
    with pytest.raises(ValueError, match="no cluster layout"):
        sinkhorn_cluster_plan(3, S, D, sinkhorn_smem_bytes(S, D, 16, 0) - 16)


def test_plan_forced_size():
    plan = sinkhorn_cluster_plan(64, 256, 256, cluster_size=16)
    assert plan["cluster_size"] == 16
    assert plan["waves"] == 8 and plan["n_res"] == 16
    for C, n_res in ((4, 63), (8, 63), (16, 49)):
        plan = sinkhorn_cluster_plan(16, 784, 784, cluster_size=C)
        assert plan["cluster_size"] == C and plan["n_res"] == n_res
    with pytest.raises(ValueError, match="no cluster layout of size 17"):
        sinkhorn_cluster_plan(4, 20, 20, cluster_size=17)
    # the card refuses every size: no plan, no fallback
    with pytest.raises(ValueError, match="no cluster layout"):
        sinkhorn_cluster_plan(4, 20, 20, active=lambda C, n: 0)


def test_smem_layout_matches_the_source():
    """The plan's byte count follows the kernel's layout constants."""
    src = (_build.CSRC / "sinkhorn.cu").read_text()
    assert re.search(r"constexpr int kThreads = 1024;", src)
    assert re.search(r"constexpr int kRed = 4 \* kThreads;", src)
    assert sf._RED_FLOATS == 4096
    assert sinkhorn_smem_bytes(256, 256, 2, 128) == \
        4 * (128 * 256 + 5 * 256 + 4096 + 2 * 128)
    # rows and vectors padded to a multiple of 4 floats, the total to 16
    # bytes
    assert sinkhorn_smem_bytes(5, 7, 16, 1) == 4 * (8 + 5 * 8 + 4096 + 2) + 8


def test_one_launch_no_iteration_loop_on_the_host():
    """The C entry point launches the iteration kernel once: no launch
    inside a loop over iterations remains in the source."""
    src = (_build.CSRC / "sinkhorn.cu").read_text()
    host = src[src.index('extern "C" int scx_sinkhorn_fused'):]
    assert host.count("cudaLaunchKernelEx") == 1
    assert "<<<" not in src
    assert "for (int it = 0; it < a.iters; ++it)" in src   # in the kernel
