"""The cluster PDHG kernels' layout plans and their rank decompositions,
on the CPU.

``pdhg_batched_split`` (K5), ``pdhg_chunk_split`` (K3) and
``halpern_chunk_split`` (K4) are the kernels' arithmetic in tensor form:
A'y (and for K3 and K5 the curvature and the squared norms) from C ranks'
partials, added in rank order.  In f64 they are held to the plain versions
at 1e-12 and to the TPU kernels in interpret mode at 1e-9, as
tests/test_torch_pdhg.py and tests/test_torch_pdhg_batched.py hold the
plain versions.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_crossover_tpu.ops.pdhg_pallas import (
    get_halpern_chunk_fn,
    get_pdhg_chunk_fn,
)
from smart_crossover_tpu.solvers import pdhg_batched as jpb
from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch.ops import pdhg_cluster as pc
from smart_crossover_tpu_torch.ops.pdhg_chunk import (
    halpern_chunk_plain,
    pdhg_chunk_plain,
)
from smart_crossover_tpu_torch.ops.pdhg_cluster import (
    HALPERN,
    halpern_chunk_split,
    halpern_cluster_smem_bytes,
    pdhg_batched_split,
    pdhg_chunk_split,
    pdhg_cluster_plan,
    pdhg_cluster_smem_bytes,
)
from smart_crossover_tpu_torch.solvers.pdhg_batched import (
    _opnorms,
    pdhg_fixed_batched_plain,
)

BUDGET = pc.SMEM_PER_BLOCK


def _fleet(B, m, n, seed):
    """As tests/test_pdhg_batched.py::make_fleet."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n))
    b = np.einsum("bmn,bn->bm", A, rng.uniform(0.1, 0.9, (B, n)))
    c = rng.standard_normal((B, n))
    return A, b, c, np.zeros((B, n)), np.ones((B, n))


def _chunk_state(m, n, seed):
    """An LP with a third '<' rows and a mid-run state with sums of its
    own."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    b = A @ rng.uniform(0.2, 0.8, n)
    c = A.T @ rng.standard_normal(m) + np.abs(rng.standard_normal(n)) + 0.05
    l, u = np.zeros(n), np.ones(n)
    eq = np.ones(m)
    eq[: m // 3] = 0.0
    x = rng.uniform(0.0, 1.0, n)
    y = 0.1 * rng.standard_normal(m)
    return (A, b, c, l, u, eq, x, y, A @ x, rng.uniform(0.0, 1.0, n),
            rng.standard_normal(m)), float(np.linalg.norm(A, 2))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=tol,
                                   atol=tol)


# C = 1 is the plain sums; 16 > m and 8 > m leave ranks with no rows; n
# ragged (37, 30: not multiples of 4); 3 splits rows and columns unevenly
@pytest.mark.parametrize("shape,C", [
    ((3, 12, 40), 1), ((3, 12, 40), 2), ((3, 12, 40), 3), ((2, 20, 37), 16),
    ((2, 5, 30), 8), ((2, 5, 30), 16)])
def test_batched_split_matches_plain_f64(shape, C):
    A, b, c, l, u = _t(*_fleet(*shape, seed=21))
    opn = _opnorms(A)
    want = pdhg_fixed_batched_plain(A, b, c, l, u, opn,
                                    torch.minimum(torch.maximum(
                                        torch.zeros_like(c), l), u),
                                    torch.zeros_like(b), 20)
    got = pdhg_batched_split(A, b, c, l, u, opn, 20, C)
    _close(got, want, 1e-12)


@pytest.mark.parametrize("shape,C", [
    ((12, 40), 1), ((12, 40), 2), ((12, 40), 3), ((20, 37), 16),
    ((5, 30), 8), ((5, 30), 16)])
def test_chunk_split_matches_plain_f64(shape, C):
    """'<' rows, omega != 1, a mid-run k and sums: one 32-iteration chunk."""
    st, opn = _chunk_state(*shape, seed=22)
    args = (*_t(*st), 0.7, 0.9 / opn, 1.3, 40, opn)
    want = pdhg_chunk_plain(*args, chunk=32)
    got = pdhg_chunk_split(*args, C, chunk=32)
    _close(got[:5], want[:5], 1e-12)
    assert float(got[5]) == pytest.approx(float(want[5]), rel=1e-12)
    assert float(got[6]) == pytest.approx(float(want[6]), rel=1e-12)


@pytest.mark.parametrize("C", [2, 3, 16])
def test_batched_split_matches_pallas_interpret(C):
    """4 x 16 x 128, 40 iterations, against _batched_pdhg_kernel in
    interpret mode (x64), as tests/test_torch_pdhg_batched.py holds the
    plain version."""
    A, b, c, l, u = _fleet(4, 16, 128, seed=23)
    want = jpb.pdhg_dense_batched(A, b, c, l, u, iters=40, use_pallas=True)
    At, bt, ct, lt, ut = _t(A, b, c, l, u)
    got = pdhg_batched_split(At, bt, ct, lt, ut, _opnorms(At), 40, C)
    _close(got, [want[k] for k in ("x", "y", "x_avg", "y_avg")], 1e-9)


@pytest.mark.parametrize("C", [2, 16])
def test_chunk_split_matches_pallas_interpret(rng, C):
    """32 adaptive iterations against _pdhg_chunk_kernel in interpret mode
    (the inputs of tests/test_torch_pdhg.py::test_pdhg_chunk_matches_pallas)."""
    m, n = 16, 128
    A = rng.standard_normal((m, n))
    b, c = rng.standard_normal(m), rng.standard_normal(n)
    l, u = np.zeros(n), np.ones(n)
    eq = (rng.random(m) < 0.5).astype(np.float64)
    x, y = np.full(n, 0.5), np.zeros(m)
    opnorm, eta = 20.0, 0.9 / 20.0
    fn = get_pdhg_chunk_fn(m, n, "float64", 32, interpret=True)
    want = fn(*(jnp.asarray(v) for v in (A, b, c, l, u, eq, x, y, A @ x)),
              jnp.zeros(n), jnp.zeros(m), 0.0, eta, 1.0, 0, opnorm)
    got = pdhg_chunk_split(*_t(A, b, c, l, u, eq, x, y, A @ x, np.zeros(n),
                               np.zeros(m)), 0.0, eta, 1.0, 0, opnorm, C,
                           chunk=32)
    _close(got[:5], want[:5], 1e-9)
    assert float(got[5]) == pytest.approx(float(want[5]), rel=1e-9)
    assert float(got[6]) == pytest.approx(float(want[6]), rel=1e-9)


# resident clusters an H100 reported (cudaOccupancyMaxActiveClusters) for
# the main-path layouts; other sizes count as refused
_CARD = {1: 132, 2: 66, 3: 39, 4: 30, 8: 15, 12: 7, 16: 7}


def _card(C, n_res):
    return _CARD.get(C, 0)


def test_plan_main_path_shapes():
    for active in (None, _card):
        big = pdhg_cluster_plan(64, 256, 512, active=active)
        assert big["cluster_size"] == 2 and big["waves"] == 1
        assert big["n_res"] == 104 and big["rows_in_smem"] == 208
        assert not big["scatter"]
        k3 = pdhg_cluster_plan(1, 512, 2048, active=active)
        assert k3["cluster_size"] == 16 and k3["n_res"] == 25
        assert k3["rows_in_smem"] == 400 and k3["scatter"]
        assert k3["smem_bytes"] <= BUDGET
    # all of A resident at any C, one wave: the smallest C
    for active in (None, _card):
        small = pdhg_cluster_plan(32, 64, 256, active=active)
        assert small["cluster_size"] == 1 and small["waves"] == 1
        assert small["a_in_smem"] == 1.0
    # 200 of them: C = 1 still holds all of A, in two waves
    assert pdhg_cluster_plan(200, 64, 256)["cluster_size"] == 1
    # K4 at 512 x 2048: as K3, in K4's layout
    for active in (None, _card):
        k4 = pdhg_cluster_plan(1, 512, 2048, active=active, layout=HALPERN)
        assert k4["cluster_size"] == 16 and k4["n_res"] == 25
        assert k4["rows_in_smem"] == 400 and k4["scatter"]
        assert k4["smem_bytes"] == halpern_cluster_smem_bytes(512, 2048, 16,
                                                              25)


def test_plan_takes_fewest_waves_first():
    # 200 LPs of 256 x 512: C = 1 runs them in two waves, C = 2 in four
    plan = pdhg_cluster_plan(200, 256, 512)
    assert plan["cluster_size"] == 1 and plan["waves"] == 2
    # the card refuses C > 2: the best of the rest
    plan = pdhg_cluster_plan(64, 256, 512,
                             active=lambda C, n: 132 // C if C <= 2 else 0)
    assert plan["cluster_size"] == 2


@pytest.mark.parametrize("B,m,n", [
    (1, 2, 2), (64, 256, 512), (32, 64, 256), (1, 512, 2048), (3, 17, 70),
    (2, 5, 70), (1, 1000, 3000), (500, 30, 30)])
def test_plan_covers_rows_and_fits(B, m, n):
    for active in (None, lambda C, n_res: 528 // C):
        plan = pdhg_cluster_plan(B, m, n, active=active)
        C = plan["cluster_size"]
        ranges = plan["row_ranges"]
        assert len(ranges) == C
        assert [r for lo, hi in ranges for r in range(lo, hi)] == \
            list(range(m))
        assert plan["n_res"] <= -(-m // C)
        assert plan["rows_in_smem"] == sum(min(hi - lo, plan["n_res"])
                                           for lo, hi in ranges)
        assert plan["smem_bytes"] == pdhg_cluster_smem_bytes(m, n, C,
                                                             plan["n_res"])
        assert plan["smem_bytes"] <= BUDGET
        if plan["n_res"] < -(-m // C):    # one more resident row would not fit
            assert pdhg_cluster_smem_bytes(m, n, C, plan["n_res"] + 1) > BUDGET


def test_plan_follows_a_lowered_budget():
    m, n, C = 37, 301, 3
    full = pdhg_cluster_plan(1, m, n, cluster_size=C)
    assert full["n_res"] == 13 and full["a_in_smem"] == 1.0
    for k in (0, 1, 5, 12):
        plan = pdhg_cluster_plan(1, m, n, pdhg_cluster_smem_bytes(m, n, C, k),
                                 cluster_size=C)
        assert plan["n_res"] == k
        assert plan["rows_in_smem"] == sum(min(hi - lo, k)
                                           for lo, hi in plan["row_ranges"])
    least = min(pdhg_cluster_smem_bytes(m, n, C, 0) for C in range(1, 17))
    assert pdhg_cluster_plan(1, m, n, least)["n_res"] == 0
    with pytest.raises(ValueError, match="no cluster layout"):
        pdhg_cluster_plan(1, m, n, least - 16)
    # K4's layout
    full = pdhg_cluster_plan(1, m, n, cluster_size=C, layout=HALPERN)
    assert full["n_res"] == 13 and full["a_in_smem"] == 1.0
    for k in (0, 1, 5, 12):
        budget = halpern_cluster_smem_bytes(m, n, C, k)
        plan = pdhg_cluster_plan(1, m, n, budget, cluster_size=C,
                                 layout=HALPERN)
        assert plan["n_res"] == k
        assert plan["rows_in_smem"] == sum(min(hi - lo, k)
                                           for lo, hi in plan["row_ranges"])
    least = min(halpern_cluster_smem_bytes(m, n, C, 0) for C in range(1, 17))
    assert pdhg_cluster_plan(1, m, n, least, layout=HALPERN)["n_res"] == 0
    with pytest.raises(ValueError, match="no cluster layout"):
        pdhg_cluster_plan(1, m, n, least - 16, layout=HALPERN)


def test_plan_forced_size():
    for C, n_res in ((1, 101), (2, 104), (3, 86)):
        plan = pdhg_cluster_plan(64, 256, 512, cluster_size=C)
        assert plan["cluster_size"] == C and plan["n_res"] == n_res
        assert plan["scatter"] is False
    assert pdhg_cluster_plan(1, 512, 2048, cluster_size=8)["scatter"]
    assert pdhg_cluster_plan(1, 512, 2048, cluster_size=9)["scatter"]
    with pytest.raises(ValueError, match="no cluster layout of size 17"):
        pdhg_cluster_plan(4, 20, 20, cluster_size=17)
    # the card refuses every size: no plan, no fallback
    with pytest.raises(ValueError, match="no cluster layout"):
        pdhg_cluster_plan(4, 20, 20, active=lambda C, n: 0)
    # K4's layout: the scatter at every size
    for C, n_res in ((1, 19), (2, 23), (4, 24), (8, 25), (16, 25)):
        plan = pdhg_cluster_plan(1, 512, 2048, cluster_size=C,
                                 layout=HALPERN)
        assert plan["cluster_size"] == C and plan["n_res"] == n_res
        assert plan["scatter"]
    with pytest.raises(ValueError, match="no cluster layout of size 17"):
        pdhg_cluster_plan(1, 20, 20, cluster_size=17, layout=HALPERN)
    with pytest.raises(ValueError, match="no cluster layout"):
        pdhg_cluster_plan(1, 20, 20, active=lambda C, n: 0, layout=HALPERN)


def test_smem_layout_matches_the_source():
    """The plans' byte counts follow the kernels' layouts."""
    src = (_build.CSRC / "pdhg_cluster.cu").read_text()
    assert re.search(r"constexpr int kThreads = 512;", src)
    assert re.search(r"constexpr int kScratch = 128;", src)
    assert pc._THREADS == 512 and pc._SCRATCH_FLOATS == 128
    # 256 x 512 at C = 2: 104 rows, x and x_c, two 256-column slices of
    # partials, 4 row groups of partials, the rank's 256-column slice, seven
    # vectors of 128 rows
    assert pdhg_cluster_smem_bytes(256, 512, 2, 104) == \
        4 * (104 * 512 + 2 * 512 + 512 + 4 * 512 + 256 + 7 * 128 + 128)
    # 512 x 2048 at C = 16: one row group (512 column quads), 32 rows
    assert pdhg_cluster_smem_bytes(512, 2048, 16, 25) == \
        4 * (25 * 2048 + 2 * 2048 + 2048 + 128 + 7 * 32 + 128)
    # n padded to 4 (72), 16 slices of two quads (more than np), ceil(m / C)
    # padded to 4
    assert pdhg_cluster_smem_bytes(5, 70, 16, 1) == \
        4 * (72 + 2 * 72 + 16 * 8 + 28 * 72 + 8 + 7 * 4 + 128)
    # K4: 512 x 2048 at C = 16: 25 rows, x_t, 16 slices of 128 partials,
    # x, xa, c, l, u of the rank's 128 columns, six vectors of 32 rows
    assert "np + C * cp + (G > 1 ? G * np : 0) + 5 * cp +" in src
    assert "6 * rp;" in src
    assert halpern_cluster_smem_bytes(512, 2048, 16, 25) == \
        4 * (25 * 2048 + 2048 + 16 * 128 + 5 * 128 + 6 * 32)
    # 256 x 512 at C = 2: x_t, two 256-column slices of partials, 4 row
    # groups, five vectors of the rank's 256 columns, six of 128 rows
    assert halpern_cluster_smem_bytes(256, 512, 2, 10) == \
        4 * (10 * 512 + 512 + 2 * 256 + 4 * 512 + 5 * 256 + 6 * 128)
    # n padded to 4 (72): 28 row groups, 16 slices of two quads
    assert halpern_cluster_smem_bytes(5, 70, 16, 1) == \
        4 * (72 + 72 + 16 * 8 + 5 * 8 + 28 * 72 + 6 * 4)
    # one rank: all np columns are its slice
    assert halpern_cluster_smem_bytes(5, 70, 1, 5) == \
        4 * (5 * 72 + 72 + 72 + 28 * 72 + 5 * 72 + 6 * 8)


@pytest.mark.parametrize("layout", [pc.ADAPTIVE, pc.HALPERN])
def test_layout_names_its_entry_points(layout):
    """Each kernel's layout pairs its byte count with the source's entry
    points, which take the arguments the plan passes."""
    fn = layout.smem_bytes.__name__.replace("_smem_bytes", "")
    assert layout.smem_entry == f"scx_{fn}_smem_bytes"
    assert layout.clusters_entry == f"scx_{fn}_max_clusters"
    assert len(_build._SIGNATURES[layout.smem_entry]) == 4       # m, n, C, n_res
    assert len(_build._SIGNATURES[layout.clusters_entry]) == 5   # and B
    src = (_build.CSRC / "pdhg_cluster.cu").read_text()
    assert f'extern "C" int {layout.smem_entry}(int m, int n, int C, ' \
        f"int n_res)" in src
    assert f'extern "C" int {layout.clusters_entry}(int B, int m, int n, ' \
        f"int C, int n_res)" in src


def test_one_launch_no_iteration_loop_on_the_host():
    """Each C entry point launches its iteration kernel once; the old
    one-block and cooperative designs are gone."""
    src = (_build.CSRC / "pdhg_cluster.cu").read_text()
    assert src.count("cudaLaunchKernelEx") == 1
    assert "<<<" not in src
    # in the kernels: the adaptive one and the Halpern one
    assert src.count("for (int it = 0; it < a.iters; ++it)") == 2
    # adaptive: start, A, A2 (scatter), B, exit; Halpern: start, A, exit,
    # and A2 split into arrive and wait
    assert src.count("cl.sync();") == 8
    assert src.count("cl.barrier_arrive();") == 1
    assert src.count("cl.barrier_wait();") == 1
    assert not (_build.CSRC / "pdhg_chunk.cu").exists()
    assert not (_build.CSRC / "pdhg_batched.cu").exists()
    for name in _build.SOURCES:
        text = (_build.CSRC / name).read_text()
        assert "cudaLaunchCooperativeKernel" not in text
        assert "this_grid" not in text


# ------------------------------------------------------------------- K4

def _halpern_state(m, n, seed):
    """_chunk_state's LP with its state and anchors of their own."""
    (A, b, c, l, u, eq, x, y, Ax, xa, ya), opn = _chunk_state(m, n, seed)
    ya = 0.1 * ya
    return (A, b, c, l, u, eq, x, y, Ax, xa, ya, A @ xa), opn


@pytest.mark.parametrize("shape,C", [
    ((12, 40), 1), ((12, 40), 2), ((12, 40), 3), ((20, 37), 16),
    ((5, 30), 8), ((5, 30), 16)])
def test_halpern_split_matches_plain_f64(shape, C):
    """'<' rows, omega != 1, a mid-window k and anchors of their own: one
    32-iteration chunk."""
    st, opn = _halpern_state(*shape, seed=24)
    args = (*_t(*st), 1.3, 40.0, 0.99 / opn)
    want = halpern_chunk_plain(*args, chunk=32)
    got = halpern_chunk_split(*args, C, chunk=32)
    _close(got[:3], want[:3], 1e-12)
    assert float(got[3]) == float(want[3]) == 72.0


@pytest.mark.parametrize("C", [2, 16])
def test_halpern_split_matches_pallas_interpret(rng, C):
    """32 Halpern iterations against _halpern_chunk_kernel in interpret
    mode (the inputs of
    tests/test_torch_pdhg.py::test_halpern_chunk_matches_pallas)."""
    m, n = 16, 128
    A = rng.standard_normal((m, n))
    b, c = rng.standard_normal(m), rng.standard_normal(n)
    l, u = np.zeros(n), np.ones(n)
    eq = (rng.random(m) < 0.5).astype(np.float64)
    x = np.full(n, 0.5)
    xa = rng.uniform(0.0, 1.0, n)
    ya = 0.1 * rng.standard_normal(m)
    y = 0.1 * rng.standard_normal(m)
    omega, k, step = 1.3, 5.0, 0.99 / 20.0
    fn = get_halpern_chunk_fn(m, n, "float64", 32, interpret=True)
    want = fn(*(jnp.asarray(v) for v in (A, b, c, l, u, eq, x, y, A @ x, xa,
                                          ya, A @ xa)), omega, k, step)
    got = halpern_chunk_split(*_t(A, b, c, l, u, eq, x, y, A @ x, xa, ya,
                                  A @ xa), omega, k, step, C, chunk=32)
    _close(got[:3], want[:3], 1e-9)
    assert float(got[3]) == float(want[3]) == k + 32


@pytest.mark.parametrize("m,n", [
    (2, 2), (256, 512), (64, 256), (512, 2048), (17, 70), (5, 70),
    (1000, 3000), (30, 30)])
def test_halpern_plan_covers_rows_and_fits(m, n):
    for active in (None, lambda C, n_res: 132 // C):
        plan = pdhg_cluster_plan(1, m, n, active=active, layout=HALPERN)
        C = plan["cluster_size"]
        ranges = plan["row_ranges"]
        assert len(ranges) == C
        assert [r for lo, hi in ranges for r in range(lo, hi)] == \
            list(range(m))
        assert plan["n_res"] <= -(-m // C)
        assert plan["rows_in_smem"] == sum(min(hi - lo, plan["n_res"])
                                           for lo, hi in ranges)
        assert plan["smem_bytes"] == halpern_cluster_smem_bytes(
            m, n, C, plan["n_res"])
        assert plan["smem_bytes"] <= BUDGET and plan["scatter"]
        if plan["n_res"] < -(-m // C):    # one more resident row would not fit
            assert halpern_cluster_smem_bytes(
                m, n, C, plan["n_res"] + 1) > BUDGET
