"""The port's numpy certifier against the JAX package's, on the same bases:
the same verdict, objective rtol 1e-12, the same diagnostics."""
import numpy as np
import pytest
import torch

from smart_crossover_tpu.network_methods import certify as jcert
from smart_crossover_tpu_torch.network_methods import certify as tcert
from smart_crossover_tpu_torch.ops import certify as kernel
from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
from smart_crossover_tpu_torch.parallel.batched import (
    batched_tnet_exact_device,
)
from smart_crossover_tpu_torch.utils import trace
from tests import certify_cases as cc


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


def _batch_of_every_kind(S, D, seed):
    """Planted optimal trees, random trees, a mask with one arc too many
    and one with one too few, and S + D - 1 arcs that hold a cycle, on one
    batch of random masses (the planted ones with their own)."""
    Bm, s, d, M = cc.planted(2, S, D, seed)
    Bt, st, dt, Mt = cc.random_trees(2, S, D, seed + 1)
    bad = np.concatenate([cc.wrong_counts(S, D, seed + 2),
                          cc.cycles(S, D, seed + 3)])
    sb, db, Mb = cc.masses(3, S, D, seed + 4)
    return (np.concatenate([Bm, Bt, bad]), np.concatenate([s, st, sb]),
            np.concatenate([d, dt, db]), np.concatenate([M, Mt, Mb]))


def _same(a, b):
    assert (a.ok, a.reason) == (b.ok, b.reason)
    assert np.array_equal(a.x, b.x)
    for k in ("obj_val", "max_feas_err", "min_flow", "min_rcost"):
        assert np.array_equal(getattr(a, k), getattr(b, k), equal_nan=True)


def _no_kernel(*args, **kwargs):
    raise AssertionError("the CPU path asked for the certificate kernel")


@pytest.mark.parametrize("card,device,tensors", [
    (False, None, False), (False, None, True), (True, "cpu", False),
    (True, "cpu", True)])
def test_certify_batch_on_the_cpu_is_the_scipy_path(monkeypatch, card,
                                                     device, tensors):
    """``device='cpu'``, and a machine with no card, certify each instance
    with ``certify_ot_basis``: the certificates it gives alone, bit for
    bit, the kernel never asked; CPU tensors as numpy arrays."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(kernel, "certify_batch_cuda", _no_kernel)
    Bm, s, d, M = _batch_of_every_kind(13, 29, seed=24)
    args = [torch.from_numpy(a) for a in (Bm, s, d, M)] if tensors \
        else (Bm, s, d, M)
    got = tcert.certify_ot_basis_batch(*args, device=device)
    want = [tcert.certify_ot_basis(Bm[i], s[i], d[i], M[i])
            for i in range(len(M))]
    for a, b in zip(got, want):
        _same(a, b)
    assert [c.ok for c in got] == [True, True] + [False] * 5
    assert got[6].reason.startswith("tree solve failed")


def _plain_kernel(Bm, s, d, M, device):
    """The kernel's outputs as the plain certifier gives them."""
    B, S, D = M.shape
    n1 = S + D - 1
    status = np.full(B, kernel.TREE, np.int32)
    n_arcs = np.count_nonzero(Bm.reshape(B, -1), axis=1)
    nums = np.full((B, 4), np.nan)
    arcs = np.zeros((B, n1), np.int64)
    flows = np.zeros((B, n1))
    for b in range(B):
        c = tcert.certify_ot_basis(Bm[b], s[b], d[b], M[b])
        if n_arcs[b] != n1:
            status[b] = kernel.COUNT
        elif c.reason.startswith("tree solve failed"):
            status[b] = kernel.CYCLE
        else:
            arcs[b] = np.flatnonzero(Bm[b])
            flows[b] = c.x.ravel()[arcs[b]]
            nums[b] = (c.max_feas_err, c.min_flow, c.min_rcost, c.obj_val)
    return status, n_arcs, nums, arcs, flows


def test_certify_batch_takes_numpy_inputs_to_the_card(monkeypatch):
    """With a card present, numpy inputs go to the kernel's path, whose
    outputs become the same certificates as the plain certifier's: the
    flows scattered into zeros, the verdict and its reasons; a cycle
    refused as a failed tree solve."""
    calls = []

    def fake(*args):
        calls.append(args[-1])
        return _plain_kernel(*args)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(kernel, "certify_batch_cuda", fake)
    Bm, s, d, M = _batch_of_every_kind(24, 40, seed=25)
    got = tcert.certify_ot_basis_batch(Bm, s, d, M)
    assert [str(dev) for dev in calls] == ["cuda"]
    for i, a in enumerate(got):
        b = tcert.certify_ot_basis(Bm[i], s[i], d[i], M[i])
        if i == 6:
            assert not a.ok and a.reason.startswith("tree solve failed")
            assert not a.x.any() and np.isnan(a.obj_val)
        else:
            _same(a, b)
    with trace.recording() as st:
        tcert.certify_ot_basis_batch(Bm, s, d, M, feas_tol=1e3,
                                     rcost_tol=1e3)
    assert st.summary()["scx.certify"]["counters"] == {"certify.rejected": 3}


@pytest.mark.parametrize("shape", [(5, 9), (40, 24), (1, 6)])
def test_planted_trees_are_optimal(shape):
    """The card tests' planted bases certify (in float64 and from float32
    costs), and both certifiers agree on them."""
    S, D = shape
    for dtype in (np.float64, np.float32):
        Bm, s, d, M = cc.planted(3, S, D, seed=26, dtype=dtype)
        assert (Bm.sum((1, 2)) == S + D - 1).all()
        t = tcert.certify_ot_basis_batch(Bm, s, d, M, device="cpu")
        j = jcert.certify_ot_basis_batch(Bm, s, d, M)
        assert all(c.ok for c in t)
        for a, b in zip(t, j):
            _agree(a, b)
