"""Parity of the port's tree stages with the JAX package (CPU, f64):
ranking, Borůvka MST, tree solve, push, parent vector, ancestor matrix."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_crossover_tpu.network_methods.tree_bi import (
    identify_tree_flows as j_identify,
)
from smart_crossover_tpu.ops import ranking as jrank
from smart_crossover_tpu.ops.mst import boruvka_bipartite_mst as j_mst
from smart_crossover_tpu.ops.transport_simplex_anc import (
    _tree_cells as j_tree_cells,
    build_ancestor_matrix as j_anc,
)
from smart_crossover_tpu.ops.transport_simplex_parent import (
    build_parent_from_mask as j_parent,
)
from smart_crossover_tpu.ops.tree import (
    bipartite_tree_solve as j_tree_solve,
    push_to_bfs as j_push,
)
from smart_crossover_tpu_torch.network_methods.tree_bi import (
    identify_tree_flows,
)
from smart_crossover_tpu_torch.ops import ranking
from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
from smart_crossover_tpu_torch.ops.transport_simplex_anc import (
    _tree_cells,
    build_ancestor_matrix,
)
from smart_crossover_tpu_torch.ops import transport_simplex_parent
from smart_crossover_tpu_torch.ops.transport_simplex_parent import (
    build_parent_from_mask,
)
from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch.ops import tree
from smart_crossover_tpu_torch.ops.tree import (
    bipartite_tree_solve,
    bipartite_tree_solve_plain,
    build_parent_from_mask_plain,
    push_to_bfs,
    push_to_bfs_plain,
    tree_walk,
)
from tests import push_cases

SHAPES = [(2, 13, 29), (3, 24, 40), (2, 48, 24)]


def _batch(B, S, D, seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(1) / d.sum(1))[:, None]
    return rng, s, d


def _weights(rng, B, S, D, kind):
    if kind == "continuous":
        return rng.uniform(0.0, 1.0, (B, S, D))
    # 0/1 support indicator: heavy ties, broken by flat edge id
    return (rng.uniform(0.0, 1.0, (B, S, D)) < 0.15).astype(np.float64)


def _jmasks(W):
    return np.stack([np.asarray(j_mst(jnp.asarray(w))) for w in W])


@pytest.mark.parametrize("shape", SHAPES)
def test_ranking_matches_jax(shape):
    rng, s, d = _batch(*shape, seed=11)
    X = rng.uniform(0.0, 1.0, shape)
    X[X < 0.3] = 0.0     # ties at zero exercise the stable order
    ind = ranking.ot_flow_indicators(*(torch.from_numpy(a) for a in (X, s, d)))
    order = ranking.sort_flows(ind)
    for b in range(shape[0]):
        j_ind = jrank.ot_flow_indicators(X[b], s[b], d[b])
        np.testing.assert_array_equal(ind[b].numpy(), np.asarray(j_ind))
        np.testing.assert_array_equal(order[b].numpy(),
                                      np.asarray(jrank.sort_flows(j_ind)))


@pytest.mark.parametrize("kind", ["continuous", "support"])
@pytest.mark.parametrize("shape", SHAPES)
def test_mst_mask_equal(shape, kind):
    rng, _, _ = _batch(*shape, seed=12)
    W = _weights(rng, *shape, kind)
    mask = boruvka_bipartite_mst(torch.from_numpy(W)).numpy()
    np.testing.assert_array_equal(mask, _jmasks(W))
    assert (mask.sum((1, 2)) == shape[1] + shape[2] - 1).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_tree_solve_and_push_match_jax(shape):
    """Tree flows to abs 1e-12, then the push: same X and the same push
    count per instance."""
    rng, s, d = _batch(*shape, seed=13)
    W = _weights(rng, *shape, "continuous")
    masks = _jmasks(W)
    ts, td = torch.from_numpy(s), torch.from_numpy(d)
    X = bipartite_tree_solve(torch.from_numpy(masks), ts, td)
    Xp, iters = push_to_bfs(X)
    for b in range(shape[0]):
        jX = j_tree_solve(jnp.asarray(masks[b]), s[b], d[b])
        np.testing.assert_allclose(X[b].numpy(), np.asarray(jX), rtol=0,
                                   atol=1e-12)
        jXp, jit = j_push(jX)
        assert int(iters[b]) == int(jit)
        np.testing.assert_allclose(Xp[b].numpy(), np.asarray(jXp), rtol=0,
                                   atol=1e-12)
    assert (Xp.numpy() >= 0).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_identify_tree_flows_matches_jax(shape):
    rng, s, d = _batch(*shape, seed=14)
    W = _weights(rng, *shape, "continuous")
    X, iters = identify_tree_flows(*(torch.from_numpy(a) for a in (W, s, d)))
    for b in range(shape[0]):
        jX, jit = j_identify(jnp.asarray(W[b]), jnp.asarray(s[b]),
                             jnp.asarray(d[b]))
        assert int(iters[b]) == int(jit)
        np.testing.assert_allclose(X[b].numpy(), np.asarray(jX), rtol=0,
                                   atol=1e-12)


def test_push_respects_max_iter():
    X = torch.tensor([[[-1.0, 2.0], [3.0, -0.5]]], dtype=torch.float64)
    Xp, iters = push_to_bfs(X, max_iter=1)
    jXp, jit = j_push(jnp.asarray(X[0].numpy()), max_iter=1)
    assert int(iters[0]) == int(jit) == 1
    np.testing.assert_allclose(Xp[0].numpy(), np.asarray(jXp), atol=1e-15)


@pytest.mark.parametrize("case", list(push_cases.CASES))
def test_push_cases_match_jax(case):
    """The inputs on which the card tests hold the kernel to the plain loop:
    the plain loop's X and steps equal the JAX package's push, instance by
    instance, so the kernel is held to the JAX package through them."""
    X, kw = push_cases.CASES[case]()
    Xp, iters = push_to_bfs(X, **kw)
    for b in range(X.shape[0]):
        jX, jit = j_push(jnp.asarray(X[b].numpy()), **kw)
        assert int(iters[b]) == int(jit)
        np.testing.assert_array_equal(Xp[b].numpy(), np.asarray(jX))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_push_runs_the_plain_loop_on_the_cpu(dtype, monkeypatch):
    """A CPU tensor never reaches the kernel library: the plain loop's X
    and counts, no launch counted."""
    def no_library():
        raise AssertionError("the CPU path must not load the kernels")

    monkeypatch.setattr(_build, "library", no_library)
    rng, s, d = _batch(2, 13, 29, seed=16)
    masks = torch.from_numpy(_jmasks(_weights(rng, 2, 13, 29, "continuous")))
    X = bipartite_tree_solve(masks, torch.from_numpy(s).to(dtype),
                             torch.from_numpy(d).to(dtype))
    n0 = _build.LAUNCHES["tree_push"]
    Xp, iters = push_to_bfs(X)
    Xq, jters = push_to_bfs_plain(X)
    assert torch.equal(Xp, Xq) and torch.equal(iters, jters)
    assert int(iters.max()) > 0 and (Xp >= 0).all()
    assert _build.LAUNCHES["tree_push"] == n0


def _no_library(monkeypatch):
    def no_library():
        raise AssertionError("the CPU path must not load the kernels")

    monkeypatch.setattr(_build, "library", no_library)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tree_solve_runs_the_plain_loop_on_the_cpu(dtype, monkeypatch):
    """A CPU tensor never reaches the tree walk kernel: the plain loop's
    flows, no launch counted."""
    _no_library(monkeypatch)
    rng, s, d = _batch(2, 13, 29, seed=17)
    masks = torch.from_numpy(_jmasks(_weights(rng, 2, 13, 29, "continuous")))
    ts, td = torch.from_numpy(s).to(dtype), torch.from_numpy(d).to(dtype)
    n0 = _build.LAUNCHES["tree_walk"]
    X = bipartite_tree_solve(masks, ts, td)
    assert X.dtype == dtype
    assert torch.equal(X, bipartite_tree_solve_plain(masks, ts, td))
    assert _build.LAUNCHES["tree_walk"] == n0


@pytest.mark.parametrize("kind", ["continuous", "support"])
def test_parent_runs_the_plain_bfs_on_the_cpu(kind, monkeypatch):
    """The parent vector on a CPU tensor, through either module's name:
    the plain BFS, no launch counted."""
    _no_library(monkeypatch)
    rng, _, _ = _batch(3, 24, 40, seed=18)
    masks = torch.from_numpy(_jmasks(_weights(rng, 3, 24, 40, kind)))
    n0 = _build.LAUNCHES["tree_walk"]
    ref = build_parent_from_mask_plain(masks)
    assert torch.equal(build_parent_from_mask(masks), ref)
    assert torch.equal(tree.build_parent_from_mask(masks), ref)
    assert _build.LAUNCHES["tree_walk"] == n0


def test_max_rounds_bounds_the_plain_loops_on_the_cpu(monkeypatch):
    """On a CPU tensor ``max_rounds`` reaches the plain loops: one round
    leaves a deep tree unfinished, enough rounds give the default's
    result."""
    _no_library(monkeypatch)
    rng, s, d = _batch(2, 13, 29, seed=20)
    masks = torch.from_numpy(_jmasks(_weights(rng, 2, 13, 29, "continuous")))
    ts, td = torch.from_numpy(s), torch.from_numpy(d)
    X = bipartite_tree_solve(masks, ts, td)
    parent = build_parent_from_mask(masks)
    assert torch.equal(bipartite_tree_solve(masks, ts, td, 13 + 29 + 2), X)
    assert torch.equal(build_parent_from_mask(masks, 13 + 29 + 2), parent)
    assert not torch.equal(bipartite_tree_solve(masks, ts, td, 1), X)
    assert not torch.equal(build_parent_from_mask(masks, 1), parent)


def test_parent_engine_module_keeps_the_names():
    """The parent vector lives in ``ops/tree.py``; the parent engine's
    module still names the same functions for its callers."""
    assert (transport_simplex_parent.build_parent_from_mask
            is tree.build_parent_from_mask)
    assert (transport_simplex_parent.build_parent_from_mask_plain
            is tree.build_parent_from_mask_plain)


def test_tree_walk_takes_only_card_tensors(monkeypatch):
    """The kernel launcher refuses a CPU tensor before it loads anything."""
    _no_library(monkeypatch)
    masks = torch.from_numpy(_jmasks(_weights(*_batch(1, 5, 7, 19)[:1],
                                              1, 5, 7, "continuous")))
    with pytest.raises(ValueError, match="no kernel for cpu"):
        tree_walk(masks)


@pytest.mark.parametrize("shape", SHAPES)
def test_parent_ancestor_and_cells_equal(shape):
    rng, _, _ = _batch(*shape, seed=15)
    masks = _jmasks(_weights(rng, *shape, "support"))
    parent = build_parent_from_mask(torch.from_numpy(masks))
    N = build_ancestor_matrix(parent)
    ci, cj, notroot = _tree_cells(parent, shape[1], shape[2])
    for b in range(shape[0]):
        jp = j_parent(jnp.asarray(masks[b]))
        np.testing.assert_array_equal(parent[b].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(N[b].numpy(),
                                      np.asarray(j_anc(jp, jnp.float32)))
        jci, jcj, jnr = j_tree_cells(jp, shape[1], shape[2])
        np.testing.assert_array_equal(ci[b].numpy(), np.asarray(jci))
        np.testing.assert_array_equal(cj[b].numpy(), np.asarray(jcj))
        np.testing.assert_array_equal(notroot[b].numpy(), np.asarray(jnr))
    # every node's root path ends at the root, node 0
    assert N[:, :, 0].all()


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
