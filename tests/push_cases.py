"""Push inputs shared by two checks: the CPU tests hold the plain loop to
the JAX package's push on them (``tests/test_torch_tree.py``), and the
card tests hold the kernel to the plain loop on the same tensors
(``tests/test_torch_kernels_cuda.py``).  Each is signed tree flows as
``identify_tree_flows`` makes them, built on the CPU: Borůvka's tree of
random weights, then its leaf-elimination flows.  Imports nothing of JAX.
"""
import numpy as np
import torch

from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
from smart_crossover_tpu_torch.ops.tree import bipartite_tree_solve


def tree_flows(B, S, D, seed, dtype=torch.float32, integer=False,
               device="cpu"):
    """(B, S, D) signed tree flows.  With integer supplies and demands the
    flows are integers, so the minimum and both argmaxes tie all along the
    push."""
    rng = np.random.default_rng(seed)
    if integer:
        s = rng.integers(1, 6, (B, S)).astype(np.float64)
        d = np.stack([1 + rng.multinomial(int(t) - D, np.full(D, 1 / D))
                      for t in s.sum(1)]).astype(np.float64)
    else:
        s = rng.uniform(0.5, 2.0, (B, S))
        d = rng.uniform(0.5, 2.0, (B, D))
        d *= (s.sum(1) / d.sum(1))[:, None]
    W = torch.tensor(rng.uniform(0.0, 1.0, (B, S, D)), dtype=dtype,
                     device=device)
    return bipartite_tree_solve(boruvka_bipartite_mst(W),
                                torch.tensor(s, dtype=dtype, device=device),
                                torch.tensor(d, dtype=dtype, device=device))


def _ties():
    X = tree_flows(4, 64, 80, seed=72, integer=True)
    assert bool(((X == X.amin((1, 2), keepdim=True)).sum((1, 2)) > 1).any())
    assert bool(((X == X.amax(2, keepdim=True)).sum(2) > 1).any())
    return X, {}


def _tol():
    X = tree_flows(3, 137, 141, seed=74)
    return X, {"tol": 0.25 * float(-X.amin())}


def _feasible_beside_long():
    X = tree_flows(2, 137, 141, seed=73)
    X[0] = X[0].abs()
    return X, {}


# each case's (X on the CPU, keyword arguments of the push)
CASES = {
    "tree_1x137x141": lambda: (tree_flows(1, 137, 141, seed=75), {}),
    "tree_1x281x36": lambda: (tree_flows(1, 281, 36, seed=76), {}),
    "ties_4x64x80": _ties,
    "max_iter_1": lambda: (tree_flows(4, 137, 141, seed=77),
                           {"max_iter": 1}),
    "tol": _tol,
    "feasible_beside_long": _feasible_beside_long,
    "float64_2x200x150": lambda: (tree_flows(2, 200, 150, seed=78,
                                             dtype=torch.float64), {}),
}
