"""Bases for the tests of the float64 certificate, built with numpy from a
seed (no JAX, no card): planted optimal spanning trees at any shape, random
spanning trees, masks with the wrong number of arcs, and S + D - 1 arcs that
hold a cycle."""
import numpy as np


def staircase(S, D, rng):
    """A spanning tree of the S x D bipartite graph: a monotone path of
    cells from (0, 0) to (S - 1, D - 1), S + D - 1 of them."""
    m = np.zeros((S, D), bool)
    i = j = 0
    m[0, 0] = True
    while (i, j) != (S - 1, D - 1):
        if j == D - 1 or (i < S - 1 and rng.random() < S / (S + D)):
            i += 1
        else:
            j += 1
        m[i, j] = True
    return m


def random_tree(S, D, rng):
    """A uniform-weight random spanning tree (Kruskal on a random order of
    the cells)."""
    par = list(range(S + D))

    def find(a):
        while par[a] != a:
            par[a] = par[par[a]]
            a = par[a]
        return a

    m = np.zeros(S * D, bool)
    k = 0
    for f in rng.permutation(S * D):
        i, j = divmod(int(f), D)
        a, b = find(i), find(S + j)
        if a != b:
            par[a] = b
            m[f] = True
            k += 1
            if k == S + D - 1:
                break
    return m.reshape(S, D)


def planted(B, S, D, seed, dtype=np.float64):
    """B instances whose basis (a random spanning tree) is optimal by
    construction: positive flows on its arcs give the masses, and costs
    v_j - u_i on its arcs and above that elsewhere make its duals feasible.
    Returns (mask, s, d, M)."""
    rng = np.random.default_rng(seed)
    masks, ss, dd, Ms = [], [], [], []
    for _ in range(B):
        m = random_tree(S, D, rng)
        x = np.where(m, rng.uniform(0.1, 1.0, (S, D)), 0.0)
        u, v = rng.uniform(0, 2, S), rng.uniform(0, 2, D)
        M = (v[None, :] - u[:, None]) + np.where(
            m, 0.0, rng.uniform(0.01, 1.0, (S, D)))
        masks.append(m)
        ss.append(x.sum(1))
        dd.append(x.sum(0))
        Ms.append(M)
    return (np.stack(masks), np.stack(ss), np.stack(dd),
            np.stack(Ms).astype(dtype))


def masses(B, S, D, seed, dtype=np.float64):
    """Random positive masses with equal totals and uniform(0, 5) costs."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(1) / d.sum(1))[:, None]
    return s, d, rng.uniform(0.0, 5.0, (B, S, D)).astype(dtype)


def random_trees(B, S, D, seed, dtype=np.float64):
    """Random spanning trees of random instances: not optimal."""
    rng = np.random.default_rng(seed)
    s, d, M = masses(B, S, D, seed + 1, dtype)
    return np.stack([random_tree(S, D, rng) for _ in range(B)]), s, d, M


def wrong_counts(S, D, seed):
    """A tree with one arc added and one with one arc taken away."""
    rng = np.random.default_rng(seed)
    more, fewer = random_tree(S, D, rng), random_tree(S, D, rng)
    more.ravel()[np.flatnonzero(~more.ravel())[0]] = True
    fewer.ravel()[np.flatnonzero(fewer.ravel())[-1]] = False
    return np.stack([more, fewer])


def cycles(S, D, seed):
    """S + D - 1 arcs that hold a cycle: the 4-cycle on rows 0-1 and
    columns 0-1 and a staircase tree on the other rows and columns (no node
    left without an arc, a case SciPy's sparse LU reports as singular)."""
    rng = np.random.default_rng(seed)
    m = np.zeros((S, D), bool)
    m[:2, :2] = True
    m[2:, 2:] = staircase(S - 2, D - 2, rng)
    return m[None]


def scattered(S, D, seed):
    """S + D - 1 cells drawn at random: for most shapes several components,
    a cycle and nodes without an arc (SciPy's sparse LU crashed the
    process on 34 x 26 such masks)."""
    rng = np.random.default_rng(seed)
    m = np.zeros(S * D, bool)
    m[rng.choice(S * D, S + D - 1, replace=False)] = True
    return m.reshape(1, S, D)
