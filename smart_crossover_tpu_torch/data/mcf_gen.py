"""Synthetic min-cost-flow instance generation.

Host copy of ``smart_crossover_tpu/data/mcf_gen.py``, unchanged.

The reference benchmarks on GOTO (grid-on-torus) DIMACS instances
(data/README.md; scripts/min2mcf.py converts them).  This module generates
GOTO-like instances locally — torus grid arcs plus random long-range arcs,
graded capacities/costs, one source and one sink — deterministic by seed.
"""
from __future__ import annotations

import numpy as np

from smart_crossover_tpu_torch.models import MinCostFlow


def goto_like_mcf(width: int = 16, height: int = 16, extra_arc_factor: int = 4,
                  supply: float = 100.0, max_cost: float = 100.0,
                  max_cap: float = 30.0, seed: int = 42,
                  regular: bool = False,
                  name: str | None = None) -> MinCostFlow:
    """Grid-on-torus MCF: m = width*height nodes, torus neighbor arcs plus
    `extra_arc_factor * m` random arcs; flow pushed from node 0 to the
    antipodal node.

    ``regular=True`` draws the extra arcs as random Hamiltonian cycles
    instead of i.i.d. endpoint pairs, making in- and out-degree exactly
    ``2 + extra_arc_factor`` at every node — the degree-regular structure
    real GOTO generator output has, and the one the device PDHG's
    reshape/rowsum fast path exploits (solvers/pdhg_mcf.py)."""
    rng = np.random.default_rng(seed)
    m = width * height

    def node(i, j):
        return (i % height) * width + (j % width)

    tails, heads = [], []
    for i in range(height):
        for j in range(width):
            v = node(i, j)
            tails += [v, v]
            heads += [node(i, j + 1), node(i + 1, j)]
    if regular:
        ets, ehs = [], []
        for _ in range(extra_arc_factor):
            cyc = rng.permutation(m)
            ets.append(cyc)
            ehs.append(np.roll(cyc, -1))
        tails = np.concatenate([tails] + ets)
        heads = np.concatenate([heads] + ehs)
    else:
        extra = extra_arc_factor * m
        et = rng.integers(0, m, extra)
        eh = rng.integers(0, m, extra)
        keep = et != eh
        tails = np.concatenate([tails, et[keep]])
        heads = np.concatenate([heads, eh[keep]])
    n = tails.size

    cost = np.round(rng.uniform(1.0, max_cost, n), 2)
    cap = np.round(rng.uniform(max_cap / 3, max_cap, n), 2)
    # widen a random "highway" subset (long cheap-ish corridors)
    hw = rng.uniform(size=n) < 0.1
    cap[hw] = max_cap * 5
    # GOTO instances spread supply over many sources/sinks; a quarter of the
    # nodes participate, each within its local cut capacity
    k = max(m // 4, 1)
    nodes_perm = rng.permutation(m)
    sources = nodes_perm[:k]
    sinks = nodes_perm[k:2 * k]
    per_node = np.zeros(m)
    # per-node capacity sums via bincount: the per-node masked scans were
    # O(k*n) and took tens of minutes at GOTO-17 scale (131k nodes, 1M arcs)
    out_cap = np.bincount(tails, weights=cap, minlength=m)
    in_cap = np.bincount(heads, weights=cap, minlength=m)
    per_node[sources] = -np.minimum(supply / k, 0.4 * out_cap[sources])
    per_node[sinks] = np.minimum(supply / k, 0.4 * in_cap[sinks])
    # balance total supply and demand
    tot_s = -per_node[per_node < 0].sum()
    tot_d = per_node[per_node > 0].sum()
    scale = min(tot_s, tot_d)
    b = np.zeros(m)
    b[per_node < 0] = per_node[per_node < 0] * (scale / tot_s)
    b[per_node > 0] = per_node[per_node > 0] * (scale / tot_d)
    if name is None:
        name = f"goto_like_{width}x{height}_s{seed}"
    return MinCostFlow(tails=tails, heads=heads, c=cost, u=cap, b=b,
                       name=name)


def transshipment_mcf(m: int = 200, arcs_per_node: int = 6,
                      num_terminals: int = 20, seed: int = 0,
                      name: str | None = None) -> MinCostFlow:
    """Random transshipment instance: many sources/sinks, dense-ish random
    arcs, with a guaranteed-feasible high-capacity spanning cycle."""
    rng = np.random.default_rng(seed)
    n_rand = m * arcs_per_node
    tails = rng.integers(0, m, n_rand)
    heads = rng.integers(0, m, n_rand)
    keep = tails != heads
    # spanning cycle for feasibility
    cyc_t = np.arange(m)
    cyc_h = (np.arange(m) + 1) % m
    tails = np.concatenate([cyc_t, cyc_t[::-1], tails[keep]])
    heads = np.concatenate([cyc_h, (cyc_t[::-1] - 1) % m, heads[keep]])
    n = tails.size
    cost = rng.uniform(1.0, 50.0, n)
    cost[: 2 * m] = 200.0  # cycle arcs expensive
    cap = rng.uniform(1.0, 10.0, n)
    terminals = rng.choice(m, size=num_terminals, replace=False)
    b = np.zeros(m)
    amounts = rng.uniform(1.0, 5.0, num_terminals)
    b[terminals] = amounts
    b -= b.sum() / m
    cap[: 2 * m] = np.abs(b).sum()  # cycle can carry everything
    if name is None:
        name = f"transship_{m}_s{seed}"
    return MinCostFlow(tails=tails, heads=heads, c=cost, u=cap, b=b,
                       name=name)
