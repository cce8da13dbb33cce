"""Frozen copy of the port's GOTO-like min-cost-flow generator
(``smart_crossover_tpu_torch/data/mcf_gen.py::goto_like_mcf``): a grid on
a torus plus ``extra_arc_factor`` random arcs per node, graded costs and
capacities, a tenth of the arcs widened into highways, and a quarter of
the nodes as sources and a quarter as sinks.  Returns the arc list as
plain arrays; ``tests/test_bm_gen.py`` holds it equal to the port's."""
from __future__ import annotations

import numpy as np


def goto_like(width: int = 16, height: int = 16, extra_arc_factor: int = 4,
              supply: float = 100.0, max_cost: float = 100.0,
              max_cap: float = 30.0, seed: int = 42,
              regular: bool = False) -> dict:
    """{"tails", "heads", "c", "u", "b"}: arc (tails[j], heads[j]) with
    cost c[j] and capacity u[j]; b is each node's net inflow."""
    rng = np.random.default_rng(seed)
    m = width * height

    # each node v = i * width + j in row-major order sends an arc to its
    # right and one to its lower neighbour on the torus, in that order
    i, j = np.divmod(np.arange(m), width)
    tails = np.repeat(np.arange(m), 2)
    heads = np.stack([i * width + (j + 1) % width,
                      ((i + 1) % height) * width + j], 1).ravel()
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
    hw = rng.uniform(size=n) < 0.1
    cap[hw] = max_cap * 5
    k = max(m // 4, 1)
    nodes_perm = rng.permutation(m)
    sources = nodes_perm[:k]
    sinks = nodes_perm[k:2 * k]
    per_node = np.zeros(m)
    out_cap = np.bincount(tails, weights=cap, minlength=m)
    in_cap = np.bincount(heads, weights=cap, minlength=m)
    per_node[sources] = -np.minimum(supply / k, 0.4 * out_cap[sources])
    per_node[sinks] = np.minimum(supply / k, 0.4 * in_cap[sinks])
    tot_s = -per_node[per_node < 0].sum()
    tot_d = per_node[per_node > 0].sum()
    scale = min(tot_s, tot_d)
    b = np.zeros(m)
    b[per_node < 0] = per_node[per_node < 0] * (scale / tot_s)
    b[per_node > 0] = per_node[per_node > 0] * (scale / tot_d)
    return {"tails": tails.astype(np.int64), "heads": heads.astype(np.int64),
            "c": cost, "u": cap, "b": b}
