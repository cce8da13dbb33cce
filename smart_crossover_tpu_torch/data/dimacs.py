"""DIMACS .min reader -> MinCostFlow.

Host copy of ``smart_crossover_tpu/data/dimacs.py``; only the import paths
differ (the port may not import the JAX package).

Capability parity with the reference's GOTO-instance converter
(reference scripts/min2mcf.py:12-68), built directly on the arc-list format.
Nonzero arc lower bounds are shifted out (x' = x - low), adjusting node
balances and capacities, so the result fits the 0 <= x <= u contract.
"""
from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

from smart_crossover_tpu_torch.models import MinCostFlow


def read_dimacs_min(path: str | Path) -> MinCostFlow:
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    num_nodes = num_arcs = None
    supplies: dict[int, float] = {}
    tails, heads, lows, caps, costs = [], [], [], [], []
    with opener(path, "rt") as fh:
        for raw in fh:
            tok = raw.split()
            if not tok:
                continue
            if tok[0] == "c":
                continue
            if tok[0] == "p":
                assert tok[1] == "min", "not a min-cost-flow DIMACS file"
                num_nodes, num_arcs = int(tok[2]), int(tok[3])
            elif tok[0] == "n":
                supplies[int(tok[1])] = float(tok[2])
            elif tok[0] == "a":
                tails.append(int(tok[1]) - 1)
                heads.append(int(tok[2]) - 1)
                lows.append(float(tok[3]))
                caps.append(float(tok[4]))
                costs.append(float(tok[5]))
    if num_nodes is None:
        raise ValueError(f"{path}: missing 'p min' problem line")

    tails = np.asarray(tails, dtype=np.int64)
    heads = np.asarray(heads, dtype=np.int64)
    lows = np.asarray(lows)
    caps = np.asarray(caps)
    costs = np.asarray(costs)

    # DIMACS 'n' lines give supply (positive = source); our b is net inflow
    # requirement, so b = -supply at sources, +demand at sinks.
    b = np.zeros(num_nodes)
    for node, sup in supplies.items():
        b[node - 1] = -sup

    # shift out lower bounds
    if np.any(lows != 0):
        np.add.at(b, tails, lows)
        np.add.at(b, heads, -lows)
        caps = caps - lows
    return MinCostFlow(tails=tails, heads=heads, c=costs, u=caps, b=b,
                       name=path.stem)
