"""Mesh-sharded MCF flow ranking.

Port of ``smart_crossover_tpu/parallel/ranking_sharded.py``: for one huge
min-cost-flow instance the arc arrays are split over the mesh's 'model'
axis; each node's throughput is an ``index_add_`` segment sum over the
local arcs followed by one all-reduce of the two node vectors, after which
the per-arc indicators are local.  The multi-rank form of
``ops/ranking.py::mcf_flow_indicators``.
"""
from __future__ import annotations

import numpy as np
import torch

from smart_crossover_tpu_torch.config import to_device
from smart_crossover_tpu_torch.parallel.mesh import MODEL_AXIS


def sharded_mcf_flow_indicators(mesh, x, tails, heads, u, num_nodes: int):
    """Per-arc flow indicators with arcs sharded over 'model'.

    Args:
        x, tails, heads, u: (n,) arc arrays; the mesh width divides n.
        num_nodes: m (node vectors are replicated).

    Returns:
        the full (n,) indicators on the rank's device.
    """
    lo, hi = mesh.slice(MODEL_AXIS, len(x))
    x_loc = to_device(x[lo:hi], mesh.device)
    u_loc = to_device(u[lo:hi], mesh.device, x_loc.dtype)
    t_loc, h_loc = (torch.as_tensor(a[lo:hi], dtype=torch.int64,
                                    device=mesh.device)
                    for a in (tails, heads))
    reverse = x_loc > u_loc / 2
    x_hat = torch.where(reverse, u_loc - x_loc, x_loc)
    x_hat = torch.where((x_loc < 0) | (x_loc > u_loc), 0.0, x_hat)
    eff_t = torch.where(reverse, h_loc, t_loc)
    eff_h = torch.where(reverse, t_loc, h_loc)
    flows = torch.zeros(2, num_nodes, dtype=x_hat.dtype, device=mesh.device)
    flows[0].index_add_(0, eff_h, x_hat)
    flows[1].index_add_(0, eff_t, x_hat)
    inflow, outflow = mesh.sum(flows)
    f = torch.maximum(inflow, outflow)
    f_inv = torch.where(f != 0, 1.0 / torch.where(f != 0, f, 1.0), 0.0)
    ind = x_hat * torch.maximum(f_inv[eff_t], f_inv[eff_h])
    return mesh.gather(ind, MODEL_AXIS)


def sharded_sorted_flows(mesh, x, tails, heads, u, num_nodes: int
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Full ranking: sharded indicators, then a host argsort of the
    gathered indicator vector (the queue feeds host-side column
    generation).  Returns (queue, indicators) as numpy."""
    ind = sharded_mcf_flow_indicators(mesh, x, tails, heads, u, num_nodes)
    ind = ind.to("cpu", torch.float64).numpy()
    queue = np.argsort(-ind, kind="stable")
    return queue, ind
