"""Flow-indicator ranking (port of ``smart_crossover_tpu/ops/ranking.py``).

``mcf_flow_indicators`` runs one arc list on the device it is given: the
JAX package's ``segment_sum`` calls are ``index_add_`` here and its
gathers plain indexing.  Its caller no longer pads the arc arrays to a
power of two (``MCFManager.get_sorted_flows``): that padding only let
instances share one XLA compile.
"""
from __future__ import annotations

import torch


def mcf_flow_indicators(x, tails, heads, u, num_nodes: int):
    """Per-arc flow indicators of a min-cost-flow solution (reference
    net_manager.py:156-184): arcs carrying more than half their capacity
    are reversed (``x_hat = u - x``), out-of-bound flows count as 0, each
    node's throughput is ``max(inflow, outflow)`` of ``x_hat`` over the
    reversed graph, and ``indicator_j = x_hat_j * max(1 / f_tail(j),
    1 / f_head(j))`` (0 where the throughput is 0).

    Args:
        x: (n,) flow; tails, heads: (n,) int64 arc endpoints; u: (n,)
            capacities (may be +inf), all on one device.
        num_nodes: number of nodes m.
    """
    reverse = x > u / 2                      # never for u == +inf
    x_hat = torch.where(reverse, u - x, x)
    x_hat = torch.where((x < 0) | (x > u), 0.0, x_hat)
    eff_tails = torch.where(reverse, heads, tails)
    eff_heads = torch.where(reverse, tails, heads)
    def node_sum(idx):
        return torch.zeros(num_nodes, dtype=x_hat.dtype,
                           device=x_hat.device).index_add_(0, idx, x_hat)

    inflow = node_sum(eff_heads)
    outflow = node_sum(eff_tails)
    f = torch.maximum(inflow, outflow)
    f_inv = torch.where(f != 0, 1.0 / torch.where(f != 0, f, 1.0), 0.0)
    return x_hat * torch.maximum(f_inv[eff_tails], f_inv[eff_heads])


def ot_flow_indicators(X, s, d):
    """``max(X / s_i, X / d_j)`` per cell: X (B, S, D), s (B, S), d (B, D).

    A term whose mass is 0 counts 0 (not 0 / 0 = NaN, which would win the
    maximum and leave Borůvka without a finite edge at that node), so a
    zero-mass row or column still joins the spanning tree.  Where every
    mass is positive this is the plain quotient, bit for bit.  The JAX
    package keeps the NaN (ROADMAP fault 3.15)."""
    s, d = s[:, :, None], d[:, None, :]
    return torch.maximum(torch.where(s > 0, X / s, 0.0),
                         torch.where(d > 0, X / d, 0.0))


def sort_flows(indicators):
    """Per-instance arc queue over the flattened last two axes, largest
    indicator first; ties keep index order (stable)."""
    flat = indicators.reshape(*indicators.shape[:-2], -1)
    return torch.argsort(-flat, dim=-1, stable=True)
