"""Flow-indicator ranking (port of ``smart_crossover_tpu/ops/ranking.py``)."""
from __future__ import annotations

import torch


def ot_flow_indicators(X, s, d):
    """``max(X / s_i, X / d_j)`` per cell: X (B, S, D), s (B, S), d (B, D)."""
    return torch.maximum(X / s[:, :, None], X / d[:, None, :])


def sort_flows(indicators):
    """Per-instance arc queue over the flattened last two axes, largest
    indicator first; ties keep index order (stable)."""
    flat = indicators.reshape(*indicators.shape[:-2], -1)
    return torch.argsort(-flat, dim=-1, stable=True)
