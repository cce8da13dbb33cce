"""Per-item seeds of a pool, drawn from the run's ``--seed``."""
from __future__ import annotations

import numpy as np


def item_seeds(seed: int, n: int) -> list:
    """n seeds for the pool's items: the same ``seed`` (any whole number,
    negative or above 2**63 included) gives the same list."""
    ss = np.random.SeedSequence(int(seed) % 2**64)
    return [int(v) for v in ss.generate_state(n, dtype=np.uint64)]
