"""Solver-state checkpointing.

The reference resumes only at experiment granularity (skip solved
instances); long first-order solves here can additionally checkpoint their
iterate state and resume mid-solve — e.g. PDHG's (x, y) pair feeds back in
through its ``x0``/``y0`` warm-start arguments.

Host copy of ``smart_crossover_tpu/utils/checkpoint.py``; the port's
``pdhg_solve`` takes the saved pair back through ``x0`` / ``y0``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def save_state(path: str | Path, **arrays) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})


def load_state(path: str | Path) -> dict:
    with np.load(Path(path), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
