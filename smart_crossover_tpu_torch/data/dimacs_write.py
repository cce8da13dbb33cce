"""DIMACS .min writer — the inverse of data/dimacs.py, so generated MCF
suites (data/mcf_gen.py) round-trip through the same file format the
reference consumes (scripts/min2mcf.py).

Host copy of ``smart_crossover_tpu/data/dimacs_write.py``; only the import
paths differ (the port may not import the JAX package).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from smart_crossover_tpu_torch.models import MinCostFlow


def write_dimacs_min(mcf: MinCostFlow, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = [f"c {mcf.name}", f"p min {mcf.m} {mcf.n}"]
    # b is net inflow requirement; DIMACS supply = -b (positive at sources)
    for i in np.nonzero(mcf.b)[0]:
        lines.append(f"n {i + 1} {float(-mcf.b[i])!r}")
    for j in range(mcf.n):
        cap = mcf.u[j]
        cap_s = f"{float(cap)!r}" if np.isfinite(cap) else "1000000000"
        lines.append(f"a {mcf.tails[j] + 1} {mcf.heads[j] + 1} 0 "
                     f"{cap_s} {float(mcf.c[j])!r}")
    path.write_text("\n".join(lines) + "\n")
