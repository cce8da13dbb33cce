"""MPS writer (fixed-ish free format).

Host copy of ``smart_crossover_tpu/data/mps_write.py``; only the import
paths differ (the port may not import the JAX package).

With data/mps.py this closes the reference's presolve-and-rewrite loop
(filehandling.py:62-74: read instances, presolve, write reduced models for
the experiment scripts) without any vendor reader/writer.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.sparse as sp

from smart_crossover_tpu_torch.models import GeneralLP


def write_mps(lp: GeneralLP, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    A = sp.csc_matrix(lp.A)
    m, n = A.shape
    rnames = [f"R{i}" for i in range(m)]
    cnames = [f"C{j}" for j in range(n)]
    lines = [f"NAME          {lp.name}", "ROWS", " N  OBJ"]
    for i in range(m):
        tag = "E" if lp.sense[i] == "=" else "L"
        lines.append(f" {tag}  {rnames[i]}")
    lines.append("COLUMNS")
    for j in range(n):
        entries = []
        if lp.c[j] != 0.0:
            entries.append(("OBJ", lp.c[j]))
        start, end = A.indptr[j], A.indptr[j + 1]
        for k in range(start, end):
            if A.data[k] != 0.0:
                entries.append((rnames[A.indices[k]], A.data[k]))
        for r, v in entries:
            lines.append(f"    {cnames[j]}  {r}  {float(v)!r}")
    lines.append("RHS")
    for i in range(m):
        if lp.b[i] != 0.0:
            lines.append(f"    RHS  {rnames[i]}  {float(lp.b[i])!r}")
    lines.append("BOUNDS")
    for j in range(n):
        lj, uj = lp.l[j], lp.u[j]
        if not np.isfinite(lj) and not np.isfinite(uj):
            lines.append(f" FR BND  {cnames[j]}")
            continue
        if np.isfinite(lj) and np.isfinite(uj) and lj == uj:
            lines.append(f" FX BND  {cnames[j]}  {float(lj)!r}")
            continue
        if not np.isfinite(lj):
            lines.append(f" MI BND  {cnames[j]}")
        elif lj != 0.0:
            lines.append(f" LO BND  {cnames[j]}  {float(lj)!r}")
        if np.isfinite(uj):
            lines.append(f" UP BND  {cnames[j]}  {float(uj)!r}")
    lines.append("ENDATA")
    path.write_text("\n".join(lines) + "\n")
