"""Batch model-file handling.

Parity with the reference FileHandler (filehandling.py:13-98): scan a
directory of .mps models, presolve them in-house, and re-write the reduced
models for the experiment drivers; plus model reports and name lookup.

Host copy of ``smart_crossover_tpu/data/filehandling.py``; only the
import paths differ.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from smart_crossover_tpu_torch.models import GeneralLP


class FileHandler:
    def __init__(self, data_dir: str | Path) -> None:
        self.data_dir = Path(data_dir)

    def model_paths(self) -> list[Path]:
        paths = []
        for pat in ("*.mps", "*.mps.gz", "*.lp", "*.lp.gz"):
            paths += sorted(self.data_dir.glob(pat))
        return paths

    @staticmethod
    def _read(path: Path) -> GeneralLP:
        from smart_crossover_tpu_torch.data.lp_format import read_lp
        from smart_crossover_tpu_torch.data.mps import read_mps

        if path.name.endswith((".lp", ".lp.gz")):
            return read_lp(path)
        return read_mps(path)

    def read_all(self) -> list[GeneralLP]:
        return [self._read(p) for p in self.model_paths()]

    def get_model_by_name(self, name: str) -> GeneralLP:
        for p in self.model_paths():
            if p.stem == name or p.stem == name + ".mps":
                return self._read(p)
        raise FileNotFoundError(f"model {name!r} not in {self.data_dir}")

    def write_presolved_models(self, out_dir: str | Path) -> list[Path]:
        """Presolve every model and write the reduced .mps files
        (the reference's Gurobi-presolve loop, filehandling.py:62-74)."""
        from smart_crossover_tpu_torch.data.mps_write import write_mps
        from smart_crossover_tpu_torch.solvers.presolve import (
            PresolveError,
            presolve_lp,
        )

        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        written = []
        for p in self.model_paths():
            from smart_crossover_tpu_torch.data.mps import read_mps

            lp = read_mps(p)
            try:
                red, _ = presolve_lp(lp)
            except PresolveError as e:
                print(f"skipping {p.stem}: presolve says {e.status}")
                continue
            out = out_dir / f"{p.stem}_presolved.mps"
            write_mps(red, out)
            written.append(out)
        return written

    def get_model_report(self, lp: GeneralLP) -> dict:
        import scipy.sparse as sp

        A = sp.csr_matrix(lp.A)
        return {
            "name": lp.name,
            "rows": lp.m,
            "cols": lp.n,
            "nnz": int(A.nnz),
            "eq_rows": int(np.sum(lp.sense == "=")),
            "le_rows": int(np.sum(lp.sense == "<")),
            "free_cols": int(lp.get_free_ind().size),
            "boxed_cols": int(np.sum(np.isfinite(lp.l) & np.isfinite(lp.u))),
        }
