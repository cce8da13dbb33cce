"""Solver logging.

Host copy of ``smart_crossover_tpu/utils/logging.py``; only the import
paths differ (the port may not import the JAX package).

The reference routes vendor solver logs to per-instance files and later
regex-scrapes them for metrics (SURVEY.md §5).  Here the log file is a
human-readable audit trail only — metrics flow through Output/ResultStore —
but `SolverSettings.log_file` keeps working for migrating users.
"""
from __future__ import annotations

import datetime
import logging
from pathlib import Path

logger = logging.getLogger("smart_crossover_tpu_torch")


def log_solve(log_file: str, solver: str, method: str, **fields) -> None:
    """Append one structured line to the solver log file (if configured)."""
    if not log_file:
        return
    path = Path(log_file)
    if path.parent and str(path.parent) != ".":
        path.parent.mkdir(parents=True, exist_ok=True)
    parts = [datetime.datetime.now().isoformat(timespec="seconds"),
             solver, method]
    for k, v in fields.items():
        if isinstance(v, datetime.timedelta):
            v = f"{v.total_seconds():.6f}s"
        parts.append(f"{k}={v}")
    with open(path, "a") as fh:
        fh.write(" ".join(str(p) for p in parts) + "\n")


def configure_console(level=logging.INFO) -> None:
    """Convenience: route the framework's loggers to stderr."""
    logging.basicConfig(level=level,
                        format="%(asctime)s %(name)s %(message)s")
