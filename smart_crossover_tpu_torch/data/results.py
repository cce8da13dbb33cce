"""Structured, resumable experiment result store.

Replaces the reference's pickle blobs + regex-scraped solver logs
(reference filehandling.py:101-111, run_perturb_crossover.py:12-28,
visualization.py:21-112) with JSON-lines records: one line per
(instance, method) with the metrics the analysis layer needs — no
log-scraping, and restarts skip already-solved work exactly like the
reference's `find_solved_problems`.

Host copy of ``smart_crossover_tpu/data/results.py``.
"""
from __future__ import annotations

import datetime
import json
from pathlib import Path
from typing import Any, Iterator


class ResultStore:
    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def record(self, instance: str, method: str, **metrics: Any) -> None:
        row = {"instance": instance, "method": method,
               "ts": datetime.datetime.now().isoformat()}
        for k, v in metrics.items():
            if isinstance(v, datetime.timedelta):
                v = v.total_seconds()
            elif hasattr(v, "item"):
                v = v.item()
            row[k] = v
        with open(self.path, "a") as fh:
            fh.write(json.dumps(row) + "\n")

    def rows(self) -> Iterator[dict]:
        if not self.path.exists():
            return
        with open(self.path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    yield json.loads(line)

    def solved(self, method: str | None = None) -> set[str]:
        """Instances already recorded (for resume-on-restart)."""
        done = set()
        for row in self.rows():
            if method is None or row.get("method") == method:
                done.add(row["instance"])
        return done

    def is_solved(self, instance: str, method: str | None = None) -> bool:
        return instance in self.solved(method)


def write_results_to_pickle(obj, path) -> None:
    """Legacy-compatible pickle result IO (reference filehandling.py:101-111).
    Prefer ResultStore for new code."""
    import pickle
    from pathlib import Path

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(obj, fh)


def read_results_from_pickle(path):
    import pickle

    with open(path, "rb") as fh:
        return pickle.load(fh)
