"""Load ``BENCHMARK.json`` and the files it names.

A cell (``workloads`` entry) names a configuration (``configs/<name>.json``
via its ``file``) and a traffic mix (``workloads/<traffic>.json``).  The
traffic file names its request kind (``requests/<kind>.py``).  Per-layer
metrics are read by ``metrics/<name>.py``, end-to-end metrics by
``endtoend/<name>.py``.  Every such file is loaded by path and found by
the name alone, so a later change adds a cell or a metric by adding files.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Metric:
    name: str
    unit: str
    workloads: list | None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_module(path: Path, prefix: str):
    """The Python file at ``path`` as a module named ``prefix`` + its
    stem (dots replaced), never put on ``sys.path``."""
    name = prefix + re.sub(r"[^A-Za-z0-9_]", "_", path.stem)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _metric(entry: dict) -> Metric:
    return Metric(entry["name"], entry["unit"], entry.get("workloads"))


def load_cell(name: str, spec: dict | None = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    its traffic mix and the metrics it reports."""
    spec = benchmark_json(root) if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "workloads" / f"{w['traffic']}.json")
    e2e = [m for m in map(_metric, spec["end_to_end"]) if m.applies_to(name)]
    layer = [m for m in map(_metric, spec["per_layer"]) if m.applies_to(name)]
    return Cell(name, int(w["chips"]), config, w["traffic"], traffic,
                e2e, layer)


def request_kind(kind: str):
    return load_module(BENCH_DIR / "requests" / f"{kind}.py", "bm_request_")


def metric_reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "bm_metric_")


def end_to_end_reader(name: str):
    return load_module(BENCH_DIR / "endtoend" / f"{name}.py", "bm_e2e_")
