"""Every file that ``BENCHMARK.json`` names loads, and every name, unit
and key keeps to the benchmark contract's characters and shapes."""
import json
import re

import pytest

from benchmark.harness import spec

DOC = spec.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in DOC["workloads"]]


def test_top_level_keys_and_size():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(DOC)) < 64 * 1024
    assert DOC["paths"] == ["benchmark"]
    assert DOC["command"][1].startswith("benchmark/")
    assert isinstance(DOC["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in DOC[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert TEXT.match(e[key]), (e["name"], key)
    assert len(names) == len(set(names))
    for w in DOC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    pairs = [(w["config"], w["traffic"]) for w in DOC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_entries():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in DOC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"]
        if m["name"].endswith("_roofline") or "_roofline" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_with_its_files(cell):
    c = spec.load_cell(cell)
    kind = spec.request_kind(c.traffic["kind"])
    assert set(kind.NUMBERS) <= set(c.traffic["limits"])
    for fn in ("setup", "prepare", "send", "keep", "units", "delivered",
               "judge", "control"):
        assert callable(getattr(kind, fn)), fn
    assert any(m.name == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and len(c.per_layer) >= 1
    for m in c.end_to_end:
        assert callable(spec.end_to_end_reader(m.name).read)
    for m in c.per_layer:
        assert callable(spec.metric_reader(m.name).read)


@pytest.mark.parametrize("entry", DOC["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    path = spec.ROOT / entry["file"]
    assert entry["file"].startswith("benchmark/configs/")
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert entry["name"] in {w["config"] for w in DOC["workloads"]}
    assert (spec.ROOT / cfg["reference"]).is_file()
    assert cfg["precision"] and cfg["certificate"]
