"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program; top-level module names
are compared whole (``smart_crossover_tpu_torch`` begins with the JAX
package's name)."""
import ast
import subprocess
import sys

import pytest

from benchmark.harness import cli, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "smart_crossover_tpu"}
PORT = "smart_crossover_tpu_torch"
SOURCES = sorted(p for p in spec.BENCH_DIR.rglob("*.py")
                 if "tests" not in p.parts)


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_no_jax_and_no_bench_rows(path):
    for name in imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, (path, name)
        assert not name.startswith(f"{PORT}.bench"), (path, name)
        assert name != "chip_smoke", (path, name)


@pytest.mark.parametrize("path", sorted(
    (spec.BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for name in imported(path):
        assert name.split(".")[0] not in FORBIDDEN | {PORT, "benchmark"}, \
            (path, name)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "smart_crossover_tpu_torch_x", sys)
    assert "smart_crossover_tpu" not in cli.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert cli.forbidden_modules() == ["jax"]


def test_a_run_loads_no_jax_module():
    code = ("import sys, time, torch\n"
            "from benchmark.tests.small import run_small\n"
            "run_small('mnist_single_tnet', seconds=0.2)\n"
            "from benchmark.harness.cli import forbidden_modules\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_jax_module_loaded_after_the_window_stops_the_result(
        monkeypatch, capsys):
    from benchmark.tests.small import run_small

    cell, res = run_small("mnist_single_tnet", seconds=0.2)
    device = {"platform": "cpu"}
    assert cli.report(cell, res, False, device) == 0
    assert '"correct": true' in capsys.readouterr().out
    # loaded while judging or reading metrics, after the window's check
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert cli.report(cell, res, False, device) == 4
    out = capsys.readouterr()
    assert out.out == "" and "jaxlib" in out.err
