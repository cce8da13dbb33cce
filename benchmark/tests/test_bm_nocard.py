"""Without a card a run exits non-zero and prints no result; on a card
(marked ``cuda``) a short run prints the contract's line."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import spec

CMD = [sys.executable, "benchmark/run.py", "--seed", str(2**31 + 3),
       "--seconds", "2", "--trace", "0", "--workload"]


def _run(cwd, cell, timeout=600):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(CMD + [cell], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout, env=env)


def _has_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "metrics" in json.loads(line):
                return True
        except (ValueError, TypeError):
            pass
    return False


def test_no_card_exits_nonzero_without_a_result():
    out = _run(spec.ROOT, "dotmark32_batch16")
    assert out.returncode != 0
    assert not _has_result(out.stdout)
    assert "CUDA" in out.stderr


def test_a_checkout_without_the_program_exits_nonzero(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "goto17_single_cnet")
    assert out.returncode != 0
    assert not _has_result(out.stdout)


def test_an_unknown_cell_exits_nonzero():
    out = _run(spec.ROOT, "no_such_cell")
    assert out.returncode != 0 and not _has_result(out.stdout)


@pytest.mark.cuda
def test_a_short_run_on_the_card_prints_the_line():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(CMD + ["mnist_single_tnet"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks" and line["correct"]
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"request_p95_ms", "setup_s"}
