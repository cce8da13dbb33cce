"""The port's multi-process entry point on the CPU: 2 OS processes, gloo.

As tests/test_multihost.py for the JAX package: each process runs
``python -m smart_crossover_tpu_torch.parallel.multihost --device cpu``,
the processes meet at a tcp:// rendezvous on a free localhost port, and
the column-sharded projector's CG all-reduces and the Sinkhorn row
reductions cross the process boundary.  Processes that do not end in time
are killed and the test fails.
"""
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(n: int, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "smart_crossover_tpu_torch.parallel.multihost",
         "--process-id", str(i), "--num-processes", str(n),
         "--coordinator", f"localhost:{port}", "--device", "cpu", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for i in range(n)]
    deadline = time.monotonic() + TIMEOUT_S
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{n} multihost processes did not end in {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_process_distributed_pipeline():
    for pid, (rc, out, err) in enumerate(_run(2)):
        assert rc == 0, (
            f"proc {pid} failed (rc={rc})\nstdout:\n{out}\nstderr:\n{err}")
        assert f"MULTIHOST_PASS proc={pid} devices=2" in out, out
        assert "projector OK" in out and "sinkhorn OK" in out


def test_projector_bench_runs():
    """``--bench`` times the projector CG at a fixed iteration count."""
    [(rc, out, err)] = _run(1, "--bench", "--m", "16", "--n", "64")
    assert rc == 0, err
    assert "MULTIHOST_BENCH proc=0 procs=1 devices=1 m=16 n=64" in out, out
