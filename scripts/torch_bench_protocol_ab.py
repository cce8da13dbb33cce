#!/usr/bin/env python3
"""The benchmark's protocol against chip_smoke.py main's, in one process.

    python3 scripts/torch_bench_protocol_ab.py

`python -m smart_crossover_tpu_torch bench` hands batched_tnet_exact_device
numpy float32 arrays, uploaded inside each timed call; chip_smoke.py's
main_* phases hand it CUDA tensors.  At the benchmark's two rows (64 x
256^2 seed 0, 9 calls; 16 x 784^2 seed 1, 5 calls) this times both in turns
A B B A A B B A after one warm-up turn each, each turn the median of its
synced calls plus the host certification of its last call, so that a
difference between the two protocols shows apart from the host's drift
between processes.  Prints one JSON line: the card's nvidia-smi line and,
per row, each turn's protocol, median ms, certification ms and certified
instances/s.  Run it twice in one call to see the spread between
processes.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from smart_crossover_tpu_torch import bench  # noqa: E402
from smart_crossover_tpu_torch.network_methods.certify import (  # noqa: E402
    certify_ot_basis_batch,
)
from smart_crossover_tpu_torch.parallel.batched import (  # noqa: E402
    batched_tnet_exact_device,
)

ORDER = ("bench_numpy", "main_cuda", "main_cuda", "bench_numpy") * 2


def turn(inputs, exact, reps):
    """One turn: median ms of reps synced calls, then the certification of
    the last call's basis (ms); the record with its certified inst/s."""
    B = exact[2].shape[0]
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = batched_tnet_exact_device(
            *inputs, reg=bench.REG, sinkhorn_iters=bench.SINKHORN_ITERS,
            max_pivots=bench.MAX_PIVOTS, device="cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    certs = certify_ot_basis_batch(out[5].cpu().numpy(), *exact)
    cert = (time.perf_counter() - t0) * 1e3
    if not all(c.ok for c in certs):
        raise RuntimeError("an instance was not certified")
    ms = float(np.median(times))
    return {"ms": ms, "cert_ms": cert, "ips": B / (ms + cert) * 1e3}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 2
    res = {"nvidia_smi": bench.card(torch.device("cuda"))["nvidia_smi"]}
    for cell, (B, S, D, seed, reps, _) in bench.CELLS.items():
        exact = bench.make_batch(B, S, D, seed)
        host = [a.astype(np.float32) for a in exact]
        card = [torch.tensor(a, device="cuda") for a in host]
        inputs = {"bench_numpy": host, "main_cuda": card}
        for name in inputs:                       # warm-up
            turn(inputs[name], exact, reps)
        rows = []
        for name in ORDER:
            rows.append({"protocol": name,
                         **turn(inputs[name], exact, reps)})
        res[cell] = rows
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
