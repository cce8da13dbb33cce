"""The benchmark's cells cut to sizes a CPU test can hold: 8 x 8 pixel
grids (S = D = 64) in batches of 4, every request's outputs kept whole;
MNIST-style pairs on 10 x 10 images; and an 18 x 18 torus (whose
supplies, unlike a 16 x 16 one's, are no binary fractions, so that a
float32 control is off)."""
from __future__ import annotations

import time

import torch

from benchmark.harness import cli, spec

SEED = 2**31 + 12345


def small_cell(name: str) -> spec.Cell:
    cell = spec.load_cell(name)
    if cell.traffic["kind"] == "ot_batch_exact":
        cell.config.update(side=8)
        cell.traffic.update(batch=4, pool_batches=2, warm_requests=1,
                            trace_requests=2, sample_every=1)
    elif cell.traffic["kind"] == "ot_single_tnet":
        cell.config.update(side=10, blobs=2)
        cell.traffic.update(pool=4, warm_requests=1, trace_requests=2)
    else:
        cell.config.update(width=18, height=18, warm_iters=2000)
        cell.traffic.update(pool=2, warm_cnet_grid=8, warm_pdhg_iters=250)
    return cell


def run_small(name: str, seconds: float = 1.0, trace: bool = False,
              control: bool = False, seed: int = SEED) -> tuple:
    """(cell, run_cell's result) of one run on the CPU."""
    cell = small_cell(name)
    return cell, cli.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                              time.perf_counter(), 0.0, control=control)
