"""Sustained certified-exact OT serving on the card.

    python -m smart_crossover_tpu_torch bench --cell serve_16x128x128x16
        [--seed N] [--device cpu]

Port of ``scripts/bench_serving.py``, the JAX repo's production serving
shape: 16 dispatches, dispatch k taking ``bench.make_batch(16, 128, 128,
seed=N + k)`` (the script's generator: L1 costs on a pixel grid plus
U(0, 0.1) noise; 128 is not a square, so the grid is 8 x 16), each
through ``batched_tnet_exact_device`` on the port's default engine
'mega' (the Sinkhorn kernel K1 and the pivot-loop kernel K2 once per
dispatch; the script passes 'anc', its TPU's best engine), with the
benchmark's constants (reg 0.005, 1000 Sinkhorn iterations, at most
20,000 pivots).

Protocol: one warm-up dispatch that ends in a host fetch; then one wall
clock across all dispatches, each fetching its basis to host numpy (a
server consumes it there) under a per-dispatch clock; then the host
certifies every basis in f64 (``network_methods/certify.py``).  Headline:
``sustained_certified_exact_serving`` = B * K / (device wall + certify
wall), instances/s.  Correct when every instance is certified, optimal on
the device, and its device objective within ``bench.OBJ_RTOL`` of the
certified one.  Beside it: per-dispatch latency, launches per dispatch,
one staged pass (``bench.stage_split``) on the first batch with its
device idle share, peak device memory, and the CPU reference pipeline
(``bench.cpu_reference_pipeline``) on two instances as the baseline.
``--device cpu`` runs the plain versions at 4 x 16^2 x 3 dispatches: a
check of the command, not a measurement.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from smart_crossover_tpu_torch import bench

CELL = "serve_16x128x128x16"
ENGINE = "mega"
# (B, S, D, seed offset, dispatches, baseline instances)
SHAPE = (16, 128, 128, 0, 16, 2)
CPU_SHAPE = (4, 16, 16, 0, 3, 2)


def run_row(cell: str, B: int, S: int, D: int, seed: int, n_dispatch: int,
            n_base: int, dev: torch.device) -> dict:
    """The serving row: warm-up, the timed dispatches, host certification,
    the baseline and the staged pass.  Returns its record."""
    from smart_crossover_tpu_torch._build import (
        kernel_launch_counts,
        reset_kernel_launch_counts,
    )
    from smart_crossover_tpu_torch.network_methods.certify import (
        certify_ot_basis_batch,
    )
    from smart_crossover_tpu_torch.parallel.batched import (
        batched_tnet_exact_device,
    )

    batches = [bench.make_batch(B, S, D, seed + k)
               for k in range(n_dispatch)]

    def dispatch(s, d, M):
        return batched_tnet_exact_device(
            s.astype(np.float32), d.astype(np.float32),
            M.astype(np.float32), reg=bench.REG,
            sinkhorn_iters=bench.SINKHORN_ITERS,
            max_pivots=bench.MAX_PIVOTS, engine=ENGINE, device=dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = dispatch(*batches[0])
    float(out[1].sum())                         # warm-up ends in a fetch
    reset_kernel_launch_counts()
    bases, on_device, lat = [], [], []
    t0 = time.perf_counter()
    for s, d, M in batches:
        t1 = time.perf_counter()
        out = dispatch(s, d, M)
        bases.append(out[5].cpu().numpy())      # the server's host fetch
        lat.append(time.perf_counter() - t1)
        on_device.append(out[1:5])              # read after the clock
    device_wall = time.perf_counter() - t0
    launches = kernel_launch_counts()

    # host certification of every basis, counted in the headline
    t0 = time.perf_counter()
    certs = [certify_ot_basis_batch(Bm, s, d, M)
             for (s, d, M), Bm in zip(batches, bases)]
    certify_wall = time.perf_counter() - t0
    certs = [c for batch in certs for c in batch]
    obj, push, piv, opt = (torch.cat(t).cpu() for t in zip(*on_device))
    cobj = np.array([c.obj_val for c in certs])
    obj_rel = float(np.max(np.abs(obj.double().numpy() - cobj)
                           / np.abs(cobj)))
    total = B * n_dispatch
    n_cert = sum(c.ok for c in certs)
    ips = total / (device_wall + certify_wall)

    s64, d64, M64 = batches[0]
    t0 = time.perf_counter()
    for i in range(n_base):
        bench.cpu_reference_pipeline(s64[i], d64[i], M64[i], reg=bench.REG,
                                     sinkhorn_iters=bench.SINKHORN_ITERS)
    cpu_dt = (time.perf_counter() - t0) / n_base

    s, d, M = (a.astype(np.float32) for a in batches[0])
    stage_ms, _, _ = bench.stage_split(s, d, M, device=dev)
    lat_ms = [t * 1e3 for t in lat]
    row = {
        "cell": cell, "seed": seed, "batch": B, "S": S, "D": D,
        "n_dispatch": n_dispatch, "total_instances": total,
        "engine": ENGINE, "sinkhorn_iters": bench.SINKHORN_ITERS,
        "max_pivots_allowed": bench.MAX_PIVOTS,
        "sustained_certified_instances_per_sec": ips,
        "device_wall_s": device_wall,
        "device_rate_inst_per_s": total / device_wall,
        "dispatch_ms": lat_ms,
        "dispatch_ms_median": float(np.median(lat_ms)),
        "dispatch_ms_max": float(max(lat_ms)),
        "certify_wall_s": certify_wall,
        "cpu_reference_instances_per_sec": 1.0 / cpu_dt,
        "cpu_reference_instances": n_base,
        "vs_cpu_reference": ips * cpu_dt,
        "all_optimal_device": bool(opt.all()),
        "all_certified": bool(n_cert == total),
        "n_certified": int(n_cert),
        "max_feas_err": float(max(c.max_feas_err for c in certs)),
        "min_reduced_cost": float(min(c.min_rcost for c in certs)),
        "device_obj_max_rel_to_certified": obj_rel,
        "certified_obj": cobj.tolist(),
        "median_pivots": float(np.median(piv.numpy())),
        "max_pivots": int(piv.max()),
        "median_push_iters": float(np.median(push.numpy())),
        "max_push_iters": int(push.max()),
        "launches": launches,
        "launches_per_dispatch": {k: v / n_dispatch
                                  for k, v in launches.items()},
        "stage_ms": stage_ms,
    }
    row["correct"] = (row["all_certified"] and row["all_optimal_device"]
                      and obj_rel <= bench.OBJ_RTOL)
    if dev.type == "cuda":
        row["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated(
            dev)
        row["staged_pass_profile"] = bench.staged_pass_profile(
            s, d, M, stage_ms, dev)
    return row


def records(row: dict) -> list:
    """The lines printed before the result."""
    return [{"serving": row["cell"], "dispatch_ms": row["dispatch_ms"],
             "launches_per_dispatch": row["launches_per_dispatch"]},
            {"staged_pass": row["cell"], "stage_ms": row["stage_ms"],
             "median_pivots": row["median_pivots"],
             "median_push_iters": row["median_push_iters"]}]


def result(row: dict, detail: dict) -> dict:
    return {"metric": "sustained_certified_exact_serving",
            "value": row["sustained_certified_instances_per_sec"],
            "unit": "instances/s",
            "vs_baseline": row["vs_cpu_reference"],
            "detail": {**detail, **row}}
