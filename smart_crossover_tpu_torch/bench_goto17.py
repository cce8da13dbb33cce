"""The GOTO-17 flagship network crossover on the card.

    python -m smart_crossover_tpu_torch bench --cell goto17_cnet_mcf
        [--seed N] [--device cpu]
    python -m smart_crossover_tpu_torch bench --cell
        goto17_irregular_cnet_mcf [--seed N] [--device cpu]

Port of ``scripts/run_goto17.py`` for one seed: the paper's flagship
network scale (the reference runs ``goto_17_8*``),
``goto_like_mcf(362, 362, extra_arc_factor=4, seed=42 + N, regular=)``,
131,044 nodes: ``goto17_cnet_mcf`` runs the degree-regular class
(``regular=True``, the script's default; 786,264 arcs),
``goto17_irregular_cnet_mcf`` the irregular one (the script's
``regular=0``; the arc count varies by seed).  The instance is written
to a DIMACS ``.min`` file in a temporary directory (deleted afterwards)
and read back; every solver sees the instance read back.  Then, as the
script does:

1. set-up: the native network simplex's first build (g++), not timed
   below;
2. the cold native network simplex, ``solve_mcf(method="network_simplex")``
   (the baseline);
3. the first-order warm start, ``pdhg_mcf_device`` (Halpern, tol 1e-4,
   5000 iterations, float32) on the card, once, then again synced (the
   steady time), then once more under ``torch.profiler`` for the device's
   busy time and idle share;
4. CNET_MCF, ``network_crossover(method="cnet_mcf")``, from the warm x
   (the ranking on the card in float32, column generation and the native
   network simplex on the host in f64).

Headline: ``seconds_to_exact_vertex_goto17`` (``..._goto17_irregular`` on
the irregular class) = steady warm start + crossover (the script's
``geo_e2e_steady_s`` for one seed); vs_baseline =
cold core / headline.  Correct when the cold core and CNET_MCF are both
OPTIMAL, their objectives agree to 1e-8 (1 + |cold|), the warm start is
finite, and no dense PDHG kernel (K3, K4, K5) was launched.  ``--device
cpu`` runs width 16 with 500 warm iterations on the CPU: a check of the
command, not a measurement.
"""
from __future__ import annotations

import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from smart_crossover_tpu_torch import bench

CELL = "goto17_cnet_mcf"
IRREGULAR = "goto17_irregular_cnet_mcf"
SEED_BASE = 42                  # the script's seeds are 42, 43, 44
EXTRA_ARC_FACTOR = 4
WARM_TOL = 1e-4
OBJ_RTOL = 1e-8                 # |cnet - cold| <= OBJ_RTOL * (1 + |cold|)
DENSE_PDHG = ("pdhg_chunk", "halpern_chunk", "pdhg_batched")
# (instances, width, height, seed offset, warm iterations, baseline runs)
SHAPE = (1, 362, 362, SEED_BASE, 5000, 1)
CPU_SHAPE = (1, 16, 16, SEED_BASE, 500, 1)


def mcf_kkt(mcf, x, y):
    """(primal, dual, gap) relative KKT residuals of an MCF pair, host
    f64, as pdhg_solve measures them (l = 0, u = the capacities)."""
    import scipy.sparse as ssp

    from smart_crossover_tpu_torch.solvers.pdhg import _host_kkt

    return _host_kkt(ssp.csr_matrix(mcf.A), np.asarray(mcf.b, float),
                     np.asarray(mcf.c, float), np.zeros(mcf.n),
                     np.asarray(mcf.u, float), np.ones(mcf.m, bool), x, y)


def run_row(cell: str, B: int, width: int, height: int, seed: int,
            warm_iters: int, n_base: int, dev: torch.device) -> dict:
    """One seed of the GOTO-17 protocol, on the irregular class for
    ``IRREGULAR`` and the degree-regular one otherwise; returns its
    record."""
    from smart_crossover_tpu_torch import native
    from smart_crossover_tpu_torch._build import (
        kernel_launch_counts,
        reset_kernel_launch_counts,
    )
    from smart_crossover_tpu_torch.data.dimacs import read_dimacs_min
    from smart_crossover_tpu_torch.data.dimacs_write import write_dimacs_min
    from smart_crossover_tpu_torch.data.mcf_gen import goto_like_mcf
    from smart_crossover_tpu_torch.network_methods.algorithms import (
        network_crossover,
    )
    from smart_crossover_tpu_torch.solvers.pdhg_mcf import pdhg_mcf_device
    from smart_crossover_tpu_torch.solvers.solving import solve_mcf

    regular = cell != IRREGULAR
    t0 = time.perf_counter()
    gen = goto_like_mcf(width, height, extra_arc_factor=EXTRA_ARC_FACTOR,
                        seed=seed, regular=regular)
    generate_s = time.perf_counter() - t0
    # the DIMACS round trip: every solver sees the instance read back
    with tempfile.TemporaryDirectory(prefix="goto17_min_") as tmp:
        t0 = time.perf_counter()
        path = Path(tmp) / f"{gen.name}.min"
        write_dimacs_min(gen, path)
        mcf = read_dimacs_min(path)
        io_s = time.perf_counter() - t0
        min_bytes = path.stat().st_size
    del gen

    # set-up: the native core's first build, outside every timed step
    compiled_now = not native.library_path().exists()
    t0 = time.perf_counter()
    native.library()
    native_build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    cold = solve_mcf(mcf, method="network_simplex")
    cold_s = time.perf_counter() - t0

    def warm():
        return pdhg_mcf_device(mcf, tol=WARM_TOL, max_iters=warm_iters,
                               mode="halpern", dtype=torch.float32,
                               device=dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_kernel_launch_counts()
    (wx, wy, w_iters, w_conv, _), warm_s = bench.synced(warm, dev)
    _, warm_steady_s = bench.synced(warm, dev)
    stats = {}
    t0 = time.perf_counter()
    out = network_crossover(x=np.asarray(wx, np.float64), mcf=mcf,
                            method="cnet_mcf", device=dev, stats=stats)
    crossover_s = time.perf_counter() - t0
    launches = kernel_launch_counts()

    headline = warm_steady_s + crossover_s
    obj_gap = abs(out.obj_val - cold.obj_val)
    finite = bool(np.isfinite(wx).all() and np.isfinite(wy).all())
    dense = {k: launches[k] for k in DENSE_PDHG}
    row = {
        "cell": cell, "seed": seed, "width": width, "height": height,
        "nodes": mcf.m, "arcs": mcf.n, "regular": regular,
        "dimacs_roundtrip": True, "min_file_bytes": min_bytes,
        "generate_s": generate_s, "io_s": io_s,
        "native_build_s": native_build_s,
        "native_compiled_now": compiled_now,
        "cold_status": cold.status, "cold_obj": cold.obj_val,
        "cold_s": cold_s, "cold_pivots": int(cold.iter_count),
        "warm_iters_allowed": warm_iters, "warm_tol": WARM_TOL,
        "warm_dtype": "float32", "warm_s": warm_s,
        "warm_steady_s": warm_steady_s, "warm_iters": w_iters,
        "warm_converged": w_conv,
        "warm_ms_per_iteration": warm_steady_s * 1e3 / max(w_iters, 1),
        "warm_finite": finite,
        "warm_kkt_rel": list(mcf_kkt(mcf, wx, wy)),
        "crossover_status": out.status, "crossover_obj": out.obj_val,
        "crossover_s": crossover_s,
        "crossover_pivots": int(out.iter_count),
        "crossover": stats, "ranking_device": dev.type,
        "obj_abs_gap": obj_gap,
        "obj_match": bool(obj_gap <= OBJ_RTOL * (1 + abs(cold.obj_val))),
        "seconds_to_exact_vertex": headline,
        "e2e_incl_first_warm_s": warm_s + crossover_s,
        "vs_cold": cold_s / headline,
        "launches": launches,
    }
    row["correct"] = (cold.status == "OPTIMAL" and out.status == "OPTIMAL"
                      and row["obj_match"] and finite
                      and not any(dense.values()))
    if dev.type == "cuda":
        row["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated(
            dev)
        t0 = time.perf_counter()
        prof = bench.device_busy(warm, dev)
        prof["seconds"] = time.perf_counter() - t0
        if "profiled_wall_ms" in prof:
            # the profiler slows the host's launches: the same busy time
            # over the unprofiled steady run's wall time
            prof["device_idle_share_unprofiled"] = (
                1.0 - prof["device_busy_ms"] / (warm_steady_s * 1e3))
        row["warm_steady_profile"] = prof
    return row


def records(row: dict) -> list:
    """The script's lines, one per step, printed before the result."""
    keys = {"instance": ("nodes", "arcs", "generate_s", "io_s",
                         "native_build_s"),
            "cold": ("cold_status", "cold_obj", "cold_pivots", "cold_s"),
            "warm": ("warm_s", "warm_steady_s", "warm_iters",
                     "warm_converged", "warm_ms_per_iteration",
                     "warm_kkt_rel"),
            "crossover": ("crossover_status", "crossover_obj",
                          "crossover_pivots", "crossover_s", "crossover",
                          "obj_match")}
    return [{"goto17": step, "seed": row["seed"],
             **{k: row[k] for k in ks}} for step, ks in keys.items()]


def result(row: dict, detail: dict) -> dict:
    irregular = "" if row["regular"] else "_irregular"
    return {"metric": f"seconds_to_exact_vertex_goto17{irregular}",
            "value": row["seconds_to_exact_vertex"], "unit": "s",
            "vs_baseline": row["vs_cold"], "detail": {**detail, **row}}
