"""Benchmark: certified-exact batched OT crossover throughput on the card.

    python -m smart_crossover_tpu_torch bench [--device cpu] [--seed N]
        [--cell ot_64x256x256|ot_16x784x784|goto17_cnet_mcf|
                goto17_irregular_cnet_mcf|serve_16x128x128x16|
                ipm_stair_10000x36975 [--oracle]]

Port of the root ``bench.py``.  Each row runs the exact pipeline,
``batched_tnet_exact_device`` on its default 'mega' engine (the Sinkhorn
kernel K1, rounding, flow indicators, Borůvka, tree solve, push, Borůvka
over the support, then the pivot-loop kernel K2, one launch each per
call), over a batch of MNIST-style OT instances, then certifies every
basis on the host: exact f64 flows and duals recomputed from the basis
alone under the reference's test (feasibility <= 1e-8, reduced costs
>= -1e-6).  Certification counts in the headline: certified instances/s
= B / (median synced call + host certification).

Rows (closed loop: one batch per call, a warm-up that ends in a host
fetch, then timed calls each ending in a device sync):

* ``ot_64x256x256``: ``make_batch(64, 256, 256, seed)``, 9 timed calls,
  the CPU reference baseline on 2 instances;
* ``ot_16x784x784``: ``make_batch(16, 784, 784, seed + 1)``, the
  reference's 28 x 28 MNIST scale, 5 timed calls, 1 baseline instance;
  skipped under ``SCX_BENCH_SKIP_784=1``.

After its timed calls each row runs one staged pass (``stage_split``):
the same stages called one by one, each synced and inside a
``torch.profiler.record_function`` range named after it, for the
per-stage milliseconds; on the card a second staged pass under
``torch.profiler`` gives the device's busy time and idle share.  The
end-to-end numbers come from the timed calls only.

The baseline is the reference's crossover stage done the reference's way
on the host (scipy MST, spsolve, a sequential push; reference tree_BI.py),
one instance at a time.  It stops at a feasible vertex, so vs_baseline
understates the speed-up of the certified-exact pipeline.

Prints, last, one JSON line {"metric", "value", "unit", "vs_baseline",
"detail"}, the second row under ``detail["mnist_784"]``.  Exits 1 when a
row is not correct (an instance not certified or not optimal on the
device, or a device objective more than 1e-4 from its certified one), and
2 without printing a result when there is no card and no ``--device
cpu``.  ``--device cpu`` runs the kernels' plain versions at the reduced
shape 8 x 64^2 with no 784^2 row, tagged ``"backend": "cpu"``: a check
of the command, not a measurement.

Four more rows run only when named by ``--cell``, each printing its own
records and then its own result line, with the same exit codes:
``goto17_cnet_mcf`` and ``goto17_irregular_cnet_mcf``
(``bench_goto17.py``, ``scripts/run_goto17.py``'s flagship network
crossover for seed 42 + N, on its degree-regular and its irregular
class), ``serve_16x128x128x16`` (``bench_serving.py``,
``scripts/bench_serving.py``'s sustained serving shape, dispatch k on
seed N + k) and ``ipm_stair_10000x36975`` (``bench_ipm_stair.py``,
``scripts/bench_ipm_sparse_big.py``'s sparse staircase LP through
``ipm_big``; ``--oracle`` adds the script's HiGHS solve).
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REG, SINKHORN_ITERS, MAX_PIVOTS = 0.005, 1000, 20000
OBJ_RTOL = 1e-4       # device objective (float32 flows) vs certified (f64)

# name: (B, S, D, seed offset, timed calls, baseline instances)
CELLS = {"ot_64x256x256": (64, 256, 256, 0, 9, 2),
         "ot_16x784x784": (16, 784, 784, 1, 5, 1)}
CPU_ROW = (8, 64, 64, 0, 9, 2)
# rows run only when named, each by its own module (``SHAPE``, ``CPU_SHAPE``
# in the same order, ``run_row``, ``records``, ``result``; ``OPTIONS``: the
# command-line options its ``run_row`` takes as keywords)
OTHER_ROWS = {"goto17_cnet_mcf": "bench_goto17",
              "goto17_irregular_cnet_mcf": "bench_goto17",
              "serve_16x128x128x16": "bench_serving",
              "ipm_stair_10000x36975": "bench_ipm_stair"}

# the staged pass, in the pipeline's order
STAGES = ("upload", "sinkhorn_kernel", "round_indicators", "boruvka_flow",
          "tree_solve", "push", "boruvka_support", "simplex_setup",
          "simplex_kernel", "rebuild")


def make_batch(B, S, D, seed=0):
    """Generate in f64 (mass balance exact at certification precision);
    the device consumes an f32 cast, the certifier/baseline the f64.

    The grid of N points is side x N / side, side the largest divisor of
    N at most sqrt(N): ``scripts/bench_serving.py``'s generator.  The root
    ``bench.py``'s takes side = int(sqrt(N)) and runs only where that
    divides N, and there the two batches are the same."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(axis=1) / d.sum(axis=1))[:, None]

    # MNIST-like ground cost: L1 distances on a pixel grid
    def grid(N):
        side = int(np.sqrt(N))
        while N % side:
            side -= 1
        return np.stack(np.unravel_index(np.arange(N), (side, N // side)),
                        -1)

    xs, xd = grid(S), grid(D)
    M0 = np.abs(xs[:, None, :] - xd[None, :, :]).sum(-1).astype(np.float64)
    M = M0[None, :, :] + rng.uniform(0, 0.1, (B, S, D))
    return s, d, M


def cpu_reference_pipeline(s, d, M, reg=0.05, sinkhorn_iters=200):
    """Reference-style host implementation (scipy MST + spsolve + python
    push loop), one instance at a time."""
    import scipy.sparse as sp

    S, D = M.shape
    eps = reg * M.max()
    # numpy log-domain sinkhorn
    f = np.zeros(S)
    g = np.zeros(D)
    logs, logd = np.log(s), np.log(d)
    for _ in range(sinkhorn_iters):
        t = (g[None, :] - M) / eps
        f = eps * (logs - (t.max(1) + np.log(
            np.exp(t - t.max(1)[:, None]).sum(1))))
        t2 = (f[:, None] - M) / eps
        g = eps * (logd - (t2.max(0) + np.log(
            np.exp(t2 - t2.max(0)[None, :]).sum(0))))
    X = np.exp((f[:, None] + g[None, :] - M) / eps)
    W = np.maximum(X / s[:, None], X / d[None, :])
    # scipy MST (reference tree_BI.py:32-59 structure)
    V = S + D
    row = np.repeat(np.arange(S), D)
    col = S + np.tile(np.arange(D), S)
    gmat = sp.coo_matrix((-W.ravel() - 1e-9, (row, col)), shape=(V, V))
    tree = sp.csgraph.minimum_spanning_tree(gmat)
    ti, tj = tree.nonzero()
    mask = np.zeros((S, D), dtype=bool)
    mask[ti, tj - S] = True
    # tree solve via spsolve on the (V-1)x(V-1) basis (reference :74-76)
    cols = np.flatnonzero(mask.ravel())
    rows_A = np.concatenate([cols // D, S + cols % D])
    cols_A = np.concatenate([np.arange(cols.size), np.arange(cols.size)])
    data_A = np.concatenate([-np.ones(cols.size), np.ones(cols.size)])
    A = sp.csc_matrix((data_A, (rows_A, cols_A)), shape=(V, cols.size))
    bb = np.concatenate([-s, d])
    sol = sp.linalg.spsolve(A[:-1, :], bb[:-1])
    Xt = np.zeros(S * D)
    Xt[cols] = sol
    Xt = Xt.reshape(S, D)
    # sequential push (reference :85-110)
    it = 0
    while Xt.min() < 0 and it < 100000:
        I1, J1 = np.unravel_index(np.argmin(Xt), Xt.shape)
        J2 = np.argmax(Xt[I1, :])
        I2 = np.argmax(Xt[:, J1])
        theta = min(-Xt[I1, J1], Xt[I1, J2], Xt[I2, J1])
        Xt[I1, J1] += theta
        Xt[I2, J1] -= theta
        Xt[I1, J2] -= theta
        Xt[I2, J2] += theta
        it += 1
    return Xt


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def synced(fn, dev: torch.device):
    """(fn(), its seconds between two device syncs)."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def stage_split(s, d, M, reg: float = REG,
                sinkhorn_iters: int = SINKHORN_ITERS,
                max_pivots: int = MAX_PIVOTS, *, device=None):
    """One run of ``batched_tnet_exact_device``'s stages ('mega' engine)
    called one by one, each synced and inside a ``record_function`` range
    named after it (``STAGES``).  s, d, M as that function takes them.
    Returns (ms per stage, push iterations (B,), pivots (B,))."""
    from smart_crossover_tpu_torch.config import resolve_device, to_device
    from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
    from smart_crossover_tpu_torch.ops.ranking import ot_flow_indicators
    from smart_crossover_tpu_torch.ops.sinkhorn_fused import (
        sinkhorn_plan_fused,
    )
    from smart_crossover_tpu_torch.ops.transport_simplex_mega import (
        mega_setup,
        rebuild_plan,
        transport_simplex_mega_state,
    )
    from smart_crossover_tpu_torch.ops.tree import (
        bipartite_tree_solve,
        push_to_bfs,
    )
    from smart_crossover_tpu_torch.solvers.sinkhorn import round_to_feasible

    dev = resolve_device(device, M)
    ms = {}

    @contextlib.contextmanager
    def stage(name):
        _sync(dev)
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            _sync(dev)
        ms[name] = (time.perf_counter() - t0) * 1e3

    with stage("upload"):
        M = to_device(M, dev)
        s, d = to_device(s, dev, M.dtype), to_device(d, dev, M.dtype)
    with stage("sinkhorn_kernel"):
        Mn = (M / (reg * M.amax((1, 2)))[:, None, None]).contiguous()
        plan, _, _ = sinkhorn_plan_fused(s, d, Mn, 1.0, sinkhorn_iters)
    with stage("round_indicators"):
        W = ot_flow_indicators(round_to_feasible(plan, s, d), s, d)
    with stage("boruvka_flow"):
        tree = boruvka_bipartite_mst(W)
    with stage("tree_solve"):
        X = bipartite_tree_solve(tree, s, d)
    with stage("push"):
        X0, push = push_to_bfs(X)
    with stage("boruvka_support"):
        Bm0 = boruvka_bipartite_mst((X0 > 1e-12).to(M.dtype))
    with stage("simplex_setup"):
        st = mega_setup(X0, Bm0, M)
    with stage("simplex_kernel"):
        out = transport_simplex_mega_state(st, max_pivots=max_pivots)
    with stage("rebuild"):
        rebuild_plan(out[0], out[1], *M.shape[1:])
    return ms, push, out[5]


def layer_ms(stage_ms: dict, device_stage_ms: float, certify_ms: float):
    """The per-layer metrics of a row, from its staged pass and its timed
    calls."""
    return {"device_stage_ms": device_stage_ms, "certify_ms": certify_ms,
            "sinkhorn_kernel_ms": stage_ms["sinkhorn_kernel"],
            "simplex_kernel_ms": stage_ms["simplex_kernel"],
            "push_ms": stage_ms["push"],
            "tree_solve_ms": stage_ms["tree_solve"],
            "boruvka_ms": stage_ms["boruvka_flow"]
            + stage_ms["boruvka_support"],
            "simplex_setup_ms": stage_ms["simplex_setup"]}


def device_busy(fn, dev: torch.device) -> dict:
    """fn() once under ``torch.profiler`` on the card: the device's busy
    time (the union of its kernels' and copies' spans), the pass's wall
    time, the idle share and the eight kernels that took longest in all.
    No device activity recorded reads "not measured".  The profiler's raw
    (kineto) events are read, not ``prof.events()``, whose event tree
    takes minutes to build over the 10^5 launches of a long pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity, less the stage ranges' own device-side copies
    acts = [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and e.name() not in STAGES]
    busy_ns, end = 0, float("-inf")
    for lo, dur in sorted((lo, dur) for _, lo, dur in acts):
        if lo + dur > end:
            busy_ns += lo + dur - max(lo, end)
            end = lo + dur
    if busy_ns == 0:
        return {"device_busy_ms": "not measured"}
    by_name = {}
    for name, _, dur in acts:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + dur / 1e6, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"device_busy_ms": busy_ns / 1e6, "profiled_wall_ms": wall_ms,
            "device_idle_share": 1.0 - busy_ns / 1e6 / wall_ms,
            "device_events": len(acts),
            "top_device_ms": [{"name": n[:80], "ms": ms, "count": c}
                              for n, (ms, c) in top]}


def run_row(cell: str, B: int, S: int, D: int, seed: int, reps: int,
            n_base: int, dev: torch.device) -> dict:
    """One row: warm-up, timed calls, host certification, the CPU
    reference baseline and the staged pass.  Returns its record."""
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

    s64, d64, M64 = make_batch(B, S, D, seed=seed)
    s, d, M = (a.astype(np.float32) for a in (s64, d64, M64))

    def call():
        return batched_tnet_exact_device(s, d, M, reg=REG,
                                         sinkhorn_iters=SINKHORN_ITERS,
                                         max_pivots=MAX_PIVOTS, device=dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = call()
    float(out[1].sum())                         # warm-up ends in a fetch
    reset_kernel_launch_counts()
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        out = call()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    launches = kernel_launch_counts()
    dt = float(np.median(times))
    q25, q75 = np.percentile(times, 25), np.percentile(times, 75)
    X, obj, push, piv, opt, Bm = out

    # host certification: exact f64 vertex and duals from the basis alone;
    # part of delivering a certified vertex, so it counts in the headline
    t0 = time.perf_counter()
    with torch.profiler.record_function("certify"):
        certs = certify_ot_basis_batch(Bm.cpu().numpy(), s64, d64, M64)
    cert_dt = time.perf_counter() - t0
    n_cert = sum(c.ok for c in certs)
    cobj = np.array([c.obj_val for c in certs])
    obj_rel = float(np.max(np.abs(obj.double().cpu().numpy() - cobj)
                           / np.abs(cobj)))
    ips = B / (dt + cert_dt)

    t0 = time.perf_counter()
    for i in range(n_base):
        cpu_reference_pipeline(s64[i], d64[i], M64[i], reg=REG,
                               sinkhorn_iters=SINKHORN_ITERS)
    cpu_dt = (time.perf_counter() - t0) / n_base

    stage_ms, _, _ = stage_split(s, d, M, device=dev)
    pivots, pushes = piv.cpu().numpy(), push.cpu().numpy()
    all_opt = bool(opt.all())
    row = {
        "cell": cell, "seed": seed, "batch": B, "S": S, "D": D,
        "sinkhorn_iters": SINKHORN_ITERS, "max_pivots_allowed": MAX_PIVOTS,
        "reps": reps,
        "certified_instances_per_sec": ips,
        "device_stage_instances_per_sec": B / dt,
        "device_stage_iqr_instances_per_sec": [B / q75, B / q25],
        "device_stage_ms": dt * 1e3,
        "device_stage_ms_all": [t * 1e3 for t in times],
        "certify_host_s": cert_dt,
        "cpu_reference_instances_per_sec": 1.0 / cpu_dt,
        "cpu_reference_instances": n_base,
        "vs_cpu_reference": ips * cpu_dt,
        "all_optimal_device": all_opt,
        "all_certified": bool(n_cert == B),
        "n_certified": int(n_cert),
        "max_feas_err": float(max(c.max_feas_err for c in certs)),
        "min_reduced_cost": float(min(c.min_rcost for c in certs)),
        "device_obj_max_rel_to_certified": obj_rel,
        "median_pivots": float(np.median(pivots)),
        "max_pivots": int(pivots.max()),
        "median_push_iters": float(np.median(pushes)),
        "max_push_iters": int(pushes.max()),
        "launches": launches,
        "launches_per_call": {k: v / reps for k, v in launches.items()},
        "stage_ms": stage_ms,
        "layers": layer_ms(stage_ms, dt * 1e3, cert_dt * 1e3),
    }
    row["correct"] = (row["all_certified"] and all_opt
                      and obj_rel <= OBJ_RTOL)
    if dev.type == "cuda":
        row["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated(
            dev)
        row["staged_pass_profile"] = staged_pass_profile(s, d, M, stage_ms,
                                                         dev)
    return row


def staged_pass_profile(s, d, M, stage_ms: dict, dev: torch.device) -> dict:
    """A second staged pass under ``torch.profiler`` (``device_busy``);
    ``stage_ms`` is the unprofiled pass's split."""
    prof = device_busy(lambda: stage_split(s, d, M, device=dev), dev)
    if "profiled_wall_ms" in prof:
        # the profiler slows the host loops, not the device: the same
        # busy time over the unprofiled staged pass's wall time
        prof["device_idle_share_unprofiled"] = (
            1.0 - prof["device_busy_ms"] / sum(stage_ms.values()))
    return prof


def card(dev: torch.device) -> dict:
    """The device a run measured: the card's name and count, and
    nvidia-smi's name and power limit."""
    if dev.type != "cuda":
        return {"device_name": "cpu", "device_count": 1}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return {"device_name": torch.cuda.get_device_name(dev),
            "device_count": torch.cuda.device_count(),
            "nvidia_smi": smi[idx].strip(),
            "power_limit": smi[idx].rsplit(",", 1)[-1].strip()}


def add_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="cuda (default; without a card the command exits "
                        "2) or cpu: the plain versions at 8 x 64^2, a "
                        "check of the command, not a measurement")
    p.add_argument("--seed", type=int, default=0,
                   help="ot_64x256x256's seed; ot_16x784x784 takes seed + "
                        "1, the goto17 rows 42 + seed, serve_16x128x128x16 "
                        "seed + k for dispatch k, ipm_stair_10000x36975 "
                        "seed")
    p.add_argument("--cell", choices=sorted(CELLS) + sorted(OTHER_ROWS),
                   default=None,
                   help="run one row (default: both OT rows; the other "
                        "rows run only when named)")
    p.add_argument("--oracle", action="store_true",
                   help="ipm_stair_10000x36975: also solve with scipy HiGHS "
                        "(minutes at full size)")


def _on_cpu(args) -> bool:
    return args.device is not None and torch.device(args.device).type == "cpu"


def _row_module(cell: str):
    return importlib.import_module(
        f"smart_crossover_tpu_torch.{OTHER_ROWS[cell]}")


def rows_to_run(args) -> list:
    """(cell, B, S, D, seed, reps, baseline instances) of each row; for
    the goto17 rows (cell, 1, width, height, seed, warm iterations, 1),
    for serve_16x128x128x16 (cell, B, S, D, first seed, dispatches,
    baseline instances), for ipm_stair_10000x36975 (cell, periods, rows
    and columns per period, seed, solves, baseline runs)."""
    if args.cell in OTHER_ROWS:
        mod = _row_module(args.cell)
        B, S, D, offset, reps, n_base = (mod.CPU_SHAPE if _on_cpu(args)
                                         else mod.SHAPE)
        return [(args.cell, B, S, D, args.seed + offset, reps, n_base)]
    if _on_cpu(args):
        if args.cell == "ot_16x784x784":
            raise SystemExit("bench: --device cpu runs one reduced row "
                             "(8 x 64^2); ot_16x784x784 runs on the card")
        names = ["ot_64x256x256"]
        table = {"ot_64x256x256": CPU_ROW}
    else:
        names = [args.cell] if args.cell else list(CELLS)
        if args.cell is None and os.environ.get("SCX_BENCH_SKIP_784") == "1":
            names = names[:1]
        table = CELLS
    out = []
    for name in names:
        B, S, D, offset, reps, n_base = table[name]
        out.append((name, B, S, D, args.seed + offset, reps, n_base))
    return out


def run(args) -> int:
    """Run the rows and print the result line; the exit code."""
    if args.device is None and not torch.cuda.is_available():
        print("bench: torch sees no CUDA device; the benchmark runs on the "
              "card (--device cpu checks the command on the CPU)",
              file=sys.stderr)
        return 2
    dev = torch.device(args.device or "cuda")
    setup = {}
    if dev.type == "cuda":      # set-up: nvcc at first use, then the load
        from smart_crossover_tpu_torch import _build

        t0 = time.perf_counter()
        _build.library()
        setup = {"kernel_library_s": time.perf_counter() - t0,
                 "kernels_compiled_now": _build.build_seconds is not None}
    if args.cell in OTHER_ROWS:
        return run_other(args, dev, setup)
    rows = [run_row(*r, dev=dev) for r in rows_to_run(args)]
    for r in rows:          # the per-stage records, before the result
        print(json.dumps({"staged_pass": r["cell"], "stage_ms": r["stage_ms"],
                          "median_pivots": r["median_pivots"],
                          "median_push_iters": r["median_push_iters"],
                          "launches_per_call": r["launches_per_call"]}),
              flush=True)
    head = rows[0]
    detail = {"backend": dev.type, **card(dev), **setup, **head}
    if len(rows) > 1:
        detail["mnist_784"] = rows[1]
    if dev.type == "cpu":
        detail["fallback"] = False
        detail["note"] = ("CPU run at reduced shape - NOT comparable to the "
                          "card's headline")
    print(json.dumps({
        "metric": "certified_exact_ot_crossover_throughput",
        "value": head["certified_instances_per_sec"],
        "unit": "instances/s/chip",
        "vs_baseline": head["vs_cpu_reference"],
        "detail": detail,
    }), flush=True)
    return 0 if all(r["correct"] for r in rows) else 1


def run_other(args, dev: torch.device, setup: dict) -> int:
    """A row of ``OTHER_ROWS``: its records, then its result line; the
    exit code."""
    (row_args,) = rows_to_run(args)
    mod = _row_module(args.cell)
    opts = {k: getattr(args, k) for k in getattr(mod, "OPTIONS", ())}
    row = mod.run_row(*row_args, dev=dev, **opts)
    for rec in mod.records(row):
        print(json.dumps(rec), flush=True)
    detail = {"backend": dev.type, **card(dev), **setup}
    if dev.type == "cpu":
        detail["fallback"] = False
        detail["note"] = ("CPU run at reduced shape - NOT comparable to the "
                          "card's headline")
    print(json.dumps(mod.result(row, detail)), flush=True)
    return 0 if row["correct"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="smart_crossover_tpu_torch bench")
    add_arguments(ap)
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
