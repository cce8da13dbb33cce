#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each, any failure fatal (non-zero exit):
  env     the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
  build   the port's CUDA kernels, compiled from csrc/ with nvcc;
  k1      the Sinkhorn kernel against its plain PyTorch version on the
          card at 64 x 256^2 (seed 0), 16 x 784^2 (seed 1) and the serving
          row's 16 x 128^2 (its first dispatch's batch), with the
          median time of each, ms per iteration and the cluster plan
          (cluster size, resident clusters, waves, rows of M in shared
          memory, shared memory per block);
  k2      the pivot-loop kernel against its plain version at the OT
          shapes: 64 x 256^2 (seed 0, all 64 instances), 16 x 784^2
          (seed 1; the kernel on all 16, median of 3 synced runs; the plain
          version on the first 4) and the serving row's 16 x 128^2 (all
          16), with the cluster plan (cluster size,
          resident clusters, shared memory per block, whether N lives in
          shared memory), per-instance pivots and ms per pivot;
  main    the certified-exact OT crossover, batched_tnet_exact_device, at
          64 x 256^2 and at 16 x 784^2 (the benchmark's shapes and seeds,
          smart_crossover_tpu_torch/bench.py): every instance certified by
          the f64 certifier on the card (the route's masks where they lie,
          one certify launch and no other kernel, counter certify.device =
          the batch), both kernels launched, certified instances/s; the
          push kernel launched once a call, the tree walk kernel twice
          (the tree solve and K2 set-up's parent vector);
  push    the push kernel against its plain version, the host-driven
          loop, on the inputs the main path gives it: the push of a
          batched_tnet_exact_device call on 16 DOTmark-like 32 x 32
          white-noise pairs (16 x 1024^2) and of sinkhorn then TNET on four
          MNIST-like pairs (B = 1, 73-168 pixels an image): X and the
          steps equal bit for bit, one launch a call, the median ms of
          each;
  certify the float64 certificate kernel on the route's optimal bases of
          16 DOTmark-like pairs (16 x 1024^2) and 16 digit pairs on the
          784-pixel grid (16 x 784^2), costs in float32 as the benchmark
          hands them: the whole call's, the kernel's (CUDA events) and the
          upload's ms (pinned staging against a pageable copy), the bound
          (mask and cost bytes at the HBM rate), the SciPy path's ms, one
          launch a call and the same certificates as the SciPy path
          (verdicts, reasons, objectives, vertices, feasibility errors,
          smallest flows and reduced costs, at the CPU tests' tolerances),
          also under costs lowered off the trees, where some verdicts must
          fail; max_abs_err is the largest gap between the two; then the
          tree walk kernel on the same bases with the route's float32
          masses against the plain loops on the card: parent vectors
          equal, flows within the card test's float32 limit, one launch a
          call, the kernel's ms alone (CUDA events around the launch), the
          whole call's, the plain loops' and the bound (the mask's bytes
          at the HBM rate);
  bench   `python -m smart_crossover_tpu_torch bench` in a subprocess at
          full size (both rows): rc 0, every instance certified and
          optimal on the card, K1, K2 and the push kernel launched once
          per timed call, the same card; its certified instances/s beside
          main's; then, each in
          its own subprocess, `bench --cell serve_16x128x128x16` (rc 0,
          256/256 certified and optimal on the card, K1 and K2 once per
          dispatch), `bench --cell goto17_cnet_mcf` and `--cell
          goto17_irregular_cnet_mcf` (rc 0, the degree-regular and the
          irregular GOTO-17 class, CNET_MCF from the card's PDHG warm
          start equal to the cold native core to 1e-8 (1 + |obj|), no
          dense PDHG kernel) and `bench --cell ipm_stair_10000x36975`
          (rc 0, the sparse staircase LP through ipm_big: both solves
          OPTIMAL with the float32 device stage on the card and the
          device endgame engaged, the host f64 certificate on the true
          bounds within 1e-8, the host sparse barrier's objective to
          1e-7), each on this card;
  network_crossover_784x784
          the paper's front door on instance 0 of the 16 x 784^2 batch:
          sinkhorn(ot) through K1 (one launch, B = 1, against its plain
          version on the card), then network_crossover with TNET and
          CNET_OT, each OPTIMAL and equal to main_16x784x784's certified
          objective to 1e-9; TNET's basis certified, its push one
          launch of the push kernel and its tree solve one of the tree
          walk kernel;
  network_crossover_goto128
          CNET_MCF on a degree-regular GOTO-like MCF (128^2 nodes, 98,304
          arcs) from HiGHS's optimum plus noise, equal to HiGHS to 1e-9,
          against a cold native network simplex; then the first-order
          routes on the card: solve_mcf(method="first_order") with
          crossover on, and CNET_MCF from a pdhg_mcf_device warm start,
          each equal to HiGHS to 1e-9, with no dense PDHG kernel launched
          and no dense chunk's plain version called; ms per Halpern
          iteration with the incidence operator (index_add_) and with CSR;
  pdhg_mcf_goto17
          pdhg_mcf_device at scripts/run_goto17.py's scale (362^2 nodes,
          786,264 arcs): the first 250 Halpern iterations here, the full
          5000-iteration warm start taken from the goto17_cnet_mcf row of
          the bench phase (a cut of depth: this phase ran its own 5000
          iterations at tol 0 before that row existed); ms per
          iteration, the relative KKT residuals at the start, after 250 and
          at the row's end (finite; the primal one below its start, the sum
          below the 250-iteration one), both operators' ms per iteration;
  tnet_exact_64x256x256
          batched_tnet_exact on main_64x256x256's batch: the host route,
          'auto' (which must take the mega route) and the mega route
          capped at 100 pivots (which must repair some instance), 64/64
          optimal each, equal to the certified objectives to 1e-9;
  device_engines
          batched_tnet_exact with the tensor pivot engines: 'parent' and
          'anc' at 64 x 256^2 (seed 0), 'packed' at 16 x 784^2 (seed 1),
          all certified, equal to the main phases' certified objectives to
          1e-9, K1 launched once and K2 never; each engine's pivot stage
          against K2's on the same warm start; the 'mask' oracle at 64 x
          256^2, and where that takes more than 60 s again at a multiple
          of 8 instances that fits (the cut is printed);
  k3, k4  the PDHG and Halpern chunk kernels against their plain versions
          at 512 x 2048, one 64-iteration chunk, with the median ms of each,
          ms per iteration and the cluster plan (cluster size, resident
          clusters, waves, rows of A in shared memory, shared memory per
          block, combine);
  k5      the batched PDHG kernel against its plain version at 32 x 64 x
          256 (2000 iterations) and 64 x 256 x 512 (4000 iterations), each
          also at 50 iterations for a tight check, median ms, ms per
          iteration and the cluster plan;
  main_lp_single_512x2048
          pdhg_solve in both modes on the card, then the host primal simplex
          from the warm start to an exact vertex, equal to HiGHS to 1e-8;
  main_lp_fleet_32x64x256, main_lp_fleet_64x256x512
          batched_lp_crossover(warm_engine="pdhg"): every instance optimal
          and equal to HiGHS to 1e-8 (at 64 x 256 x 512 the first 8
          instances are crossed over, a cut of depth for time: the host
          crossover of all 64 took 188-344 s of the script's 1200 s, of 32
          94 s; K5 is timed on all 64);
  lp_front_door_512x2048
          the LP front door: solve_lp(method="first_order") on the single
          LP as a GeneralLP, tol 1e-4, adaptive: OPTIMAL, K3 launched,
          within 1e-3 of HiGHS (the Halpern route through the facade is
          held by the CPU tests);
  perturb_800x3200
          the perturbation crossover, solve_lp(method="barrier_perturb"), on
          random_sparse_lp(800, 3200, seed 0): OPTIMAL and equal to HiGHS
          to 1e-8, with the barrier's iterations and seconds, the fixed
          variables and constraints of each attempt, how it finished and
          the finishing pivots (from the facade's log file and the
          crossover's log records); then apply_projector_torch on the card
          for Y = A_std diag(x_std), the product get_projector_Xc projects
          with, within 1e-4 of the host apply_projector and
          ||Y p|| / ||Y v|| below 1e-3.  800 x 3200 is the smaller row of
          BENCH.md's large-LP table: the middle row, 1500 x 6000, takes
          6-11 min on an H100 machine's host and HiGHS as long again,
          which with the rest does not fit this script's 1200 s;
          scripts/torch_perturb_1500x6000.py runs that phase alone;
  cli_mps_800x3200
          random_sparse_lp(800, 3200, seed 1) written with write_mps, then
          `python -m smart_crossover_tpu_torch solve <file> --method
          barrier_perturb` in a subprocess (rc 0, the printed objective
          equal to HiGHS's on the LP read back to 1e-8), and meanwhile in
          this process solve_lp's barrier against barrier_perturb on that
          LP (the record's walls overlap: "overlapped": true);
  solve_ot_784
          instance 0 of the 784^2 batch through solve_ot: 'sinkhorn'
          (APPROXIMATE, K1 once), 'device_simplex' with the default engine
          'parent' (K1 once, K2 never) and with 'mega' (K1 and K2 once
          each), both OPTIMAL and equal to main_16x784x784's certified
          objective to 1e-9;
  drivers the paper's experiment drivers, scripts/torch_run_network_
          crossover.py and scripts/torch_run_perturb_crossover.py, through
          their functions, their result stores in a temporary directory
          outside the repo: `total` mode on the network script's first
          MNIST-like pair (28 x 28 images, 199 x 224 nonzero pixels: the
          cold network simplex, sinkhorn(ot) with K1 launched exactly once
          at B = 1, TNET and CNET_OT) and on a GOTO-128 .min file written
          there (solve_mcf(first_order), the sparse PDHG, then CNET_MCF),
          `crossover` mode on the same pair (the host barrier with
          crossover, then TNET and CNET_OT from its interior point), and
          the perturbation protocol (HiGHS, ptb, ori) on one small
          staircase; every record OPTIMAL, each crossover equal to its
          baseline record to 1e-9;
  example the usage walkthrough, examples/torch_example.py, through its
          demo functions: sinkhorn(ot) with K1 launched exactly once,
          TNET and CNET_OT OPTIMAL and equal to the cold network simplex
          to 1e-9; the perturbation crossover equal to the host barrier
          to 1e-8; batched_tnet on 8 x 32^2 with K1 launched exactly once,
          basic feasible vertices whose objectives a second call repeats
          and the CPU plain version's equal to 1e-5;
  instruments
          the ports of the JAX instruments: scripts/torch_soak_round3.py
          (49 checks, no failure, K1, K3 and K4 launched),
          scripts/torch_bench_device_simplex.py at size 64 only, batch 16
          (a cut of depth, printed: its sizes are 64 128 256; every engine
          all optimal, the gap to the host route within 1e-4, K2 launched
          by 'mega'), scripts/torch_profile_perturb.py stair 0.02 (every
          stage OPTIMAL) and scripts/torch_bench_scaling.py and
          torch_bench_projection.py under torchrun at one rank (rc 0, this
          card named), in subprocesses beside the others (every timing of
          the phase is marked "overlapped": true);
  sharded the multi-device layer at world size 1 on NCCL (one card), each
          sharded call held against the port's unsharded counterpart:
          sharded_batched_tnet_exact_device at 64 x 256^2 with 'mega' (K1
          and K2 once) and 'parent' (K1 once, K2 never) and
          batched_tnet_exact(mesh=) (K1 once), every instance certified at
          main_64x256x256's objectives to 1e-9; sharded_tnet_single on
          instance 0 of the 784^2 batch (a basic feasible flow whose
          support is a spanning forest, the push under its cap, its push
          iterations, seconds and gap to the certified objective);
          sharded_sinkhorn_plan there (1000 iterations) against K1's plain
          version; sharded_projector at 256 x 8192 against
          apply_projector_torch (ms per CG iteration); sharded_pdhg on the
          single LP (card float32 vs CPU float64 over 1000 iterations, then
          10,000 timed); the sharded ranking at GOTO-128 from the
          pdhg_mcf_device point; ipm_fleet(mesh=) at 64 x 256 x 512 against
          the unsharded call; lp_scenario_sweep(mesh=) on 32 RHS scenarios
          (HiGHS to 1e-6); mcf_scenario_sweep on 8 GOTO-128 demand
          scenarios (HiGHS to 1e-9, solved in worker processes); the
          multihost entry point in a subprocess at one process;
then the card's nvidia-smi line, the kernels' summary (each kernel's
median ms, launches on the main path, the plain version's ms, and its
bound: the largest of the operations these inputs need at the card's
float32 peak, the bytes it must move at the HBM rate and, for K1, the
exps at the MUFU rate, 16 per clock per SM at the card's max SM clock;
K1 and K2 add their launches on the sharded routes and per serving
dispatch, K1 in the drivers' `total` mode on its OT pair and in the
walkthrough's two demos, K3-K5 on both GOTO-17 rows and the drivers'
GOTO-128 `total` run, each kernel on the staircase row, in the soak and
in the device-simplex bench; the push kernel, last, with its ms on the
push phase's inputs and its launches on both main rows and in TNET; the
certificate and tree walk kernels, with their certify phase's ms and
their launches on both main rows, the walk's in TNET too)
and, last,
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REG, SINKHORN_ITERS, MAX_PIVOTS = 0.005, 1000, 20000
# kernel vs plain tolerances.  Both run float32 and take their sums in
# another order; over 1000 Sinkhorn iterations the potentials drift apart
# by ~1e-5 eps (H100, 64 x 256^2), so these leave a 50x margin.
K1_POT_ATOL = 1e-3      # |df|, |dg| in units of eps (the kernel runs on M/eps)
K1_PLAN_RTOL = 1e-3     # max |dplan| / max plan
K2_OBJ_RTOL = 1e-5      # objectives of the two optimal bases
# PDHG kernels vs plain, both float32 with sums in another order.  The
# adaptive step rule divides by curv = |dy.(A x_c - A x)|, a sum that
# cancels: in float32 it carries ~1e-3 relative rounding, so one
# 64-iteration chunk moves eta by up to ~2e-3 and the vectors by ~1e-3
# (H100: the float32 plain version is 1e-3..2e-2 off its float64 run on
# eta, the kernel 7e-4..1.2e-2).  Differences are relative to
# 1 + max |plain value|.  Each kernel must also be about as accurate as the
# float32 plain version: its distance to the plain version run in float64
# at most F64_RATIO times the float32 plain version's, plus F64_FLOOR.
PDHG_RTOL = 1e-2
ETA_RTOL = 5e-2         # the returned step size itself (K3)
F64_RATIO, F64_FLOOR = 4.0, 1e-5
# K5 over 2000 iterations: the fleet's trajectories are chaotic in the last
# bits, so only the step-weighted averages are compared, loosely.
K5_LONG_AVG_RTOL = 5e-2
LP_OBJ_RTOL = 1e-8      # exact vertex vs HiGHS
# the benchmark's rows that run only when named, each once in the bench
# phase
NAMED_ROWS = ("serve_16x128x128x16", "goto17_cnet_mcf",
              "goto17_irregular_cnet_mcf", "ipm_stair_10000x36975")
EXACT_RTOL = 1e-9       # network crossover / exact OT routes vs the
                        # certified or HiGHS objective (all f64 host)
GOTO_FOM_TOL = 1e-3     # solve_mcf(first_order)'s PDHG tolerance (float32
                        # on the card) before its network-simplex crossover
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, and HBM3
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# MUFU ex2 per clock per SM (Hopper); the exp rate is this times the SM
# count times the max SM clock, set by phase_env from the card
EX2_PER_CLOCK_PER_SM = 16
EXP_PER_S = None


_T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:          # when the phase ended, from the start
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def sync_time(fn, reps: int):
    """(last result, median ms, all ms) of fn() over reps, each synced."""
    import torch

    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times)), times


def event_ms(fn, reps: int) -> float:
    """Median ms of fn() over reps by CUDA events recorded around it on
    the current stream: the device time of what fn issues, no host sync
    inside."""
    import torch

    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(ops: float, nbytes: float, exps: float = 0.0):
    """(ms, what sets it): the least time the card could take for work of
    `ops` float32 operations and `exps` exponentials that must move
    `nbytes` bytes."""
    return max((ops / F32_OPS_PER_S * 1e3, "operations"),
               (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
               (exps / EXP_PER_S * 1e3 if exps else 0.0, "exp"))


def summary(name, source, replaces, err, ms, plain_ms, work):
    """A kernel's entry of the summary line; no single PyTorch call
    computes any of these kernels' functions, so library_ms is null."""
    b_ms, b_by = bound(*work)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def start(cmd, timeout):
    """Start cmd from the repo root, its output to temporary files, so
    that this process works on meanwhile; returns a function that waits
    for it (killing it past ``timeout`` s from the start) and gives (rc,
    stdout, stderr, seconds)."""
    import tempfile

    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=out, stderr=err, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))

    def wait():
        try:
            rc = proc.wait(timeout=max(1.0, timeout - (time.perf_counter()
                                                        - t0)))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        seconds = time.perf_counter() - t0
        with out, err:
            out.seek(0)
            err.seek(0)
            return rc, out.read(), err.read(), seconds
    return wait


def phase_env(torch, build):
    global EXP_PER_S
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                     "--format=csv,noheader,nounits"]).splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    EXP_PER_S = EX2_PER_CLOCK_PER_SM * sms * mhz * 1e6
    nvcc = run([build._nvcc(), "--version"]).splitlines()[-1]
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "sms": sms,
          "max_sm_mhz": mhz, "exp_per_s": EXP_PER_S})
    return smi


def phase_build(build):
    t0 = time.perf_counter()
    path = build.build(verbose=True)
    build.library()
    emit({"phase": "build", "library": os.path.relpath(path),
          "seconds": time.perf_counter() - t0,
          "compiled_now": build.build_seconds is not None})


def to_cuda(*arrays):
    import torch

    return [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in arrays]


def k1_at(B, S, D, seed, reps, plain_reps):
    """The Sinkhorn kernel on bench.py's batch (B, S, D, seed), eps folded
    into M as the main path folds it, against its plain version; its
    record, largest potential gap, kernel and plain ms and work."""
    import torch

    from smart_crossover_tpu_torch import bench
    from smart_crossover_tpu_torch.ops import sinkhorn_fused as sf

    s, d, M = to_cuda(*bench.make_batch(B, S, D, seed=seed))
    Mn = (M / (REG * M.amax((1, 2)))[:, None, None]).contiguous()
    (plan, f, g), ms, all_ms = sync_time(
        lambda: sf.sinkhorn_plan_fused(s, d, Mn, 1.0, SINKHORN_ITERS), reps)
    lay = dict(sf.LAST_LAUNCH)
    again = sf.sinkhorn_plan_fused(s, d, Mn, 1.0, SINKHORN_ITERS)
    identical = all(torch.equal(a, q) for a, q in zip((plan, f, g), again))
    (pp, pf, pg), plain_ms, _ = sync_time(
        lambda: sf.sinkhorn_plan_fused_plain(s, d, Mn, 1.0, SINKHORN_ITERS),
        plain_reps)
    df = (f - pf).abs().max().item()
    dg = (g - pg).abs().max().item()
    dplan = (plan - pp).abs().max().item()
    pmax = pp.abs().max().item()
    emit({"phase": "k1_sinkhorn", "shape": [B, S, D], "seed": seed,
          "iters": SINKHORN_ITERS, "max_abs_df": df, "max_abs_dg": dg,
          "max_abs_dplan": dplan, "max_plan": pmax, "ms": ms,
          "all_ms": all_ms, "ms_per_iteration": ms / SINKHORN_ITERS,
          "plain_ms": plain_ms, "repeat_bit_identical": identical,
          "cluster_size": lay["cluster_size"],
          "max_active_clusters": lay["max_active_clusters"],
          "waves": lay["waves"], "rows_in_smem": lay["rows_in_smem"],
          "n_res": lay["n_res"], "m_in_smem": lay["m_in_smem"],
          "smem_bytes_per_block": lay["smem_bytes"],
          "tolerance": {"pot_atol": K1_POT_ATOL,
                        "plan_rtol": K1_PLAN_RTOL}})
    require(all(np.isfinite([df, dg, dplan])), "k1 produced non-finite")
    require(df <= K1_POT_ATOL and dg <= K1_POT_ATOL,
            f"k1 potentials differ from plain at {[B, S, D]}: {df}, {dg}")
    require(dplan <= K1_PLAN_RTOL * pmax, f"k1 plan differs: {dplan}")
    require(identical, "k1 repeat launch not bit-identical")
    return max(df, dg), ms, plain_ms, sinkhorn_work(B, S, D)


def phase_k1():
    err, ms, plain_ms, work = k1_at(64, 256, 256, 0, 5, 3)
    err7, ms7, plain7, work7 = k1_at(16, 784, 784, 1, 5, 2)
    # the serving row's shape, its first dispatch's batch
    err1, ms1, plain1, work1 = k1_at(16, 128, 128, 0, 5, 3)
    out = summary("sinkhorn_fused", "smart_crossover_tpu_torch/csrc/"
                  "sinkhorn.cu",
                  "smart_crossover_tpu/ops/sinkhorn_pallas.py:26",
                  max(err, err7, err1), ms, plain_ms, work)
    out.update(ms_784=ms7, plain_ms_784=plain7, bound_ms_784=bound(*work7)[0],
               ms_serve_128=ms1, plain_ms_serve_128=plain1,
               bound_ms_serve_128=bound(*work1)[0])
    return out


def sinkhorn_work(B, S, D):
    """Per cell and half-iteration: (g - M) / reg, max, subtract, add
    around one exp; the plan 3 more and one exp.  M, s, d in and plan,
    f, g out, once.  Returns (operations, bytes, exps)."""
    cells = B * S * D
    return (cells * (10 * SINKHORN_ITERS + 3),
            4 * (2 * cells + 2 * B * (S + D)),
            cells * (2 * SINKHORN_ITERS + 1))


def k2_at(scx, B, S, D, seed, reps, n_plain):
    """The pivot-loop kernel on bench.py's batch (B, S, D, seed) against
    its plain version on the first n_plain instances; its record, the
    objectives' largest gap and the work that bounds it."""
    import torch

    from smart_crossover_tpu_torch import bench
    from smart_crossover_tpu_torch.ops import transport_simplex_mega as tsm
    from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst

    s, d, M = to_cuda(*bench.make_batch(B, S, D, seed=seed))
    X0, _, _ = scx.batched_tnet(s, d, M, REG, SINKHORN_ITERS)
    st = tsm.mega_setup(X0, boruvka_bipartite_mst((X0 > 1e-12).float()), M)
    k, ms, all_ms = sync_time(lambda: tsm.transport_simplex_mega_state(
        st, max_pivots=MAX_PIVOTS), reps)
    plan = dict(tsm.LAST_LAUNCH)
    again = tsm.transport_simplex_mega_state(st, max_pivots=MAX_PIVOTS)
    identical = all(torch.equal(a, q) for a, q in zip(k, again))
    sub = {n: v[:n_plain] for n, v in st.items()}
    p, plain_ms, _ = sync_time(lambda: tsm.transport_simplex_mega_plain(
        sub, max_pivots=MAX_PIVOTS), 2 if n_plain == B else 1)
    M64 = M[:n_plain].double()
    obj_k = (tsm.rebuild_plan(k[0][:n_plain], k[1][:n_plain], S, D).double()
             * M64).sum((1, 2))
    obj_p = (tsm.rebuild_plan(p[0], p[1], S, D).double() * M64).sum((1, 2))
    err = (obj_k - obj_p).abs().max().item()
    rel = ((obj_k - obj_p).abs() / obj_p.abs()).max().item()
    piv = k[5].tolist()
    rec = {"phase": "k2_transport_simplex_mega", "shape": [B, S, D],
           "seed": seed, "cluster_size": plan["cluster_size"],
           "max_active_clusters": plan["max_active_clusters"],
           "smem_bytes_per_block": plan["smem_bytes"],
           "n_in_smem": plan["n_in_smem"],
           "mask_in_smem": plan["mask_in_smem"],
           "all_optimal_kernel": bool(k[6].all()),
           "all_optimal_plain": bool(p[6].all()),
           "pivots_kernel": piv, "pivots_plain": p[5].tolist(),
           "plain_instances": n_plain,
           "same_pivots": int((k[5][:n_plain] == p[5]).sum().item()),
           "same_final_basis": int((k[4][:n_plain] == p[4]).all((1, 2))
                                   .sum().item()),
           "repeat_bit_identical": identical,
           "max_abs_dobj": err, "max_rel_dobj": rel, "ms": ms,
           "all_ms": all_ms, "ms_per_pivot": ms / max(max(piv), 1),
           "plain_ms": plain_ms, "tolerance": {"obj_rtol": K2_OBJ_RTOL}}
    emit(rec)
    require(bool(k[6].all()) and bool(p[6].all()), "k2 not all optimal")
    require(rel <= K2_OBJ_RTOL, f"k2 objectives differ: rel {rel}")
    require(identical, "k2 repeat launch not bit-identical")
    V = S + D
    # every pricing pass (pivots + 1 per instance) takes two subtractions
    # and a comparison per cell; M, N, the mask and the node vectors in,
    # the mask and node vectors out, once
    work = (3 * S * D * sum(n + 1 for n in piv),
            B * (4 * S * D + V * V + 2 * S * D + 32 * V))
    return err, ms, plain_ms, work


def phase_k2(scx):
    err, ms, plain_ms, work = k2_at(scx, 64, 256, 256, 0, 5, 64)
    err7, ms7, plain7, work7 = k2_at(scx, 16, 784, 784, 1, 3, 4)
    err1, ms1, plain1, work1 = k2_at(scx, 16, 128, 128, 0, 5, 16)
    out = summary("transport_simplex_mega", "smart_crossover_tpu_torch/"
                  "csrc/transport_simplex_mega.cu",
                  "smart_crossover_tpu/ops/transport_simplex_mega.py:73",
                  # objectives of the two final plans (their bases may tie)
                  max(err, err7, err1), ms, plain_ms, work)
    b7, _ = bound(*work7)
    out.update(ms_784=ms7, plain_ms_784_first4=plain7, bound_ms_784=b7,
               ms_serve_128=ms1, plain_ms_serve_128=plain1,
               bound_ms_serve_128=bound(*work1)[0])
    return out


def phase_main(scx, B, S, D, seed, reps):
    import torch

    from smart_crossover_tpu_torch import bench
    from smart_crossover_tpu_torch.ops import transport_simplex_mega as tsm
    from smart_crossover_tpu_torch.utils import trace

    s64, d64, M64 = bench.make_batch(B, S, D, seed=seed)
    s, d, M = to_cuda(s64, d64, M64)

    def go():
        return scx.batched_tnet_exact_device(
            s, d, M, reg=REG, sinkhorn_iters=SINKHORN_ITERS,
            max_pivots=MAX_PIVOTS)

    go()                                          # warm-up
    torch.cuda.synchronize()
    scx.reset_kernel_launch_counts()
    out = go()
    torch.cuda.synchronize()
    counts = scx.kernel_launch_counts()
    k2_cluster = tsm.LAST_LAUNCH["cluster_size"]
    _, dev_ms, all_ms = sync_time(go, reps)
    X, obj, push, piv, opt, Bm = out
    # the route's masks where they lie, the true float64 costs from the host
    scx.reset_kernel_launch_counts()
    with trace.recording() as st:
        t0 = time.perf_counter()
        certs = scx.certify_ot_basis_batch(Bm, s64, d64, M64)
        cert_s = time.perf_counter() - t0
    cert_counts = scx.kernel_launch_counts()
    on_card = st.summary()["scx.certify"]["counters"].get("certify.device")
    counts["certify"] = cert_counts["certify"]
    n_cert = sum(c.ok for c in certs)
    cobj = np.array([c.obj_val for c in certs])
    obj_rel = float(np.max(np.abs(obj.double().cpu().numpy() - cobj)
                           / np.abs(cobj)))
    rec = {"phase": f"main_{B}x{S}x{D}", "seed": seed,
           "n_certified": int(n_cert), "batch": B,
           "all_optimal_device": bool(opt.all()),
           "max_feas_err": float(max(c.max_feas_err for c in certs)),
           "min_reduced_cost": float(min(c.min_rcost for c in certs)),
           "median_pivots": float(np.median(piv.cpu().numpy())),
           "max_pivots": int(piv.max().item()),
           "median_push_iters": float(np.median(push.cpu().numpy())),
           "max_push_iters": int(push.max().item()),
           "device_obj_max_rel_to_certified": obj_rel,
           "device_stage_ms_median": dev_ms, "device_stage_ms": all_ms,
           "certify_s": cert_s,
           "certified_instances_per_s": B / (dev_ms / 1e3 + cert_s),
           "launches": counts, "certify_launches": cert_counts,
           "certified_on_card": on_card, "k2_cluster_size": k2_cluster}
    emit(rec)
    require(X.shape == (B, S, D) and bool(torch.isfinite(X).all())
            and bool(torch.isfinite(obj).all()), "main path output malformed")
    require(n_cert == B, f"only {n_cert}/{B} certified")
    require(cert_counts["certify"] == 1 and sum(cert_counts.values()) == 1
            and on_card == B,
            f"certification: launches {cert_counts}, {on_card} on the card")
    require(bool(opt.all()), "device did not reach optimality everywhere")
    require(obj_rel <= 1e-4, f"device objective off certificate: {obj_rel}")
    require(counts["sinkhorn_fused"] > 0
            and counts["transport_simplex_mega"] > 0,
            f"a kernel was not launched on the OT path: {counts}")
    require(counts["tree_push"] == 1,
            f"the push kernel ran {counts['tree_push']} times in one call")
    require(counts["tree_walk"] == 2,
            f"the tree walk kernel ran {counts['tree_walk']} times in one "
            f"call (the tree solve and K2 set-up's parent vector)")
    require(k2_cluster > 1, f"K2 ran {k2_cluster} block per instance")
    return counts, cobj, rec["certified_instances_per_s"]


def run_bench(*args):
    """`python -m smart_crossover_tpu_torch bench *args` in a subprocess:
    (its result line, seconds); fails unless rc 0."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "smart_crossover_tpu_torch",
                        "bench", *args], capture_output=True, text=True,
                       timeout=900, cwd=os.path.dirname(
                           os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    require(r.returncode == 0 and lines,
            f"bench {' '.join(args)}: rc {r.returncode}: {r.stderr[-600:]}")
    return json.loads(lines[-1]), seconds


def phase_bench(torch, main_ips):
    """`python -m smart_crossover_tpu_torch bench` in a subprocess at full
    size: rc 0, both rows correct and certified, K1 and K2 launched once
    per timed call, on this card.  `main_ips`: main_*'s certified
    instances/s by row, printed beside the bench's.  Then each row that
    runs only when named (``NAMED_ROWS``), once: serve_16x128x128x16
    (256/256 certified, all optimal on the card, K1 and K2 once per
    dispatch), goto17_cnet_mcf and goto17_irregular_cnet_mcf (CNET_MCF
    equal to the cold native core, the warm start on the card with no
    dense PDHG kernel) and ipm_stair_10000x36975 (both ipm_big solves
    OPTIMAL with the device stage on the card and the device endgame
    engaged, the f64 certificate on the true bounds, the host sparse
    barrier's objective to 1e-7).  Returns those rows' details by
    cell."""
    res, seconds = run_bench()
    rows = {"ot_64x256x256": res["detail"],
            "ot_16x784x784": res["detail"]["mnist_784"]}
    emit({"phase": "bench", "seconds": seconds,
          "certified_instances_per_s": {
              c: {"bench": row["certified_instances_per_sec"],
                  "main": main_ips[c],
                  "bench_over_main": row["certified_instances_per_sec"]
                  / main_ips[c]} for c, row in rows.items()},
          "result": res})
    require(res["detail"]["device_name"] == torch.cuda.get_device_name(0),
            f"bench ran on {res['detail']['device_name']}")
    for c, row in rows.items():
        require(row["correct"] and row["n_certified"] == row["batch"]
                and row["all_optimal_device"], f"bench {c}: not correct")
        per = row["launches_per_call"]
        require(per["sinkhorn_fused"] == 1
                and per["transport_simplex_mega"] == 1
                and per["tree_push"] == 1,
                f"bench {c}: K1/K2/push launches per call {per}")
    rows = {}
    for cell in NAMED_ROWS:
        res, seconds = run_bench("--cell", cell)
        row = rows[cell] = res["detail"]
        emit({"phase": f"bench_{cell}", "seconds": seconds, "result": res})
        require(row["device_name"] == torch.cuda.get_device_name(0)
                and row["backend"] == "cuda",
                f"bench {cell} ran on {row['device_name']}")
        require(row["correct"] and np.isfinite(res["value"]),
                f"bench {cell}: not correct")
    serve = rows["serve_16x128x128x16"]
    per = serve["launches_per_dispatch"]
    require(serve["n_certified"] == serve["total_instances"] == 256
            and serve["all_optimal_device"],
            f"serving: {serve['n_certified']}/256 certified")
    require(per["sinkhorn_fused"] == 1 and per["transport_simplex_mega"] == 1,
            f"serving: K1/K2 launches per dispatch {per}")
    for cell in ("goto17_cnet_mcf", "goto17_irregular_cnet_mcf"):
        goto = rows[cell]
        require(goto["cold_status"] == goto["crossover_status"] == "OPTIMAL"
                and goto["obj_match"], f"{cell}: CNET_MCF off the cold core")
        require(goto["regular"] is (cell == "goto17_cnet_mcf"),
                f"{cell}: regular={goto['regular']}")
        require(not any(goto["launches"][k] for k in ("pdhg_chunk",
                                                       "halpern_chunk",
                                                       "pdhg_batched")),
                f"{cell} launched a dense PDHG kernel: {goto['launches']}")
    stair = rows["ipm_stair_10000x36975"]
    require(all(r["status"] == "OPTIMAL" and r["device_iters"] > 0
                and r["ne_stats"] is not None for r in stair["solves"])
            and stair["device_stage_on"] == "cuda",
            f"ipm_stair: {[r['status'] for r in stair['solves']]}")
    require(stair["obj_rel_to_baseline"] <= 1e-7
            and stair["certificate"]["on_wide_box"] == 0,
            f"ipm_stair: {stair['certificate']}")
    return rows


# ------------------------------------------------------------------ push

def push_inputs(fn) -> list:
    """The input X of every push that ``fn()`` makes, the route's
    ``push_to_bfs`` wrapped to keep a copy."""
    from smart_crossover_tpu_torch.network_methods import tree_bi

    seen, push = [], tree_bi.push_to_bfs

    def keep(X, *args, **kwargs):
        seen.append(X.clone())
        return push(X, *args, **kwargs)

    tree_bi.push_to_bfs = keep
    try:
        fn()
    finally:
        tree_bi.push_to_bfs = push
    return seen


def push_work(X, iters):
    """(operations, bytes) of one push call: the clone reads and writes X,
    the kernel reads it once for the row minima, and each step reads row
    I1, column J1 and rows I1 and I2 again and writes four cells."""
    B, S, D = X.shape
    steps = float(iters.sum())
    return (B * S * D + steps * (S + 3 * D),
            X.element_size() * (3.0 * B * S * D + steps * (S + 3 * D + 4))
            + 8.0 * B)


def push_compare(label, X, reps, plain_reps):
    """One input through the kernel and the plain loop: both results equal
    bit for bit, one launch a call, the median ms of each."""
    import torch

    from smart_crossover_tpu_torch import _build
    from smart_crossover_tpu_torch.ops.tree import (
        push_to_bfs,
        push_to_bfs_plain,
    )

    push_to_bfs(X)                                # warm-up
    torch.cuda.synchronize()
    n0 = _build.LAUNCHES["tree_push"]
    (Xk, ik), ms, _ = sync_time(lambda: push_to_bfs(X), reps)
    launches = (_build.LAUNCHES["tree_push"] - n0) / reps
    (Xp, ip), plain_ms, _ = sync_time(lambda: push_to_bfs_plain(X),
                                      plain_reps)
    same = bool(torch.equal(Xk, Xp) and torch.equal(ik, ip))
    b_ms, b_by = bound(*push_work(X, ik))
    rec = {"input": label, "shape": list(X.shape), "dtype": str(X.dtype),
           "steps_max": int(ik.max()), "steps_mean": float(ik.float().mean()),
           "ms": ms, "plain_ms": plain_ms, "launches_per_call": launches,
           "bound_ms": b_ms, "bound_by": b_by, "equal": same}
    require(same, f"push {label}: the kernel and the plain loop differ")
    require(launches == 1, f"push {label}: {launches} launches a call")
    return rec


def phase_push(scx):
    """The push kernel on the inputs the main path gives it: one
    batched_tnet_exact_device call on 16 DOTmark-like 32 x 32 white-noise
    pairs (16 x 1024^2) and sinkhorn then TNET on four MNIST-like pairs
    (B = 1), each push held to the plain loop bit for bit.  Returns the
    kernel's summary entry: its bound is the bytes at the HBM rate, far
    below the time the serial chain of steps takes."""
    from smart_crossover_tpu_torch.data.ot_gen import (
        images_to_ot,
        synthetic_digits,
    )

    rng = np.random.default_rng(20)
    side = 32
    s = rng.uniform(0.0, 1.0, (16, side * side))
    d = rng.uniform(0.0, 1.0, (16, side * side))
    r, c = np.divmod(np.arange(side * side), side)
    C = ((r[:, None] - r[None, :]) ** 2 + (c[:, None] - c[None, :]) ** 2)
    M = np.broadcast_to(C.astype(np.float64), (16,) + C.shape)
    s, d, M = to_cuda(s / s.sum(1, keepdims=True),
                      d / d.sum(1, keepdims=True), M)
    batch = push_inputs(lambda: scx.batched_tnet_exact_device(
        s, d, M, reg=REG, sinkhorn_iters=SINKHORN_ITERS,
        max_pivots=MAX_PIVOTS))
    require(len(batch) == 1, f"{len(batch)} pushes in one batched call")
    rows = [push_compare("dotmark_16x1024x1024", batch[0], 10, 2)]
    imgs = synthetic_digits(8, seed=20)
    for q in range(4):
        ot = images_to_ot(imgs[2 * q], imgs[2 * q + 1])

        def tnet():
            x = scx.sinkhorn(ot, reg=REG, num_iters=SINKHORN_ITERS)
            scx.network_crossover(x, ot=ot, method="tnet")

        pushes = push_inputs(tnet)
        require(len(pushes) == 1, f"{len(pushes)} pushes in one TNET call")
        rows.append(push_compare(f"mnist_pair{q}", pushes[0], 20, 3))
    emit({"phase": "push", "inputs": rows})
    big, mnist = rows[0], rows[1:]
    entry = {"name": "tree_push", "route": "cuda",
             "source": "csrc/tree_push.cu",
             "replaces": "none: the JAX package's lax.while_loop; the "
                         "port's host-driven loop",
             "max_abs_err": 0.0, "ms": big["ms"], "plain_ms": big["plain_ms"],
             "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
             "library_ms": None, "steps_max": big["steps_max"]}
    for key in ("ms", "plain_ms", "bound_ms", "shape", "steps_max"):
        entry[f"{key}_mnist"] = [r[key] for r in mnist]
    return entry


# --------------------------------------------------------------- certify

def certs_agree(certs, plain):
    """Whether two certifiers' certificates of one batch agree as the CPU
    tests hold them (tests/test_torch_certify.py::_agree: the same verdict
    and reason prefix; objective to 1e-12 relative, vertex to 1e-12
    relative and 1e-15 absolute, feasibility error, smallest flow and
    smallest reduced cost to 1e-9 relative and 1e-12 absolute), and the
    largest absolute gap between any of those numbers."""
    agree, gap = len(certs) == len(plain), 0.0
    for a, b in zip(certs, plain):
        agree &= (a.ok == b.ok
                  and a.reason.split("=")[0] == b.reason.split("=")[0])
        if not np.isfinite(b.obj_val):
            agree &= bool(np.isnan(a.obj_val))
            continue
        agree &= bool(np.isclose(a.obj_val, b.obj_val, rtol=1e-12, atol=0)
                      and np.allclose(a.x, b.x, rtol=1e-12, atol=1e-15))
        pairs = [(a.obj_val, b.obj_val), (a.x, b.x)]
        for key in ("max_feas_err", "min_flow", "min_rcost"):
            u, v = getattr(a, key), getattr(b, key)
            agree &= bool(np.isclose(u, v, rtol=1e-9, atol=1e-12))
            pairs.append((u, v))
        gap = max(gap, *(float(np.max(np.abs(np.subtract(u, v))))
                         for u, v in pairs))
    return agree, gap


def lowered_off_tree(Bm, M, seed):
    """M with 8 random cells off each odd instance's tree made cheaper by
    up to four times the largest cost: those cells' reduced costs, taken
    from the tree's duals, fall below the tolerance, and the instances are
    rejected, while the even ones keep their optimal costs."""
    rng = np.random.default_rng(seed)
    M = M.copy()
    lower = 4.0 * float(np.abs(M).max())
    for b in range(1, len(M), 2):
        off = rng.choice(np.flatnonzero(~Bm[b].ravel()), 8, replace=False)
        cells = np.unravel_index(off, Bm[b].shape)
        M[b][cells] -= (lower * rng.uniform(0.25, 1.0, 8)).astype(M.dtype)
    return M


def certify_at(scx, label, Bm, s, d, M, reps):
    """One batch of bases through the certificate's card path and its
    SciPy path: the same certificates (``certs_agree``) on the route's
    optimal bases and on those bases under costs lowered off the tree
    (``lowered_off_tree``: the reduced-cost verdicts must differ from
    all-ok), one launch a call, the ms of each part."""
    import torch

    from smart_crossover_tpu_torch import _build
    from smart_crossover_tpu_torch.ops import certify as ck
    from smart_crossover_tpu_torch.utils import trace

    dev = torch.device("cuda")
    cert = scx.certify_ot_basis_batch
    cert(Bm, s, d, M)                             # warm-up: staging buffer
    n0 = _build.LAUNCHES["certify"]
    certs, call_ms, all_ms = sync_time(lambda: cert(Bm, s, d, M), reps)
    launches = (_build.LAUNCHES["certify"] - n0) / reps
    with trace.recording() as st:
        for _ in range(reps):
            cert(Bm, s, d, M)
    kernel_ms = st.summary()["scx.certify_kernel"]["event_s"] / reps * 1e3
    host = [Bm.view(np.uint8), M, s, d]
    on_card, upload_ms, _ = sync_time(lambda: ck._upload(host, dev), reps)
    _, pageable_ms, _ = sync_time(
        lambda: [torch.from_numpy(a).to(dev) for a in host], reps)
    mask_t, M_t, s_t, d_t = on_card
    _, launch_ms, _ = sync_time(
        lambda: ck.certify_batch_cuda(mask_t.view(torch.bool), s_t, d_t, M_t,
                                      dev), reps)
    t0 = time.perf_counter()
    plain = cert(Bm, s, d, M, device="cpu")
    plain_ms = (time.perf_counter() - t0) * 1e3
    agree, gap = certs_agree(certs, plain)
    M_low = lowered_off_tree(Bm, M, 22)
    low, low_plain = (cert(Bm, s, d, M_low, device=where)
                      for where in (dev, "cpu"))
    agree_low, gap_low = certs_agree(low, low_plain)
    b_ms, b_by = bound(0.0, Bm.nbytes + M.nbytes)
    rec = {"input": label, "shape": list(M.shape), "cost_dtype": str(M.dtype),
           "certified": int(sum(c.ok for c in certs)),
           "call_ms": call_ms, "call_ms_all": all_ms, "kernel_ms": kernel_ms,
           "launch_and_fetch_ms": launch_ms, "upload_ms": upload_ms,
           "upload_pageable_ms": pageable_ms, "bound_ms": b_ms,
           "bound_by": b_by, "plain_ms": plain_ms,
           "launches_per_call": launches, "agree": agree,
           "max_abs_err": gap,
           "lowered_off_tree": {
               "certified": [c.ok for c in low],
               "certified_plain": [c.ok for c in low_plain],
               "min_rcost": [c.min_rcost for c in low],
               "agree": agree_low, "max_abs_err": gap_low}}
    require(agree, f"certify {label}: the kernel and the SciPy path differ")
    require(rec["certified"] == len(certs),
            f"certify {label}: {rec['certified']}/{len(certs)} certified")
    require(agree_low, f"certify {label}, costs lowered off the tree: the "
                       f"kernel and the SciPy path differ")
    require(0 < sum(c.ok for c in low) < len(low),
            f"certify {label}, costs lowered off the tree: the verdicts do "
            f"not mix ({sum(c.ok for c in low)}/{len(low)} certified)")
    require(launches == 1, f"certify {label}: {launches} launches a call")
    return rec


def walk_work(B, S, D, flows):
    """(operations, bytes) of one tree walk launch: the mask read once,
    and the masses read and the S + D - 1 arcs' flows written, or the
    parent vector written; the per-instance status besides."""
    V = S + D
    out = 4.0 * B * (V + V - 1) if flows else 8.0 * B * V
    return 0.0, float(B * S * D) + out + 8.0 * B


def walk_at(label, Bm, s, d, reps):
    """The tree walk kernel on one batch of the route's bases Bm with the
    route's float32 masses, against the plain loops on the card: the parent
    vectors equal; the flows on the tree's arcs, zero wherever the float64
    plain loop's are, and within the card test's float32 limit
    (tests/test_torch_kernels_cuda.py::test_tree_walk_matches_plain); one
    launch a call.  The kernel's ms alone (CUDA events around the launch),
    the whole call's (buffers, the status read) and the plain loops'."""
    import torch

    from smart_crossover_tpu_torch import _build
    from smart_crossover_tpu_torch.ops import tree

    Bm = Bm.to(torch.bool)
    B, S, D = Bm.shape
    tree.bipartite_tree_solve(Bm, s, d)           # warm-up
    n0 = _build.LAUNCHES["tree_walk"]
    X, call_ms, _ = sync_time(lambda: tree.bipartite_tree_solve(Bm, s, d),
                              reps)
    parent, parent_call_ms, _ = sync_time(
        lambda: tree.build_parent_from_mask(Bm), reps)
    launches = (_build.LAUNCHES["tree_walk"] - n0) / (2 * reps)
    ms = event_ms(tree.walk_launcher(Bm, s, d)[0], reps)
    parent_ms = event_ms(tree.walk_launcher(Bm)[0], reps)
    Xp, plain_ms, _ = sync_time(
        lambda: tree.bipartite_tree_solve_plain(Bm, s, d), 2)
    parent_p, parent_plain_ms, _ = sync_time(
        lambda: tree.build_parent_from_mask_plain(Bm), 2)
    X64 = tree.bipartite_tree_solve_plain(Bm, s.double(), d.double())
    big = X64.abs().amax((1, 2), keepdim=True)
    gap = (s.double().sum(1) - d.double().sum(1)).abs()[:, None, None]
    err = (X.double() - X64).abs()
    flows_ok = (not bool(((X != 0) & ~Bm).any())
                and not bool(((X != 0) & (X64 == 0)).any())
                and bool((err <= 2.0**-23 * X64.abs() + gap
                          + 2.0**-40 * big).all())
                and bool(((X - Xp).double().abs()
                          <= 16 * 2.0**-23 * big + gap).all()))
    same = bool(torch.equal(parent, parent_p))
    b_ms, b_by = bound(*walk_work(B, S, D, True))
    rec = {"input": label, "shape": [B, S, D], "dtype": str(X.dtype),
           "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by,
           "parent_ms": parent_ms, "parent_call_ms": parent_call_ms,
           "parent_plain_ms": parent_plain_ms,
           "parent_bound_ms": bound(*walk_work(B, S, D, False))[0],
           "launches_per_call": launches, "parents_equal": same,
           "flows_within_limit": flows_ok,
           "max_abs_err_to_f64": float(err.max()),
           "zero_flows": int(((X64 == 0) & Bm).sum())}
    require(same, f"tree walk {label}: the parent vector differs from the "
                  f"plain BFS")
    require(flows_ok, f"tree walk {label}: the flows are off the plain "
                      f"loop's (max |err| {rec['max_abs_err_to_f64']})")
    require(launches == 1, f"tree walk {label}: {launches} launches a call")
    return rec


def phase_certify(scx):
    """The certificate kernel on the route's optimal bases at the two batch
    cells' shapes, and the tree walk kernel on the same bases with the
    route's float32 masses.  Returns the two kernels' summary entries (the
    DOTmark-like batch; the grid's beside it)."""
    from smart_crossover_tpu_torch.data.ot_gen import (
        grid_l1_cost,
        synthetic_digits,
    )

    rng = np.random.default_rng(22)
    side = 32
    s = rng.uniform(0.0, 1.0, (16, side * side))
    d = rng.uniform(0.0, 1.0, (16, side * side))
    r, c = np.divmod(np.arange(side * side), side)
    C = ((r[:, None] - r[None, :]) ** 2 + (c[:, None] - c[None, :]) ** 2)
    dot = (s / s.sum(1, keepdims=True), d / d.sum(1, keepdims=True),
           np.broadcast_to(C.astype(np.float32), (16,) + C.shape).copy())
    imgs = synthetic_digits(32, 28, 22, 4).reshape(32, -1)
    imgs = imgs / imgs.sum(1, keepdims=True)
    idx = np.arange(784)
    G = grid_l1_cost((28, 28), idx, (28, 28), idx).astype(np.float32)
    grid = (imgs[0::2].copy(), imgs[1::2].copy(),
            np.broadcast_to(G, (16,) + G.shape).copy())
    rows, walks = [], []
    for label, (s, d, M) in (("dotmark_16x1024x1024", dot),
                             ("digits_grid_16x784x784", grid)):
        out = scx.batched_tnet_exact_device(
            s, d, M, reg=REG, sinkhorn_iters=SINKHORN_ITERS,
            max_pivots=MAX_PIVOTS)
        require(bool(out[4].all()), f"certify {label}: route not optimal")
        rows.append(certify_at(scx, label, out[5].cpu().numpy(), s, d, M, 10))
        walks.append(walk_at(label, out[5], *to_cuda(s, d), 20))
    emit({"phase": "certify", "inputs": rows, "tree_walk": walks})
    big, grid_row = rows
    entry = {"name": "certify", "route": "cuda", "source": "csrc/certify.cu",
             "replaces": "none: the JAX package certifies on the host in "
                         "NumPy/SciPy",
             "max_abs_err": max(max(r["max_abs_err"],
                                    r["lowered_off_tree"]["max_abs_err"])
                                for r in rows),
             "ms": big["kernel_ms"],
             "call_ms": big["call_ms"], "upload_ms": big["upload_ms"],
             "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
             "bound_by": big["bound_by"], "library_ms": None}
    for key in ("ms", "call_ms", "upload_ms", "plain_ms", "bound_ms"):
        entry[f"{key}_784"] = grid_row["kernel_ms" if key == "ms" else key]
    walk = {"name": "tree_walk", "route": "cuda",
            "source": "csrc/tree_walk.cu",
            "replaces": "none: the JAX package's lax.while_loops; the "
                        "port's host-driven loops",
            "max_abs_err": max(w["max_abs_err_to_f64"] for w in walks),
            "library_ms": None}
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "parent_ms", "parent_call_ms", "parent_plain_ms",
            "parent_bound_ms")
    for key in keys:
        walk[key] = walks[0][key]
        walk[f"{key}_784"] = walks[1][key]
    return entry, walk


# ------------------------------------------------------ network crossover

def phase_network_crossover(scx, cert_obj):
    """The verify flow at the reference's MNIST scale: instance 0 of
    bench.py's 16 x 784^2 batch (seed 1), sinkhorn(ot) on the card (K1 at
    B = 1), then network_crossover with TNET and CNET_OT.  `cert_obj` is
    main_16x784x784's certified objective of that instance (K2 and the
    host certifier: another route)."""
    import torch

    from smart_crossover_tpu_torch import bench
    from smart_crossover_tpu_torch.ops import sinkhorn_fused as sf
    from smart_crossover_tpu_torch.solvers.sinkhorn import round_to_feasible

    from smart_crossover_tpu_torch import native

    # the native network simplex builds at first use: build it here, so
    # that g++ is not timed inside the first crossover
    t0 = time.perf_counter()
    native.library()
    native_build_s = time.perf_counter() - t0
    s, d, M = (a[0] for a in bench.make_batch(16, 784, 784, seed=1))
    S, D = M.shape
    ot = scx.OptTransport(s=s, d=d, M=M)
    torch.cuda.synchronize()
    scx.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    x = scx.sinkhorn(ot, reg=REG, num_iters=SINKHORN_ITERS)
    sinkhorn_s = time.perf_counter() - t0
    counts = scx.kernel_launch_counts()
    lay = dict(sf.LAST_LAUNCH)
    # the call's kernel launch alone, and the plain version on the card, on
    # the call's own inputs (eps folded into M in float32, as it folds it)
    st, dt, Mt = to_cuda(s[None], d[None], M[None])
    Mn = (Mt / (REG * Mt.amax())).contiguous()
    _, k1_ms, k1_all = sync_time(lambda: sf.sinkhorn_plan_fused(
        st, dt, Mn, 1.0, SINKHORN_ITERS), 3)
    (pp, _, _), plain_ms, _ = sync_time(lambda: sf.sinkhorn_plan_fused_plain(
        st, dt, Mn, 1.0, SINKHORN_ITERS), 1)
    xp = round_to_feasible(pp, st, dt)[0].double().cpu().numpy().ravel()
    dplan = float(np.abs(x - xp).max())
    pmax = float(np.abs(xp).max())
    rec = {"phase": "network_crossover_784x784", "seed": 1, "instance": 0,
           "sinkhorn_launches": counts["sinkhorn_fused"],
           "sinkhorn_call_s": sinkhorn_s, "k1_ms": k1_ms,
           "k1_all_ms": k1_all, "k1_plain_ms": plain_ms,
           "max_abs_dplan": dplan, "max_plan": pmax,
           "k1_cluster_size": lay["cluster_size"],
           "k1_max_active_clusters": lay["max_active_clusters"],
           "k1_waves": lay["waves"], "k1_n_res": lay["n_res"],
           "k1_m_in_smem": lay["m_in_smem"],
           "k1_smem_bytes_per_block": lay["smem_bytes"],
           "certified_obj": cert_obj, "native_build_s": native_build_s,
           "tolerance": {"plan_rtol": K1_PLAN_RTOL, "obj_rtol": EXACT_RTOL}}
    require(counts["sinkhorn_fused"] == 1,
            f"sinkhorn(ot) launched K1 {counts['sinkhorn_fused']} times")
    require(bool(np.isfinite(x).all()) and x.shape == (S * D,),
            "sinkhorn(ot) output malformed")
    require(dplan <= K1_PLAN_RTOL * pmax, f"K1 at B = 1 differs: {dplan}")
    for method in ("tnet", "cnet_ot"):
        stats = {}
        scx.reset_kernel_launch_counts()
        t0 = time.perf_counter()
        out = scx.network_crossover(x, ot=ot, method=method, stats=stats)
        wall = time.perf_counter() - t0
        launches = scx.kernel_launch_counts()
        rel = abs(out.obj_val - cert_obj) / abs(cert_obj)
        rec[method] = {"status": out.status, "obj": out.obj_val,
                       "rel_to_certified": rel, "wall_s": wall,
                       "pivots": out.iter_count,
                       "runtime_s": out.runtime.total_seconds(), **stats}
        require(out.status == "OPTIMAL", f"{method}: {out.status}")
        require(rel <= EXACT_RTOL, f"{method} off the certificate: {rel}")
        if method == "tnet":
            c = scx.certify_ot_basis((out.basis.vbasis == 0).reshape(S, D),
                                     s, d, M)
            rec[method].update(basis_certified=c.ok,
                               basis_max_feas_err=c.max_feas_err,
                               basis_min_reduced_cost=c.min_rcost,
                               push_launches=launches["tree_push"],
                               walk_launches=launches["tree_walk"])
            require(c.ok, f"TNET basis not certified: {c.reason}")
            require(launches["tree_push"] == 1,
                    f"TNET ran the push kernel {launches['tree_push']} "
                    f"times")
            require(launches["tree_walk"] == 1,
                    f"TNET ran the tree walk kernel "
                    f"{launches['tree_walk']} times")
    emit(rec)
    counts["tree_push"] = rec["tnet"]["push_launches"]
    counts["tree_walk"] = rec["tnet"]["walk_launches"]
    return counts, k1_ms, plain_ms


@contextlib.contextmanager
def sparse_route_only():
    """While the sparse first-order route runs: the dense PDHG chunks'
    plain versions raise if called, and the launch counts are zeroed so
    that the caller can check K3, K4 and K5 launched no time."""
    import smart_crossover_tpu_torch as scx
    from smart_crossover_tpu_torch.ops import pdhg_chunk as tpc

    saved = tpc.pdhg_chunk_plain, tpc.halpern_chunk_plain

    def refuse(*args, **kwargs):
        raise RuntimeError("a dense PDHG chunk's plain version was called "
                           "on the sparse route")

    tpc.pdhg_chunk_plain = tpc.halpern_chunk_plain = refuse
    scx.reset_kernel_launch_counts()
    try:
        yield
    finally:
        tpc.pdhg_chunk_plain, tpc.halpern_chunk_plain = saved


def require_no_dense_pdhg(scx, what):
    counts = scx.kernel_launch_counts()
    dense = {k: counts[k] for k in ("pdhg_chunk", "halpern_chunk",
                                    "pdhg_batched")}
    require(not any(dense.values()),
            f"{what} launched a dense PDHG kernel: {dense}")
    return counts


def operator_ms(mcf, iters):
    """ms per Halpern PDHG iteration on the card, float32, of the MCF's
    incidence matrix as the index_add_/gather operator and as a CSR
    operator, the same run of `iters` iterations timed for each (two synced
    runs after a warm-up of one chunk, median)."""
    import torch

    from smart_crossover_tpu_torch.ops.pdhg_sparse import (
        CSROperator, IncidenceOperator)
    from smart_crossover_tpu_torch.solvers import pdhg_mcf as pm
    from smart_crossover_tpu_torch.solvers.pdhg import _pdhg_core_halpern

    f32 = dict(dtype=torch.float32, device=DEVICE)
    A = mcf.A.tocoo()
    ops = {"index_add": IncidenceOperator(mcf.tails, mcf.heads, mcf.m,
                                          torch.float32, DEVICE),
           "csr": CSROperator(A.row, A.col, A.data, A.shape, torch.float32,
                              DEVICE)}
    b = torch.tensor(mcf.b, **f32)
    c = torch.tensor(mcf.c, **f32)
    u = torch.tensor(mcf.u, **f32)
    l = torch.zeros(mcf.n, **f32)
    x0, y0 = torch.zeros(mcf.n, **f32), torch.zeros(mcf.m, **f32)
    eq = torch.ones(mcf.m, dtype=torch.bool, device=DEVICE)
    v = torch.tensor(pm._start_vector(mcf.n), **f32)
    out = {}
    for name, op in ops.items():
        opn = pm._power_opnorm(op, v)

        def run(k):
            return _pdhg_core_halpern(op, b, c, l, u, eq, opn, x0, y0,
                                      max_iters=k, check_every=250,
                                      restart_period=500, tol=0.0)

        run(250)
        _, ms, all_ms = sync_time(lambda: run(iters), 2)
        out[name] = {"ms_per_iteration": ms / iters,
                     "all_ms_per_iteration": [t / iters for t in all_ms]}
    return out


def phase_goto(scx):
    """CNET_MCF on goto_like_mcf(128, 128, 4, regular=True, seed=42), the
    generator scripts/run_goto17.py runs at 362^2, from three warm starts:
    HiGHS's optimum plus U(-0.05, 0.05) u noise, clipped to [0, u] (numpy
    seed 0); then the first-order routes on the card: solve_mcf(method=
    'first_order') with crossover on (PDHG on the sparse incidence matrix,
    then the network simplex), and network_crossover(cnet_mcf) from a
    pdhg_mcf_device warm start (Halpern, 5000 iterations, tol 1e-4).
    Every vertex equal to HiGHS to 1e-9; no dense PDHG kernel launched,
    no dense chunk's plain version called.  Returns the HiGHS objective
    and the first-order launch counts."""
    import torch
    from scipy.optimize import linprog

    from smart_crossover_tpu_torch.bench_goto17 import mcf_kkt
    from smart_crossover_tpu_torch.data.mcf_gen import goto_like_mcf
    from smart_crossover_tpu_torch.solvers.network_simplex import (
        network_simplex)
    from smart_crossover_tpu_torch.solvers.pdhg_mcf import pdhg_mcf_device

    mcf = goto_like_mcf(128, 128, extra_arc_factor=4, regular=True, seed=42)
    t0 = time.perf_counter()
    ref = linprog(mcf.c, A_eq=mcf.A, b_eq=mcf.b,
                  bounds=np.stack([np.zeros(mcf.n), mcf.u], 1),
                  method="highs")
    highs_s = time.perf_counter() - t0
    require(ref.status == 0, f"HiGHS failed: {ref.message}")
    rng = np.random.default_rng(0)
    x = np.clip(ref.x + rng.uniform(-0.05, 0.05, mcf.n) * mcf.u, 0, mcf.u)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = scx.network_crossover(x, mcf=mcf, method="cnet_mcf", stats=stats)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold = network_simplex(mcf)
    cold_s = time.perf_counter() - t0
    rel = abs(out.obj_val - ref.fun) / abs(ref.fun)
    rec = {"phase": "network_crossover_goto128", "nodes": mcf.m,
           "arcs": mcf.n, "status": out.status, "obj": out.obj_val,
           "highs_obj": float(ref.fun), "rel_to_highs": rel,
           "highs_s": highs_s, "wall_s": wall, "pivots": out.iter_count,
           **stats, "cold_status": cold.status,
           "cold_pivots": cold.iter_count, "cold_s": cold_s,
           "cold_rel_to_highs": abs(cold.obj_val - ref.fun) / abs(ref.fun),
           "tolerance": {"obj_rtol": EXACT_RTOL}}
    require(out.status == "OPTIMAL", f"cnet_mcf: {out.status}")
    require(rel <= EXACT_RTOL, f"cnet_mcf off HiGHS: {rel}")
    require(cold.status == "OPTIMAL", f"cold network simplex: {cold.status}")

    # solve_mcf(first_order), crossover on: the facade's sparse route
    settings = scx.SolverSettings(barrierTol=GOTO_FOM_TOL,
                                  firstOrderMaxIters=20_000)
    with sparse_route_only():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fo = scx.solve_mcf(mcf, method="first_order", settings=settings)
        fo_wall = time.perf_counter() - t0
        counts = require_no_dense_pdhg(scx, "solve_mcf(first_order)")
    fo_rel = abs(fo.obj_val - ref.fun) / abs(ref.fun)
    rec["solve_mcf_first_order"] = {
        "status": fo.status, "obj": fo.obj_val, "rel_to_highs": fo_rel,
        "wall_s": fo_wall, "pdhg_iterations": fo.bar_iter_count,
        "pdhg_s": fo.runtime.total_seconds(), "pivots": fo.iter_count,
        "tol": GOTO_FOM_TOL, "launches": counts}
    # network_crossover(cnet_mcf) from a pdhg_mcf_device warm start
    with sparse_route_only():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xw, yw, iters, conv, rt = pdhg_mcf_device(mcf, tol=1e-4,
                                                  max_iters=5000)
        warm_s = time.perf_counter() - t0
        counts_w = require_no_dense_pdhg(scx, "pdhg_mcf_device")
    stats_w = {}
    t0 = time.perf_counter()
    outw = scx.network_crossover(np.clip(xw, 0, mcf.u), mcf=mcf,
                                 method="cnet_mcf", stats=stats_w)
    cross_s = time.perf_counter() - t0
    w_rel = abs(outw.obj_val - ref.fun) / abs(ref.fun)
    rec["pdhg_mcf_device_cnet_mcf"] = {
        "pdhg_iterations": iters, "pdhg_converged": conv,
        "pdhg_s": warm_s, "pdhg_ms_per_iteration": warm_s * 1e3 / iters,
        "kkt_rel": mcf_kkt(mcf, xw, yw), "status": outw.status,
        "obj": outw.obj_val, "rel_to_highs": w_rel,
        "crossover_s": cross_s, "pivots": outw.iter_count, **stats_w,
        "launches": counts_w}
    rec["operators_halpern_2000"] = operator_ms(mcf, 2000)
    emit(rec)
    require(fo.status == "OPTIMAL" and fo_rel <= EXACT_RTOL,
            f"solve_mcf(first_order): {fo.status}, {fo_rel} off HiGHS")
    require(outw.status == "OPTIMAL" and w_rel <= EXACT_RTOL,
            f"cnet_mcf from pdhg_mcf_device: {outw.status}, {w_rel}")
    require(bool(np.isfinite(xw).all() and np.isfinite(yw).all()),
            "pdhg_mcf_device output not finite")
    return counts, counts_w, xw


def phase_goto17(scx, row):
    """pdhg_mcf_device at the flagship scale of scripts/run_goto17.py:
    goto_like_mcf(362, 362, 4, regular=True), 131,044 nodes and 786,264
    arcs.  The full warm start is the goto17_cnet_mcf row's (`row`, the
    bench phase's run on the same instance read back from its .min file:
    5000 Halpern iterations at tol 1e-4); here the first 250-iteration
    chunk on the card.  The relative KKT residuals (host f64) at the start
    (x = 0, y = 0: only the primal one is nonzero there), after the first
    chunk and at the row's end must be finite; the primal residual must
    fall below its start and the summed score below the first chunk's.
    Then the incidence operator against a CSR operator, ms per Halpern
    iteration."""
    from smart_crossover_tpu_torch.bench_goto17 import SEED_BASE, mcf_kkt
    from smart_crossover_tpu_torch.data.mcf_gen import goto_like_mcf
    from smart_crossover_tpu_torch.solvers.pdhg_mcf import pdhg_mcf_device

    t0 = time.perf_counter()
    mcf = goto_like_mcf(362, 362, extra_arc_factor=4, regular=True,
                        seed=SEED_BASE)
    gen_s = time.perf_counter() - t0
    require(row["seed"] == SEED_BASE and row["nodes"] == mcf.m
            and row["arcs"] == mcf.n, "goto17: the row ran another instance")
    kkt0 = mcf_kkt(mcf, np.zeros(mcf.n), np.zeros(mcf.m))
    with sparse_route_only():
        x1, y1, it1, _, _ = pdhg_mcf_device(mcf, tol=0.0, max_iters=250)
        counts = require_no_dense_pdhg(scx, "pdhg_mcf_device at GOTO-17")
    kkt1 = mcf_kkt(mcf, x1, y1)
    kkt = row["warm_kkt_rel"]
    iters = row["warm_iters"]
    rec = {"phase": "pdhg_mcf_goto17", "nodes": mcf.m, "arcs": mcf.n,
           "generate_s": gen_s, "iterations": iters,
           "converged": row["warm_converged"],
           "wall_s": row["warm_steady_s"],
           "ms_per_iteration": row["warm_ms_per_iteration"],
           "kkt_rel_start": kkt0, "kkt_rel_250": kkt1, "kkt_rel_end": kkt,
           "launches": counts,
           "operators_halpern_1000": operator_ms(mcf, 1000)}
    emit(rec)
    require(iters == 5000 or row["warm_converged"],
            f"pdhg_mcf_device stopped at {iters} unconverged")
    require(row["warm_finite"] and all(np.isfinite(kkt)),
            "pdhg_mcf_device output not finite")
    require(kkt[0] < kkt0[0], f"primal residual {kkt[0]} not below its "
            f"start {kkt0[0]}")
    require(sum(kkt) < sum(kkt1), f"KKT score {sum(kkt)} not below the "
            f"first chunk's {sum(kkt1)}")
    return counts


def phase_tnet_exact(scx, cert_objs):
    """batched_tnet_exact on main_64x256x256's batch, three ways; the f64
    batch goes in (float32 on the card, exact f64 on the host), and
    `cert_objs` are that phase's certified objectives."""
    import torch

    from smart_crossover_tpu_torch import bench

    s, d, M = bench.make_batch(64, 256, 256, seed=0)
    rec = {"phase": "tnet_exact_64x256x256", "seed": 0,
           "tolerance": {"obj_rtol": EXACT_RTOL}}
    runs = (("host", dict(engine="host")), ("auto", dict(engine="auto")),
            ("mega_cap100", dict(engine="mega", max_pivots=100)))
    for label, kw in runs:
        stats = {}
        torch.cuda.synchronize()
        scx.reset_kernel_launch_counts()
        t0 = time.perf_counter()
        X, obj, piv, opt = scx.batched_tnet_exact(
            s, d, M, reg=REG, sinkhorn_iters=SINKHORN_ITERS, stats=stats,
            **kw)
        wall = time.perf_counter() - t0
        counts = scx.kernel_launch_counts()
        rel = float(np.max(np.abs(obj - cert_objs) / np.abs(cert_objs)))
        rec[label] = {"n_optimal": int(opt.sum()), "wall_s": wall,
                      "host_share": stats["host_s"] / wall,
                      "median_pivots": float(np.median(piv)),
                      "max_pivots": int(piv.max()),
                      "max_rel_to_certified": rel, "launches": counts,
                      **stats}
        require(bool(opt.all()), f"{label}: {int(opt.sum())}/64 optimal")
        require(X.shape == (64, 256, 256) and bool(np.isfinite(X).all()),
                f"{label}: output malformed")
        require(rel <= EXACT_RTOL, f"{label} off the certificates: {rel}")
        require(counts["sinkhorn_fused"] > 0, f"{label}: K1 not launched")
        if stats["engine"] == "mega":
            require(counts["transport_simplex_mega"] > 0,
                    f"{label}: K2 not launched")
    emit(rec)
    require(rec["auto"]["engine"] == "mega",
            f"'auto' took {rec['auto']['engine']} at 64 x 256^2")
    require(rec["mega_cap100"]["repaired"] >= 1,
            "capped at 100 pivots, no instance was repaired")
    return {k: rec[k]["launches"] for k in ("host", "auto")}


ENGINE_RUNS = (("parent", 64, 256, 256, 0), ("anc", 64, 256, 256, 0),
               ("packed", 16, 784, 784, 1))
MASK_BUDGET_S = 60.0     # the mask oracle runs at 64 x 256^2 within this


def engine_exact(scx, engine, B, S, D, seed, cert_objs):
    """batched_tnet_exact(engine=...) on the first B instances of bench.py's
    batch (B0, S, D, seed): every instance optimal, at `cert_objs` (the
    main phase's certified objectives) to 1e-9, K1 launched once and K2
    never.  Returns its record."""
    import torch

    from smart_crossover_tpu_torch import bench

    s, d, M = (a[:B] for a in bench.make_batch(len(cert_objs), S, D,
                                               seed=seed))
    stats = {}
    torch.cuda.synchronize()
    scx.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    X, obj, piv, opt = scx.batched_tnet_exact(
        s, d, M, reg=REG, sinkhorn_iters=SINKHORN_ITERS, engine=engine,
        stats=stats)
    wall = time.perf_counter() - t0
    counts = scx.kernel_launch_counts()
    rel = float(np.max(np.abs(obj - cert_objs[:B]) / np.abs(cert_objs[:B])))
    rec = {"engine": engine, "shape": [B, S, D], "seed": seed,
           "n_optimal": int(opt.sum()), "wall_s": wall,
           "median_pivots": float(np.median(piv)), "max_pivots": int(
               piv.max()), "max_rel_to_certified": rel, "launches": counts,
           **stats}
    require(bool(opt.all()), f"{engine}: {int(opt.sum())}/{B} optimal")
    require(X.shape == (B, S, D) and bool(np.isfinite(X).all()),
            f"{engine}: output malformed")
    require(rel <= EXACT_RTOL, f"{engine} off the certificates: {rel}")
    require(counts["sinkhorn_fused"] == 1
            and counts["transport_simplex_mega"] == 0,
            f"{engine}: launches {counts}")
    return rec


def pivot_stage_ms(engines, B, S, D, seed, reps):
    """The pivot stage alone, each engine against K2 ('mega') on the same
    TNET warm start in this process: median synced ms and the pivots."""
    from smart_crossover_tpu_torch import bench
    from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
    from smart_crossover_tpu_torch.parallel import batched as pb

    s, d, M = to_cuda(*bench.make_batch(B, S, D, seed=seed))
    X0, _ = pb._warm_start(s, d, M, REG, SINKHORN_ITERS)
    Bm0 = boruvka_bipartite_mst((X0 > 1e-12).float())
    out = {}
    for e in ("mega",) + tuple(engines):
        res, ms, all_ms = sync_time(lambda: pb.ENGINES[e](
            X0, Bm0, M, max_pivots=MAX_PIVOTS), reps)
        out[e] = {"ms": ms, "all_ms": all_ms,
                  "max_pivots": int(res[2].max().item()),
                  "all_optimal": bool(res[3].all())}
    return out


def phase_device_engines(scx, cobj, cobj7):
    """The tensor pivot engines through batched_tnet_exact at bench.py's
    shapes (parent and anc at 64 x 256^2 seed 0, packed at 16 x 784^2
    seed 1; certified and repaired on the host), each engine's pivot stage
    timed against K2's on the same warm start, and the mask oracle at 64 x
    256^2, run again at a multiple of 8 instances that fits MASK_BUDGET_S
    where the full batch does not."""
    rec = {"phase": "device_engines", "tolerance": {"obj_rtol": EXACT_RTOL},
           "runs": []}
    for engine, B, S, D, seed in ENGINE_RUNS:
        rec["runs"].append(engine_exact(scx, engine, B, S, D, seed,
                                        cobj if S == 256 else cobj7))
    rec["pivot_stage_64x256x256"] = pivot_stage_ms(("parent", "anc"), 64,
                                                   256, 256, 0, 2)
    rec["pivot_stage_16x784x784"] = pivot_stage_ms(("packed",), 16, 784,
                                                   784, 1, 2)
    # the oracle at the full batch; past its budget, again at the largest
    # multiple of 8 that the time per instance says fits
    full = engine_exact(scx, "mask", 64, 256, 256, 0, cobj)
    rec["mask_cut"] = None
    if full["device_s"] <= MASK_BUDGET_S:
        rec["runs"].append(full)
    else:
        B = max(8, int(64 * MASK_BUDGET_S / full["device_s"]) // 8 * 8)
        rec["mask_over_budget"] = full
        rec["runs"].append(engine_exact(scx, "mask", B, 256, 256, 0, cobj))
        rec["mask_cut"] = (f"mask ran at {B} x 256^2, not 64: 64 took "
                           f"{full['device_s']:.1f} s")
    emit(rec)
    return rec


# ---------------------------------------------------------------- dense LP

def lp_single(m, n, seed):
    """A feasible, bounded equality LP (tests/test_pallas.py:156-161 with
    bounds [0, 1]): b = A x*, x* ~ U(0.2, 0.8), c = A'y* + |noise| + 0.05."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    b = A @ rng.uniform(0.2, 0.8, n)
    c = A.T @ rng.standard_normal(m) + np.abs(rng.standard_normal(n)) + 0.05
    return A, b, c, np.zeros(n), np.ones(n)


def lp_fleet(B, m, n, seed):
    """A fleet of equality LPs in [0, 1] (tests/test_pdhg_batched.py)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n))
    b = np.einsum("bmn,bn->bm", A, rng.uniform(0.1, 0.9, (B, n)))
    c = rng.standard_normal((B, n))
    return A, b, c, np.zeros((B, n)), np.ones((B, n))


def highs_obj(A, b, c, l, u):
    from scipy.optimize import linprog

    ref = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(l, u)), method="highs")
    require(ref.status == 0, f"HiGHS failed: {ref.message}")
    return float(ref.fun)


def rel_diff(a, b) -> float:
    """max |a - b| relative to 1 + max |b|."""
    return (a - b).abs().max().item() / (1.0 + b.abs().max().item())


def f64_check(fn, args, k, p, fields):
    """Distances of the kernel's (k) and the float32 plain version's (p)
    outputs to the plain version run in float64 on the same inputs, and
    the fields where the kernel is less accurate than F64_RATIO times the
    plain version's distance plus F64_FLOOR."""
    import torch

    q = fn(*[a.double() if torch.is_tensor(a) else a for a in args])
    out, worse = {}, []
    for i, nm in fields:
        dk = rel_diff(k[i].double(), q[i])
        dp = rel_diff(p[i].double(), q[i])
        out[f"{nm}_kernel_vs_f64"], out[f"{nm}_plain_vs_f64"] = dk, dp
        if not dk <= F64_RATIO * dp + F64_FLOOR:
            worse.append(nm)
    return out, worse


def pdhg_start(m, n, seed):
    """The single LP on the card and a PDHG start state."""
    import torch

    from smart_crossover_tpu_torch.solvers.pdhg import estimate_opnorm

    A, b, c, l, u = to_cuda(*lp_single(m, n, seed))
    x = torch.clamp(torch.zeros_like(c), l, u)
    y = torch.zeros_like(b)
    eq = torch.ones_like(b)
    return A, b, c, l, u, eq, x, y, A @ x, estimate_opnorm(A)


def chunk_work(m, n, vec_floats, iters=64):
    """PDHG iterations on an m x n A: two matrix-vector products (4mn
    operations) and about 16 vector operations per row and column each;
    A and `vec_floats` vector entries moved once."""
    return iters * (4 * m * n + 16 * (m + n)), 4 * (m * n + vec_floats)


def phase_k3(m, n, seed):
    import torch

    from smart_crossover_tpu_torch.ops.pdhg_chunk import (
        pdhg_chunk, pdhg_chunk_plain)

    from smart_crossover_tpu_torch.ops import pdhg_cluster as pc

    A, b, c, l, u, eq, x, y, Ax, opnorm = pdhg_start(m, n, seed)
    z = torch.zeros_like
    # a mid-run state: 256 plain iterations from the start
    st = pdhg_chunk_plain(A, b, c, l, u, eq, x, y, Ax, z(x), z(y), 0.0,
                          0.9 / opnorm, 1.0, 0, opnorm, chunk=256)
    args = (A, b, c, l, u, eq, *st, 1.0, 256, opnorm)
    k, ms, _ = sync_time(lambda: pdhg_chunk(*args), 20)
    lay = dict(pc.LAST_LAUNCH["pdhg_chunk"])
    p, plain_ms, _ = sync_time(lambda: pdhg_chunk_plain(*args), 3)
    again = pdhg_chunk(*args)
    torch.cuda.synchronize()
    names = ("x", "y", "Ax", "xs", "ys", "wsum", "eta")
    err = {f"rel_d{nm}": rel_diff(a, q) for nm, a, q in zip(names, k, p)}
    abs_err = max((a - q).abs().max().item() for a, q in zip(k[:3], p[:3]))
    identical = all(torch.equal(a, q) for a, q in zip(k, again))
    acc, worse = f64_check(pdhg_chunk_plain, args, k, p,
                           ((0, "x"), (1, "y")))
    emit({"phase": "k3_pdhg_chunk", "shape": [m, n], "chunk": 64,
          "k": 256, **err, **acc,
          "max_abs_dx_dy_dAx": abs_err, "repeat_bit_identical": identical,
          "eta_kernel": k[6].item(), "eta_plain": p[6].item(),
          "ms": ms, "ms_per_iteration": ms / 64, "plain_ms": plain_ms,
          **cluster_record(lay),
          "tolerance": {"rel": PDHG_RTOL, "eta_rel": ETA_RTOL,
                        "f64_ratio": F64_RATIO}})
    require(all(np.isfinite(list(err.values()))), "k3 produced non-finite")
    require(max(v for nm, v in err.items() if nm != "rel_deta") <= PDHG_RTOL
            and err["rel_deta"] <= ETA_RTOL, f"k3 differs from plain: {err}")
    require(not worse, f"k3 less accurate than plain on {worse}: {acc}")
    require(identical, "k3 repeat launch not bit-identical")
    return summary("pdhg_chunk", "smart_crossover_tpu_torch/csrc/"
                   "pdhg_cluster.cu",
                   "smart_crossover_tpu/ops/pdhg_pallas.py:31", abs_err, ms,
                   plain_ms, chunk_work(m, n, 8 * m + 7 * n))


def phase_k4(m, n, seed):
    import torch

    from smart_crossover_tpu_torch.ops import pdhg_cluster as pc
    from smart_crossover_tpu_torch.ops.pdhg_chunk import (
        halpern_chunk, halpern_chunk_plain)

    A, b, c, l, u, eq, x, y, Ax, opnorm = pdhg_start(m, n, seed)
    step = 0.99 / opnorm
    # anchors at the start, the iterate 128 plain iterations on
    x1, y1, Ax1, _ = halpern_chunk_plain(A, b, c, l, u, eq, x, y, Ax, x, y,
                                         Ax, 1.0, 0.0, step, chunk=128)
    args = (A, b, c, l, u, eq, x1, y1, Ax1, x, y, Ax, 1.0, 128.0, step)
    k, ms, _ = sync_time(lambda: halpern_chunk(*args), 20)
    lay = dict(pc.LAST_LAUNCH["halpern_chunk"])
    p, plain_ms, _ = sync_time(lambda: halpern_chunk_plain(*args), 3)
    again = halpern_chunk(*args)
    torch.cuda.synchronize()
    err = {f"rel_d{nm}": rel_diff(a, q)
           for nm, a, q in zip(("x", "y", "Ax"), k, p)}
    abs_err = max((a - q).abs().max().item() for a, q in zip(k[:3], p[:3]))
    identical = all(torch.equal(a, q) for a, q in zip(k, again))
    acc, worse = f64_check(halpern_chunk_plain, args, k, p,
                           ((0, "x"), (1, "y")))
    emit({"phase": "k4_halpern_chunk", "shape": [m, n], "chunk": 64,
          "k_in": 128, "k_out_kernel": k[3].item(),
          "k_out_plain": float(p[3]),
          **err, **acc, "max_abs_dx_dy_dAx": abs_err,
          "repeat_bit_identical": identical, "ms": ms,
          "ms_per_iteration": ms / 64, "plain_ms": plain_ms,
          **cluster_record(lay),
          "tolerance": {"rel": PDHG_RTOL, "f64_ratio": F64_RATIO}})
    require(all(np.isfinite(list(err.values()))), "k4 produced non-finite")
    require(max(err.values()) <= PDHG_RTOL,
            f"k4 differs from plain: {err}")
    require(not worse, f"k4 less accurate than plain on {worse}: {acc}")
    require(k[3].item() == float(p[3]) == 192.0, "k4 returned a wrong k")
    require(identical, "k4 repeat launch not bit-identical")
    return summary("halpern_chunk", "smart_crossover_tpu_torch/csrc/"
                   "pdhg_cluster.cu",
                   "smart_crossover_tpu/ops/pdhg_pallas.py:183", abs_err, ms,
                   plain_ms, chunk_work(m, n, 8 * m + 6 * n))


def cluster_record(lay):
    """The cluster plan of a PDHG kernel's launch, for its phase record."""
    return {"cluster_size": lay["cluster_size"],
            "max_active_clusters": lay["max_active_clusters"],
            "waves": lay["waves"], "rows_in_smem": lay["rows_in_smem"],
            "n_res": lay["n_res"], "a_in_smem": lay["a_in_smem"],
            "smem_bytes_per_block": lay["smem_bytes"],
            "scatter_combine": lay["scatter"]}


def k5_at(B, m, n, seed, iters, reps, plain_reps):
    """The fleet kernel on chip_smoke's fleet (B, m, n, seed) against its
    plain version: 50 iterations against the float32 and float64 plain
    runs, `iters` iterations on the step-weighted averages.  Returns the
    50-iteration error and the kernel's and plain ms at `iters`."""
    import torch

    from smart_crossover_tpu_torch.ops import pdhg_cluster as pc
    from smart_crossover_tpu_torch.solvers.pdhg_batched import (
        _opnorms, pdhg_batched_cuda, pdhg_fixed_batched_plain)

    A, b, c, l, u = to_cuda(*lp_fleet(B, m, n, seed))
    opn = _opnorms(A)
    x0 = torch.clamp(torch.zeros_like(c), l, u)
    y0 = torch.zeros_like(b)
    names = ("x", "y", "x_avg", "y_avg")
    short_k = pdhg_batched_cuda(A, b, c, l, u, opn, 50)
    short_p = pdhg_fixed_batched_plain(A, b, c, l, u, opn, x0, y0, 50)
    short = {f"rel_d{nm}_50": rel_diff(a, q)
             for nm, a, q in zip(names, short_k, short_p)}
    acc, worse = f64_check(pdhg_fixed_batched_plain,
                           (A, b, c, l, u, opn, x0, y0, 50), short_k,
                           short_p, ((0, "x_50"), (1, "y_50")))
    k, ms, all_ms = sync_time(lambda: pdhg_batched_cuda(A, b, c, l, u, opn,
                                                        iters), reps)
    lay = dict(pc.LAST_LAUNCH["pdhg_batched"])
    p, plain_ms, _ = sync_time(lambda: pdhg_fixed_batched_plain(
        A, b, c, l, u, opn, x0, y0, iters), plain_reps)
    again = pdhg_batched_cuda(A, b, c, l, u, opn, iters)
    torch.cuda.synchronize()
    long = {f"rel_d{nm}_{iters}": rel_diff(a, q)
            for nm, a, q in zip(names, k, p)}
    abs_err = max((a - q).abs().max().item()
                  for a, q in zip(short_k, short_p))
    identical = all(torch.equal(a, q) for a, q in zip(k, again))
    emit({"phase": "k5_pdhg_batched", "shape": [B, m, n], "seed": seed,
          "iters": iters, **short, **long, **acc,
          "max_abs_err_50": abs_err, "repeat_bit_identical": identical,
          "ms": ms, "all_ms": all_ms, "ms_per_iteration": ms / iters,
          "plain_ms": plain_ms, **cluster_record(lay),
          "tolerance": {"rel_50": PDHG_RTOL, "f64_ratio": F64_RATIO,
                        f"rel_avg_{iters}": K5_LONG_AVG_RTOL}})
    vals = list(short.values()) + list(long.values())
    require(all(np.isfinite(vals)), "k5 produced non-finite")
    require(max(short.values()) <= PDHG_RTOL,
            f"k5 differs from plain at 50 iterations: {short}")
    require(not worse, f"k5 less accurate than plain on {worse}: {acc}")
    require(long[f"rel_dx_avg_{iters}"] <= K5_LONG_AVG_RTOL
            and long[f"rel_dy_avg_{iters}"] <= K5_LONG_AVG_RTOL,
            f"k5 averages differ from plain at {iters}: {long}")
    require(identical, "k5 repeat launch not bit-identical")
    return abs_err, ms, plain_ms


def phase_k5():
    err, ms, plain_ms = k5_at(32, 64, 256, 5, 2000, 5, 2)
    err_b, ms_b, plain_b = k5_at(64, 256, 512, 6, 4000, 3, 1)
    out = summary("pdhg_batched", "smart_crossover_tpu_torch/csrc/"
                  "pdhg_cluster.cu",
                  "smart_crossover_tpu/solvers/pdhg_batched.py:100",
                  max(err, err_b), ms, plain_ms,
                  fleet_work(32, 64, 256, 2000))
    out.update(ms_64x256x512=ms_b, plain_ms_64x256x512=plain_b)
    return out


def fleet_work(B, m, n, iters):
    """B instances of `iters` PDHG iterations; A, b, c, l, u and the norms
    in, x, y and their averages out, once."""
    ops, _ = chunk_work(m, n, 0, iters)
    return B * ops, 4 * B * (m * n + 3 * m + 5 * n + 1)


def phase_lp_single(scx, m, n, seed):
    """pdhg_solve on the card in both modes, each crossed over on the host
    to an exact vertex."""
    import torch

    from smart_crossover_tpu_torch.solvers.simplex import primal_simplex
    from smart_crossover_tpu_torch.solvers.solving import (
        _crossover_statuses)

    A, b, c, l, u = lp_single(m, n, seed)
    t0 = time.perf_counter()
    ref = highs_obj(A, b, c, l, u)
    highs_s = time.perf_counter() - t0
    counts = {}
    def cross(x):
        t0 = time.perf_counter()
        vx = primal_simplex(A, b, c, l, u,
                            vstatus=_crossover_statuses(x, l, u))
        return vx, time.perf_counter() - t0

    for mode, kname in (("adaptive", "pdhg_chunk"),
                        ("halpern", "halpern_chunk")):
        # the host polish's share: the same solve without it
        raw = scx.pdhg_solve(A, b, c, l, u, tol=1e-4, max_iters=20000,
                             mode=mode, polish=False, device=DEVICE)
        vraw, raw_cross_s = cross(raw.x)
        torch.cuda.synchronize()
        scx.reset_kernel_launch_counts()
        # the f64 LP goes in; the iterations run in float32 on the card
        res = scx.pdhg_solve(A, b, c, l, u, tol=1e-4, max_iters=20000,
                             mode=mode, device=DEVICE)
        counts[mode] = scx.kernel_launch_counts()
        vx, cross_s = cross(res.x)
        rel = abs(vx.obj_val - ref) / max(1.0, abs(ref))
        emit({"phase": f"main_lp_single_{m}x{n}", "mode": mode, "seed": seed,
              "pdhg_status": res.status, "pdhg_iters": res.iter_count,
              "primal_residual": res.primal_residual,
              "dual_residual": res.dual_residual, "gap": res.gap,
              "pdhg_obj": res.obj_val,
              "pdhg_ms": res.runtime.total_seconds() * 1e3,
              "crossover_status": vx.status,
              "crossover_pivots": vx.iter_count, "crossover_s": cross_s,
              "vertex_obj": vx.obj_val, "highs_obj": ref, "highs_s": highs_s,
              "vertex_rel_to_highs": rel,
              "no_polish": {"pdhg_ms": raw.runtime.total_seconds() * 1e3,
                            "pdhg_iters": raw.iter_count,
                            "max_kkt": max(raw.primal_residual,
                                           raw.dual_residual, raw.gap),
                            "crossover_pivots": vraw.iter_count,
                            "crossover_s": raw_cross_s,
                            "vertex_obj": vraw.obj_val},
              "launches": counts[mode]})
        require(counts[mode][kname] > 0,
                f"{kname} was not launched by pdhg_solve({mode})")
        require(bool(np.isfinite(res.x).all() and np.isfinite(res.y).all()),
                f"pdhg_solve({mode}) warm start not finite")
        require(vx.status == "OPTIMAL", f"crossover ({mode}): {vx.status}")
        require(rel <= LP_OBJ_RTOL, f"vertex ({mode}) off HiGHS: {rel}")
    return counts, ref


def phase_lp_fleet(scx, B, m, n, seed, reps, n_cross=None):
    """batched_lp_crossover on the fleet lp_fleet(B, m, n, seed): K5's warm
    start, then the host crossover, every vertex equal to HiGHS; the warm
    start alone timed on all B.  With ``n_cross`` the crossover runs on the
    first n_cross instances only (the host crossover dominates the phase,
    and a host that is slow on the day doubles it)."""
    import torch

    A, b, c, l, u = lp_fleet(B, m, n, seed)
    dev = to_cuda(A, b, c, l, u)
    B_x = B if n_cross is None else n_cross
    A, b, c, l, u = A[:B_x], b[:B_x], c[:B_x], l[:B_x], u[:B_x]
    torch.cuda.synchronize()
    scx.reset_kernel_launch_counts()
    # the f64 fleet goes in: float32 warm start on the card, f64 crossover
    out = scx.batched_lp_crossover(A, b, c, l, u, warm_engine="pdhg",
                                   pdhg_iters=4000, device=DEVICE)
    counts = scx.kernel_launch_counts()
    _, dev_ms, all_ms = sync_time(lambda: scx.pdhg_dense_batched(
        *dev, iters=4000), reps)
    t0 = time.perf_counter()
    ref = np.array([highs_obj(A[i], b[i], c[i], l[i], u[i])
                    for i in range(B_x)])
    highs_s = time.perf_counter() - t0
    rel = np.abs(out["obj"] - ref) / np.maximum(1.0, np.abs(ref))
    total_s = out["warm_seconds"] + out["crossover_seconds"]
    rec = {"phase": f"main_lp_fleet_{B}x{m}x{n}", "seed": seed,
          "pdhg_iters": 4000, "n_optimal": int(out["optimal"].sum()),
          "batch": B, "crossed_over": B_x,
          "max_rel_to_highs": float(rel.max()),
          "warm_seconds": out["warm_seconds"],
          "pdhg_device_ms_median": dev_ms, "pdhg_device_ms": all_ms,
          "host_crossover_s": out["crossover_seconds"],
          "median_pivots": float(np.median(out["pivots"])),
          "max_pivots": int(out["pivots"].max()),
          "exact_vertices_per_s": B_x / total_s, "highs_s": highs_s,
          "launches": counts}
    emit(rec)
    require(bool(out["optimal"].all()),
            f"only {int(out['optimal'].sum())}/{B_x} optimal")
    require(bool(rel.max() <= LP_OBJ_RTOL), f"fleet off HiGHS: {rel.max()}")
    require(bool(np.isfinite(out["x_bar"]).all()), "fleet warm start not finite")
    require(counts["pdhg_batched"] > 0, f"K5 not launched: {counts}")
    return counts, dev_ms, rec


# ---------------------------------------------------------- LP front door

BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke")
PERTURB_OBJ_RTOL = 1e-8     # exact vertex vs HiGHS
FRONT_DOOR_OBJ_RTOL = 1e-3  # the first-order point (tol 1e-4) vs HiGHS
PROJ_RTOL = 1e-4            # the float32 projector vs the host f64 one
PROJ_RESIDUAL = 1e-3        # ||Y p|| / ||Y v|| of the float32 projector


def highs_lp(lp):
    """HiGHS's objective on a GeneralLP (offset included) and its
    seconds."""
    import scipy.sparse as sp
    from scipy.optimize import linprog

    A = sp.csr_matrix(lp.A)
    eq = lp.sense == "="
    t0 = time.perf_counter()
    ref = linprog(lp.c, A_eq=A[eq], b_eq=lp.b[eq],
                  A_ub=A[~eq] if (~eq).any() else None,
                  b_ub=lp.b[~eq] if (~eq).any() else None,
                  bounds=np.stack([lp.l, lp.u], 1), method="highs")
    require(ref.status == 0, f"HiGHS failed: {ref.message}")
    return float(ref.fun) + lp.obj_offset, time.perf_counter() - t0


def rel_to(a, ref) -> float:
    return abs(a - ref) / max(1.0, abs(ref))


def phase_lp_front_door(scx, m, n, seed, ref):
    """solve_lp(method="first_order") on chip_smoke's single LP: the
    facade, pdhg_general_lp, pdhg_solve and K3 on the card.  `ref` is
    HiGHS's objective (main_lp_single's)."""
    import torch

    A, b, c, l, u = lp_single(m, n, seed)
    lp = scx.GeneralLP(A=A, b=b, c=c, l=l, u=u, sense=np.full(m, "="))
    settings = scx.SolverSettings(barrierTol=1e-4, fomMode="adaptive")
    torch.cuda.synchronize()
    scx.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    out = scx.solve_lp(lp, method="first_order", settings=settings)
    wall = time.perf_counter() - t0
    counts = scx.kernel_launch_counts()
    rel = rel_to(out.obj_val, ref)
    emit({"phase": f"lp_front_door_{m}x{n}", "seed": seed,
          "method": "first_order", "fomMode": "adaptive", "tol": 1e-4,
          "status": out.status, "pdhg_iters": out.bar_iter_count,
          "obj": out.obj_val, "highs_obj": ref, "rel_to_highs": rel,
          "wall_s": wall, "launches": counts,
          "tolerance": {"obj_rtol": FRONT_DOOR_OBJ_RTOL}})
    require(out.status == "OPTIMAL", f"front door first_order: {out.status}")
    require(bool(np.isfinite(out.x).all()) and out.x.shape == (n,),
            "front door first_order output malformed")
    require(counts["pdhg_chunk"] > 0, f"K3 not launched: {counts}")
    require(rel <= FRONT_DOOR_OBJ_RTOL, f"front door off HiGHS: {rel}")
    return counts


class _Records:
    """Collects the perturbation crossover's log records (the attempts,
    the fixed counts and how it finished), off the console."""

    def __init__(self, name):
        import logging

        self.messages = []
        self.logger = logging.getLogger(name)
        self.handler = logging.Handler()
        self.handler.emit = lambda r: self.messages.append(r.getMessage())

    def __enter__(self):
        import logging

        self.level, self.propagate = self.logger.level, self.logger.propagate
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)
        self.logger.propagate = self.propagate


def solve_log(path):
    """The facade's log file as dicts, one per internal solve, in order."""
    rows = []
    for line in open(path):
        parts = line.split()
        row = {"method": parts[2]}
        for kv in parts[3:]:
            k, _, v = kv.partition("=")
            row[k] = v
        rows.append(row)
    return rows


def perturb_run(scx, lp, tag):
    """solve_lp(method="barrier_perturb") with its stage record: the first
    barrier's iterations and seconds, the attempts, the fixed counts, how
    it finished and the finishing pivots.  The record is read from the
    crossover's log messages and the facade's log file; a parse that
    finds no barrier row, no attempt, or not exactly one way of finishing
    fails the phase."""
    import re

    os.makedirs(BUILD, exist_ok=True)
    log = os.path.join(BUILD, f"{tag}.log")
    if os.path.exists(log):
        os.remove(log)
    with _Records("smart_crossover_tpu_torch.lp_methods.algorithms") as rec:
        t0 = time.perf_counter()
        out = scx.solve_lp(lp, method="barrier_perturb",
                           settings=scx.SolverSettings(log_file=log))
        wall = time.perf_counter() - t0
    rows = solve_log(log)
    msgs = rec.messages
    attempts = sum(msg.startswith("*** building and solving a perturbed")
                   for msg in msgs)
    fixed = [list(map(int, re.findall(r"\d+", msg)))
             for msg in msgs if msg.startswith("  fixed variables")]
    simplex = [r for r in rows if r["method"] == "primal_simplex"]
    ways = {"direct": any("found directly" in msg for msg in msgs),
            "fallback": any("perturbation failed" in msg for msg in msgs)}
    # the finishing simplex from the perturbed vertex logs no message of
    # its own: it is the primal simplex row of a run that did neither
    ways["finishing_simplex"] = bool(simplex) and not any(ways.values())
    finish = [k for k, hit in ways.items() if hit]
    require(bool(rows) and rows[0]["method"] == "barrier"
            and "bar_iter_count" in rows[0],
            f"{tag}: no barrier row in the facade's log: {rows[:1]}")
    require(1 <= attempts <= 8 and len(fixed) == attempts,
            f"{tag}: {attempts} attempts, {len(fixed)} fixed-count records")
    require(len(finish) == 1, f"{tag}: ways of finishing found: {finish}")
    require((finish[0] == "direct") == (not simplex),
            f"{tag}: finished {finish[0]} with {len(simplex)} simplex rows")
    return out, {
        "status": out.status, "obj": out.obj_val, "wall_s": wall,
        "barrier_iters": int(rows[0]["bar_iter_count"]),
        "barrier_s": float(rows[0]["runtime"].rstrip("s")),
        "attempts": attempts,
        "fixed_variables_constraints_per_attempt": fixed,
        "finish": finish[0],
        "finishing_pivots": int(simplex[-1]["iter_count"]) if simplex else 0,
        "total_pivots": out.iter_count,
        "total_barrier_iters": out.bar_iter_count}


def phase_perturb(scx, m, n, seed):
    """The perturbation crossover on random_sparse_lp(m, n, seed), then the
    device projector on the product get_projector_Xc projects with."""
    import scipy.sparse as sp
    import torch

    from smart_crossover_tpu_torch.data import random_sparse_lp
    from smart_crossover_tpu_torch.lp_methods.algorithms import (
        get_x_perturb_val)
    from smart_crossover_tpu_torch.parameters import PERTURB_THRESHOLD
    from smart_crossover_tpu_torch.solvers.projection import (
        apply_projector, apply_projector_torch)

    lp = random_sparse_lp(m=m, n=n, seed=seed)
    ref, highs_s = highs_lp(lp)
    out, rec = perturb_run(scx, lp, f"perturb_{m}x{n}")
    rel = rel_to(out.obj_val, ref)
    # perturb_c's x: min(x - l, u - x) at the barrier point, floored at
    # 1e-6, free columns at 1
    x = get_x_perturb_val(lp, out.x_bar)
    x[x < PERTURB_THRESHOLD] = 1e-6
    x[lp.get_free_ind()] = 1.0
    xx = lp.get_standard_x(x)
    Y = lp.get_standard_A() @ sp.diags(xx)
    v = xx * lp.get_standard_c()
    t0 = time.perf_counter()
    p_host = apply_projector(Y, v)
    host_ms = (time.perf_counter() - t0) * 1e3
    Yd = Y.toarray()
    p_dev, dev_ms, dev_all = sync_time(lambda: apply_projector_torch(Yd, v),
                                       3)
    p_dev = p_dev.double().cpu().numpy()
    proj_rel = float(np.linalg.norm(p_dev - p_host)
                     / np.linalg.norm(p_host))
    Yv = np.linalg.norm(Y @ v)
    resid = float(np.linalg.norm(Y @ p_dev) / Yv)
    emit({"phase": f"perturb_{m}x{n}", "seed": seed, "nnz": int(lp.A.nnz),
          "le_rows": int((lp.sense == "<").sum()),
          "free_columns": int(lp.get_free_ind().size), **rec,
          "highs_obj": ref, "highs_s": highs_s, "rel_to_highs": rel,
          "projector": {"shape": list(Y.shape), "rel_to_host": proj_rel,
                        "residual_rel": resid,
                        "host_residual_rel": float(
                            np.linalg.norm(Y @ p_host) / Yv),
                        "card_ms": dev_ms, "card_all_ms": dev_all,
                        "host_ms": host_ms},
          "tolerance": {"obj_rtol": PERTURB_OBJ_RTOL, "proj_rtol": PROJ_RTOL,
                        "proj_residual": PROJ_RESIDUAL}})
    require(out.status == "OPTIMAL", f"barrier_perturb: {out.status}")
    require(rel <= PERTURB_OBJ_RTOL, f"barrier_perturb off HiGHS: {rel}")
    require(bool(np.isfinite(p_dev).all()), "card projector not finite")
    require(proj_rel <= PROJ_RTOL, f"card projector off host: {proj_rel}")
    require(resid <= PROJ_RESIDUAL, f"card projector residual: {resid}")


def phase_cli(scx, m, n, seed):
    """The CLI on an .mps file the port writes, then solve_lp's barrier
    crossover against the perturbation crossover on the LP read back."""
    import re

    from smart_crossover_tpu_torch.data import (
        random_sparse_lp, read_mps, write_mps)

    os.makedirs(BUILD, exist_ok=True)
    path = os.path.join(BUILD, f"lp_{m}x{n}_seed{seed}.mps")
    write_mps(random_sparse_lp(m=m, n=n, seed=seed), path)
    # the CLI runs in its own process while this one solves the LP read
    # back (its wall overlaps the in-process solves)
    cli = start([sys.executable, "-m", "smart_crossover_tpu_torch", "solve",
                 path, "--method", "barrier_perturb"], timeout=900)
    lp = read_mps(path)
    ref, highs_s = highs_lp(lp)
    t0 = time.perf_counter()
    bar = scx.solve_lp(lp, method="barrier")
    bar_s = time.perf_counter() - t0
    ptb, rec = perturb_run(scx, lp, f"cli_{m}x{n}")
    cli_rc, cli_out, cli_err, cli_s = cli()
    found = re.search(r"obj_val=(\S+),", cli_out)
    cli_obj = float(found.group(1)) if found else None
    rec_out = {"phase": f"cli_mps_{m}x{n}", "seed": seed,
               "file": os.path.relpath(path), "cli_rc": cli_rc,
               "cli_stdout": cli_out.strip()[-400:], "cli_wall_s": cli_s,
               "cli_obj": cli_obj, "highs_obj": ref, "highs_s": highs_s,
               # the CLI's wall and the in-process walls overlap
               "overlapped": True,
               "barrier": {"status": bar.status, "wall_s": bar_s,
                           "finishing_pivots": bar.iter_count,
                           "barrier_iters": bar.bar_iter_count,
                           "rel_to_highs": rel_to(bar.obj_val, ref)},
               "barrier_perturb": {**rec,
                                   "rel_to_highs": rel_to(ptb.obj_val, ref)},
               "tolerance": {"obj_rtol": PERTURB_OBJ_RTOL}}
    emit(rec_out)
    require(cli_rc == 0, f"CLI exited {cli_rc}: {cli_err.strip()[-600:]}")
    require(cli_obj is not None and rel_to(cli_obj, ref) <= PERTURB_OBJ_RTOL,
            f"CLI objective {cli_obj} off HiGHS {ref}")
    require(bar.status == ptb.status == "OPTIMAL",
            f"barrier {bar.status}, barrier_perturb {ptb.status}")
    require(rel_to(bar.obj_val, ref) <= PERTURB_OBJ_RTOL
            and rel_to(ptb.obj_val, ref) <= PERTURB_OBJ_RTOL,
            "an in-process vertex is off HiGHS")


def phase_solve_ot(scx, cert_obj):
    """solve_ot on instance 0 of the 16 x 784^2 batch (seed 1); `cert_obj`
    is main_16x784x784's certified objective of that instance: 'sinkhorn'
    (K1 once), 'device_simplex' with the default engine 'parent' (K1
    once, K2 never) and with 'mega' (K1 and K2 once each)."""
    import torch

    from smart_crossover_tpu_torch import bench

    s, d, M = (a[0] for a in bench.make_batch(16, 784, 784, seed=1))
    ot = scx.OptTransport(s=s, d=d, M=M)
    rec = {"phase": "solve_ot_784", "seed": 1, "instance": 0,
           "certified_obj": cert_obj,
           "tolerance": {"obj_rtol": EXACT_RTOL}}
    counts = {}
    runs = (("sinkhorn", "sinkhorn", scx.SolverSettings()),
            ("device_simplex", "device_simplex", scx.SolverSettings()),
            ("device_simplex_mega", "device_simplex",
             scx.SolverSettings(deviceSimplexEngine="mega")))
    for label, method, settings in runs:
        torch.cuda.synchronize()
        scx.reset_kernel_launch_counts()
        t0 = time.perf_counter()
        out = scx.solve_ot(ot, method=method, settings=settings)
        wall = time.perf_counter() - t0
        counts[label] = scx.kernel_launch_counts()
        rec[label] = {"status": out.status, "obj": out.obj_val,
                      "engine": settings.deviceSimplexEngine,
                      "rel_to_certified": abs(out.obj_val - cert_obj)
                      / abs(cert_obj), "wall_s": wall,
                      "iter_count": out.iter_count,
                      "launches": counts[label]}
        require(out.x is not None and out.x.shape == (M.size,)
                and bool(np.isfinite(out.x).all()),
                f"solve_ot({label}) output malformed")
    emit(rec)
    sk = counts["sinkhorn"]
    require(rec["sinkhorn"]["status"] == "APPROXIMATE",
            f"solve_ot(sinkhorn): {rec['sinkhorn']['status']}")
    require(sk["sinkhorn_fused"] == 1, f"sinkhorn launched K1: {sk}")
    for label, k2 in (("device_simplex", 0), ("device_simplex_mega", 1)):
        ds = counts[label]
        require(rec[label]["status"] == "OPTIMAL",
                f"solve_ot({label}): {rec[label]['status']}")
        require(rec[label]["rel_to_certified"] <= EXACT_RTOL,
                f"solve_ot({label}) off the certified objective")
        require(ds["sinkhorn_fused"] == 1
                and ds["transport_simplex_mega"] == k2,
                f"{label} launches: {ds}")
    return counts



# ------------------------------------------------------ IPM device stages

IPM_CERT_TOL = 1e-8     # ipm_big's host f64 certificate (residual, gap)
IPM_FLEET = (64, 256, 512)      # scripts/bench_fleet_ipm.py's default
IPM_BIG = (5000, 15000)         # scripts/bench_ipm_big.py's default
NE_OFFLOAD_LP = (1200, 4800, 2)  # random_sparse_lp(m, n, seed)
# the float32 device stage on the card against the same call on the CPU in
# float64 (the stopping rule given to both): float32 Cholesky at cond ~ 1/mu
IPM_DEV_OBJ_RTOL = 1e-3         # |obj_card - obj_cpu| / (1 + |obj_cpu|)
IPM_DEV_RES_RTOL = 1e-3         # |A x_card - b|_inf / (1 + |b|_inf)
IPM_DEV_ITERS_APART = 2         # per instance, card against CPU
IPM_DEV_X_ATOL = 1e-2           # max |x_card - x_cpu| (boxes [0, 1]), held
#                                 where the stage stops at mu_exit 1e-4: at
#                                 1e-7 float32 drifts along a degenerate
#                                 optimal face (0.042 at 32x64x256, H100)


def ipm_fleet_lps(B, m, n, seed=0):
    """scripts/bench_fleet_ipm.py::make_fleet (copied: that script imports
    JAX)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n)) / np.sqrt(m)
    xs = rng.uniform(0.2, 0.8, (B, n))
    b = np.einsum("bmn,bn->bm", A, xs)
    c = rng.standard_normal((B, n))
    return A, b, c, np.zeros((B, n)), np.ones((B, n))


def ipm_big_lp(m, n, seed=0):
    """scripts/bench_ipm_big.py::make_lp (copied: that script imports
    JAX)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x0 = rng.uniform(0.2, 0.8, n)
    b = A @ x0
    margin = np.abs(rng.standard_normal(n)) * 0.1 + 0.01
    c = A.T @ rng.standard_normal(m) + margin
    return A, b, c, np.zeros(n), np.ones(n)


def lp_certificate(A, b, c, l, u, x, y):
    """Host f64 certificate of a primal-dual pair, infinite and free
    bounds allowed (``bench_ipm_stair.lp_certificate``, also the staircase
    row's): the relative primal residual, the bound violation, the
    relative dual infeasibility (reduced costs facing an infinite bound),
    the relative gap, and the columns sitting on the IPMs' wide box."""
    from smart_crossover_tpu_torch.bench_ipm_stair import lp_certificate

    return lp_certificate(A, b, c, l, u, x, y)


def ne_record(stats):
    return None if stats is None else {
        k: (len(v) if k == "fails" else v) for k, v in stats.items()}


def synced_s(fn):
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_stage_vs_cpu(A, b, c, l, u, hold_x=True, **kw):
    """ipm_dense_batched on the card in float32 against the same call on
    the CPU in float64: the device stage's own check, since every later
    stage (crossover, host endgame) is exact and would hide a wrong step.
    Holds objectives, the card's primal residual, per-instance iterations
    and, with ``hold_x``, x.  Returns the card's output, its synced
    seconds and the record."""
    import torch

    from smart_crossover_tpu_torch.solvers.ipm_batched import (
        ipm_dense_batched)

    dev, dev_s = synced_s(lambda: ipm_dense_batched(A, b, c, l, u,
                                                    device=DEVICE, **kw))
    cpu = ipm_dense_batched(A, b, c, l, u, device="cpu", **kw)
    go, wo = dev["obj_val"].double().cpu(), cpu["obj_val"]
    obj_rel = ((go - wo).abs() / (1 + wo.abs())).max().item()
    x_card = dev["x"].double().cpu()
    x_err = (x_card - cpu["x"]).abs().max().item()
    res = np.abs(np.einsum("bmn,bn->bm", A, x_card.numpy()) - b).max(1)
    res_rel = float((res / (1 + np.abs(b).max(1))).max())
    it_d, it_c = dev["iters"].cpu().long(), cpu["iters"].long()
    apart = int((it_d - it_c).abs().max())
    rec = {"kw": kw, "obj_max_rel": obj_rel, "x_max_abs": x_err,
           "x_held": hold_x, "card_primal_res_rel": res_rel,
           "iters_card_median": float(it_d.double().median()),
           "iters_cpu_f64_median": float(it_c.double().median()),
           "iters_equal": int((it_d == it_c).sum()),
           "iters_max_abs_diff": apart,
           "converged_card": int(dev["converged"].sum()),
           "converged_cpu_f64": int(cpu["converged"].sum()),
           "obj_rtol": IPM_DEV_OBJ_RTOL, "res_rtol": IPM_DEV_RES_RTOL,
           "x_atol": IPM_DEV_X_ATOL}
    shape = "x".join(map(str, A.shape))
    require(dev["x"].is_cuda and dev["x"].dtype == torch.float32
            and bool(dev["x"].isfinite().all()),
            f"device stage {shape}: not a finite float32 card iterate")
    require(obj_rel <= IPM_DEV_OBJ_RTOL,
            f"device stage {shape}: objective off the CPU f64 run: {rec}")
    require(res_rel <= IPM_DEV_RES_RTOL,
            f"device stage {shape}: card primal residual: {rec}")
    require(apart <= IPM_DEV_ITERS_APART,
            f"device stage {shape}: iterations off the CPU f64 run: {rec}")
    require(not hold_x or x_err <= IPM_DEV_X_ATOL,
            f"device stage {shape}: x off the CPU f64 run: {rec}")
    return dev, dev_s, rec


def phase_ipm_device(scx, fleet_rec, big=IPM_BIG, ipm_fleet_shape=IPM_FLEET,
                     ne_lp=NE_OFFLOAD_LP, cross_fleet=(32, 64, 256, 5)):
    """The IPM device stages: the fleet crossover's IPM warm engines (on
    main_lp_fleet_32x64x256's instances, beside its 'pdhg' figures), the
    fleet barrier ipm_fleet, the single large LP ipm_big with its device
    endgame (both DeviceNE routes), and the host IPM's NE offload.  The
    float32 device stage of each fleet is held against the same call on
    the CPU in float64.  No kernel of the port runs here: batched matmuls
    and Cholesky."""
    from smart_crossover_tpu_torch.data import random_sparse_lp
    from smart_crossover_tpu_torch.solvers import ipm_fleet as fleet_mod
    from smart_crossover_tpu_torch.solvers import ne_device, ne_offload
    from smart_crossover_tpu_torch.solvers.ipm import ipm_solve

    t_phase = time.perf_counter()
    scx.reset_kernel_launch_counts()
    rec = {"phase": "ipm_device"}

    # fleet crossover: the default engine 'ipm' (no engine given) and
    # 'ipm_refined', every vertex equal to HiGHS
    B, m, n, seed = cross_fleet
    A, b, c, l, u = lp_fleet(B, m, n, seed)
    ref = np.array([highs_obj(A[i], b[i], c[i], l[i], u[i])
                    for i in range(B)])
    # the 'ipm' engine's device call, float32 mu_exit given to both runs
    _, _, stage = device_stage_vs_cpu(A, b, c, l, u, hold_x=False,
                                      tol=1e-8, max_iters=60, mu_exit=1e-7)
    rec[f"device_stage_vs_cpu_f64_{B}x{m}x{n}"] = stage
    cross = {}
    for engine in ("ipm", "ipm_refined"):
        kw = {} if engine == "ipm" else {"warm_engine": engine}
        out = scx.batched_lp_crossover(A, b, c, l, u, device=DEVICE, **kw)
        rel = np.abs(out["obj"] - ref) / np.maximum(1.0, np.abs(ref))
        it = np.asarray(out["device_iters"])
        cross[engine] = {
            "n_optimal": int(out["optimal"].sum()),
            "max_rel_to_highs": float(rel.max()),
            "warm_seconds": out["warm_seconds"],
            "host_crossover_s": out["crossover_seconds"],
            "median_pivots": float(np.median(out["pivots"])),
            "max_pivots": int(out["pivots"].max()),
            "device_iters_median": float(np.median(it)),
            "device_iters_max": int(it.max()),
            "ipm_converged": int(np.sum(out["ipm_converged"])),
            "exact_vertices_per_s": B / (out["warm_seconds"]
                                         + out["crossover_seconds"])}
        require(bool(out["optimal"].all()),
                f"{engine}: only {int(out['optimal'].sum())}/{B} optimal")
        require(bool(rel.max() <= LP_OBJ_RTOL),
                f"{engine} fleet off HiGHS: {rel.max()}")
    cross["pdhg"] = {k: fleet_rec[k] for k in (
        "n_optimal", "max_rel_to_highs", "warm_seconds", "host_crossover_s",
        "median_pivots", "max_pivots", "exact_vertices_per_s")}
    rec[f"fleet_crossover_{B}x{m}x{n}"] = cross

    # the fleet barrier
    B, m, n = ipm_fleet_shape
    A, b, c, l, u = ipm_fleet_lps(B, m, n, seed=0)
    # ipm_fleet's own device call (device_tol, max_device_iters, float32
    # mu_exit), given to both runs
    dev, dev_s, stage = device_stage_vs_cpu(A, b, c, l, u, tol=1e-5,
                                            max_iters=60, mu_exit=1e-4)
    rec[f"device_stage_vs_cpu_f64_{B}x{m}x{n}"] = stage
    fl, fleet_s = synced_s(lambda: scx.ipm_fleet(A, b, c, l, u, tol=1e-8,
                                                 device=DEVICE))
    n_ref = min(8, B)
    ref = np.array([highs_obj(A[i], b[i], c[i], l[i], u[i])
                    for i in range(n_ref)])
    rel = np.abs(fl.obj[:n_ref] - ref) / np.maximum(1.0, np.abs(ref))
    n_opt = sum(st == "OPTIMAL" for st in fl.status)
    rec[f"ipm_fleet_{B}x{m}x{n}"] = {
        "n_optimal": n_opt, "max_rel_to_highs_first8": float(rel.max()),
        "device_s": fl.device_s, "endgame_s": fl.endgame_s,
        "total_s": fleet_s,
        "device_iters_median": float(np.median(fl.device_iters)),
        "device_iters_max": int(fl.device_iters.max()),
        "refine_iters_median": float(np.median(fl.refine_iters)),
        "refine_iters_max": int(fl.refine_iters.max()),
        "device_stage_alone_s": dev_s,
        "device_stage_instances_per_s": B / dev_s,
        "device_stage_converged_1e-5": int(dev["converged"].sum()),
        "instances_per_s": B / fleet_s}
    require(n_opt == B, f"ipm_fleet: {n_opt}/{B} OPTIMAL")
    require(bool(rel.max() <= LP_OBJ_RTOL), f"ipm_fleet off HiGHS: {rel}")

    # the single large LP, device endgame on each DeviceNE route
    m, n = big
    A, b, c, l, u = ipm_big_lp(m, n, seed=0)
    runs = {}
    real_ne = ne_device.DeviceNE
    for route in ("default", "f32_cg"):
        if route == "f32_cg":
            ne_device.DeviceNE = lambda A_, **kw: real_ne(A_, use_f64=False,
                                                          **kw)
        try:
            res, big_s = synced_s(lambda: fleet_mod.ipm_big(
                A, b, c, l, u, tol=1e-8, device=DEVICE))
        finally:
            ne_device.DeviceNE = real_ne
        cert = lp_certificate(A, b, c, l, u, res.x, res.y)
        runs[route] = {"status": res.status, "obj": res.obj_val,
                       "total_s": big_s, "device_s": res.device_s,
                       "endgame_s": res.endgame_s,
                       "device_iters": res.device_iters,
                       "endgame_iters": res.endgame_iters,
                       "ne_stats": ne_record(fleet_mod.last_ne_stats),
                       "certificate": cert}
        require(fleet_mod.last_ne_stats is not None,
                f"ipm_big ({route}): the device endgame did not engage")
        require(res.status == "OPTIMAL", f"ipm_big ({route}): {res.status}")
        require(cert["primal_residual"] <= IPM_CERT_TOL
                and cert["bound_violation"] <= IPM_CERT_TOL
                and cert["dual_infeasibility"] <= IPM_CERT_TOL
                and cert["gap"] <= IPM_CERT_TOL
                and cert["on_wide_box"] == 0,
                f"ipm_big ({route}) certificate: {cert}")
    rec[f"ipm_big_{m}x{n}"] = runs

    # the host IPM's normal equations formed on the card
    m, n, seed = ne_lp
    lp = random_sparse_lp(m=m, n=n, seed=seed)
    args = (lp.get_standard_A(), lp.b, lp.get_standard_c(),
            *lp.get_standard_bounds())
    real_maybe = ne_offload.maybe_device_ne
    made = []

    def spy(A_):
        made.append(real_maybe(A_))
        return made[-1]

    ne_offload.maybe_device_ne = spy
    os.environ["SCX_NE_OFFLOAD"] = "1"
    try:
        off, off_s = synced_s(lambda: ipm_solve(*args, tol=1e-8))
    finally:
        del os.environ["SCX_NE_OFFLOAD"]
        ne_offload.maybe_device_ne = real_maybe
    forms = made[0].forms if made and made[0] is not None else 0
    host, host_s = synced_s(lambda: ipm_solve(*args, tol=1e-8))
    rel = abs(off.obj_val - host.obj_val) / max(1.0, abs(host.obj_val))
    rec[f"ne_offload_{m}x{n}"] = {
        "seed": seed, "host": {"status": host.status, "obj": host.obj_val,
                               "iters": host.iter_count, "s": host_s},
        "offload": {"status": off.status, "obj": off.obj_val,
                    "iters": off.iter_count, "s": off_s,
                    "device_forms": forms},
        "rel_obj": rel}
    require(forms > 0, "NE offload: no normal equations formed on the card")
    require(off.status == host.status == "OPTIMAL",
            f"NE offload: {off.status} / {host.status}")
    require(rel <= LP_OBJ_RTOL, f"NE offload off the host IPM: {rel}")

    rec["launches"] = scx.kernel_launch_counts()
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


# ------------------------------------------------------ multi-device layer

SHARDED_PDHG_RTOL = 1e-3    # sharded_pdhg on the card (float32) against
#                             the same call on the CPU in float64, 1000 it.,
#                             relative to 1 + max |cpu value|
RANK_RTOL = 1e-6            # sharded flow indicators vs mcf_flow_indicators
MARGINAL_RTOL = 1e-4        # the sharded TNET vertex's float32 marginals
IPM_MESH_ATOL = 1e-6        # ipm_fleet(mesh=) against the unsharded call
SWEEP_HIGHS_RTOL = 1e-6     # lp_scenario_sweep vs HiGHS (the JAX test's)


def _highs_mcf(args):
    """HiGHS's objective of one MCF scenario (run in a worker process)."""
    from scipy.optimize import linprog

    c, A, b, u = args
    ref = linprog(c, A_eq=A, b_eq=b, bounds=np.stack([np.zeros(len(u)), u],
                                                    1), method="highs")
    return float(ref.fun) if ref.status == 0 else None


def is_forest(rows, cols, S):
    """Whether the bipartite edges (rows[k], S + cols[k]) form no cycle."""
    parent = list(range(S + int(max(cols, default=0)) + 1))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j in zip(rows.tolist(), cols.tolist()):
        a, b = find(i), find(S + j)
        if a == b:
            return False
        parent[a] = b
    return True


def _launched(scx, fn):
    """fn() with the kernel counts set to 0 just before and read just
    after; (result, counts, synced seconds)."""
    import torch

    torch.cuda.synchronize()
    scx.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, scx.kernel_launch_counts(), time.perf_counter() - t0


def phase_sharded(scx, cobj, cobj7, goto_x=None):
    """The multi-device layer at world size 1 on NCCL (one card), each
    sharded call held against the port's unsharded counterpart on the
    same inputs.  `cobj`, `cobj7` are main_64x256x256's and
    main_16x784x784's certified objectives; `goto_x` the pdhg_mcf_device
    point of network_crossover_goto128 (recomputed when None).  Returns
    the K1/K2 launch counts of the batch-sharded OT routes."""
    import concurrent.futures as cf
    import multiprocessing
    import socket

    import torch
    import torch.distributed as dist

    from smart_crossover_tpu_torch import bench
    from smart_crossover_tpu_torch import parallel as P
    from smart_crossover_tpu_torch.data.mcf_gen import goto_like_mcf
    from smart_crossover_tpu_torch.ops.ranking import mcf_flow_indicators
    from smart_crossover_tpu_torch.ops.sinkhorn_fused import (
        sinkhorn_plan_fused_plain)
    from smart_crossover_tpu_torch.solvers.ipm_fleet import ipm_fleet
    from smart_crossover_tpu_torch.solvers.pdhg_mcf import pdhg_mcf_device
    from smart_crossover_tpu_torch.solvers.projection import (
        apply_projector_torch)

    t_phase = time.perf_counter()
    rec = {"phase": "sharded"}
    # HiGHS on the MCF sweep's scenarios runs beside the card work
    # demand scenarios: b moved towards the demand of a random flow in
    # [0, u], feasible by convexity
    mcf = goto_like_mcf(128, 128, extra_arc_factor=4, regular=True, seed=42)
    K_MCF = 8
    b_alt = mcf.A @ (np.random.default_rng(0).uniform(0, 1, mcf.n) * mcf.u)
    b_sc = np.stack([(1 - 0.05 * k) * mcf.b + 0.05 * k * b_alt
                     for k in range(K_MCF)])
    pool = cf.ProcessPoolExecutor(
        max_workers=min(K_MCF, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("spawn"))
    highs_f = [pool.submit(_highs_mcf, (mcf.c, mcf.A, b, mcf.u))
               for b in b_sc]
    try:
        mesh = P.make_mesh()
        require(mesh.device.type == "cuda",
                "the sharded phase's mesh is not on the card")
        rec["world_size"] = dist.get_world_size()
        rec["backend"] = str(dist.get_backend())
        rec["mesh_shape"] = dict(mesh.shape)
        counts = {}

        # batch-sharded exact OT route at 64 x 256^2, K1 + K2 per rank
        s64, d64, M64 = bench.make_batch(64, 256, 256, seed=0)
        for engine in ("mega", "parent"):
            out, cnt, secs = _launched(
                scx, lambda: P.sharded_batched_tnet_exact_device(
                    mesh, s64, d64, M64, reg=REG,
                    sinkhorn_iters=SINKHORN_ITERS, max_pivots=MAX_PIVOTS,
                    engine=engine))
            certs = scx.certify_ot_basis_batch(out[5].cpu().numpy(), s64,
                                               d64, M64)
            obj = np.array([c.obj_val for c in certs])
            rel = float(np.max(np.abs(obj - cobj) / np.abs(cobj)))
            counts[f"exact_{engine}"] = cnt
            rec[f"exact_device_{engine}_64x256x256"] = {
                "n_certified": sum(c.ok for c in certs),
                "all_optimal_device": bool(out[4].all()),
                "max_rel_to_certified": rel, "seconds": secs,
                "median_pivots": float(out[3].double().median()),
                "launches": cnt}
            require(all(c.ok for c in certs) and bool(out[4].all()),
                    f"sharded exact ({engine}): not all certified")
            require(rel <= EXACT_RTOL,
                    f"sharded exact ({engine}) off main's certificates: {rel}")
            require(cnt["sinkhorn_fused"] == 1
                    and cnt["transport_simplex_mega"]
                    == (1 if engine == "mega" else 0),
                    f"sharded exact ({engine}) launches: {cnt}")
        stats = {}
        (X, obj, piv, opt), cnt, secs = _launched(
            scx, lambda: P.batched_tnet_exact(
                s64, d64, M64, reg=REG, sinkhorn_iters=SINKHORN_ITERS,
                mesh=mesh, stats=stats))
        rel = float(np.max(np.abs(obj - cobj) / np.abs(cobj)))
        counts["tnet_exact_mesh"] = cnt
        rec["batched_tnet_exact_mesh_64x256x256"] = {
            "n_optimal": int(opt.sum()), "max_rel_to_certified": rel,
            "seconds": secs, **stats, "launches": cnt}
        require(bool(opt.all()) and rel <= EXACT_RTOL,
                f"batched_tnet_exact(mesh=): {int(opt.sum())}/64, {rel}")
        require(cnt["sinkhorn_fused"] == 1, f"tnet_exact(mesh=): {cnt}")

        # one 784^2 instance, demand axis sharded
        s7, d7, M7 = (a[0] for a in bench.make_batch(16, 784, 784, seed=1))
        cap = 100_000
        (X7, pushes), _, secs = _launched(
            scx, lambda: P.sharded_tnet_single(mesh, s7, d7, M7,
                                               push_iters_cap=cap))
        rows, cols = np.nonzero(X7 > 0)
        mrg = max(np.abs(X7.sum(1) - s7).max() / s7.max(),
                  np.abs(X7.sum(0) - d7).max() / d7.max())
        gap = float((X7 * M7).sum() - cobj7[0]) / abs(cobj7[0])
        rec["tnet_single_784x784"] = {
            "push_iters": pushes, "push_cap": cap, "seconds": secs,
            "support": int(rows.size), "max_marginal_rel": float(mrg),
            "min_flow": float(X7.min()), "gap_to_certified": gap}
        require(bool(np.isfinite(X7).all()) and X7.shape == (784, 784),
                "sharded_tnet_single output malformed")
        require(mrg <= MARGINAL_RTOL and X7.min() >= 0.0,
                f"sharded_tnet_single not feasible: {mrg}, {X7.min()}")
        require(rows.size <= 784 + 784 - 1 and is_forest(rows, cols, 784),
                "sharded_tnet_single support is not a spanning forest")
        require(pushes < cap, "sharded_tnet_single push hit its cap")

        # the sharded Sinkhorn plan against K1's plain version
        reg7 = REG * float(M7.max())
        plan, _, secs = _launched(scx, lambda: P.sharded_sinkhorn_plan(
            mesh, s7, d7, M7, reg7, num_iters=SINKHORN_ITERS))
        s_, d_, M_ = to_cuda(s7[None], d7[None], M7[None])
        pp, _, _ = sinkhorn_plan_fused_plain(s_, d_, M_, reg7, SINKHORN_ITERS)
        dplan = (plan - pp[0]).abs().max().item()
        pmax = pp.abs().max().item()
        rec["sinkhorn_plan_784x784"] = {
            "iters": SINKHORN_ITERS, "reg": reg7, "max_abs_dplan": dplan,
            "max_plan": pmax, "seconds": secs, "plan_rtol": K1_PLAN_RTOL}
        require(dplan <= K1_PLAN_RTOL * pmax,
                f"sharded Sinkhorn plan off K1's plain version: {dplan}")

        # the projector at bench_projector's shape
        rng = np.random.default_rng(0)
        Y = rng.standard_normal((256, 8192))
        v = rng.standard_normal(8192)
        p_sh = P.sharded_projector(mesh, Y, v, tol=1e-6, max_iter=200)
        p_1 = apply_projector_torch(Y, v, tol=1e-6, max_iter=200)
        Yt, vt = to_cuda(Y, v)
        dp = (p_sh - p_1).abs().max().item() / p_1.abs().max().item()
        resid = ((Yt @ p_sh).norm() / (Yt @ vt).norm()).item()
        _, cg_ms, _ = sync_time(lambda: P.sharded_projector(
            mesh, Y, v, tol=0.0, max_iter=100), 3)
        _, cg1_ms, _ = sync_time(lambda: apply_projector_torch(
            Y, v, tol=0.0, max_iter=100), 3)
        rec["projector_256x8192"] = {
            "max_rel_to_unsharded": dp, "residual_rel": resid,
            "ms_per_cg_iteration": cg_ms / 100,
            "unsharded_ms_per_cg_iteration": cg1_ms / 100,
            "rtol": PROJ_RTOL, "residual_max": PROJ_RESIDUAL}
        require(dp <= PROJ_RTOL, f"sharded projector off the unsharded: {dp}")
        require(resid <= PROJ_RESIDUAL, f"sharded projector residual {resid}")

        # fixed-step PDHG on the single LP, card float32 vs CPU float64
        A, b, c, l, u = lp_single(512, 2048, 7)
        x32, y32 = P.sharded_pdhg(mesh, A, b, c, l, u, num_iters=1000)
        cpu_mesh = P.make_mesh(device="cpu")
        x64, y64 = P.sharded_pdhg(cpu_mesh, A, b, c, l, u, num_iters=1000)
        dx = np.abs(x32 - x64).max() / (1 + np.abs(x64).max())
        dy = np.abs(y32 - y64).max() / (1 + np.abs(y64).max())
        (xl, _), _, secs = _launched(scx, lambda: P.sharded_pdhg(
            mesh, A, b, c, l, u))
        rec["pdhg_512x2048"] = {
            "seed": 7, "x_rel_1000": float(dx), "y_rel_1000": float(dy),
            "iters": 10_000, "seconds": secs, "ms_per_iteration": secs / 10,
            "primal_residual_rel": float(np.linalg.norm(A @ xl - b)
                                         / (1 + np.linalg.norm(b))),
            "rtol": SHARDED_PDHG_RTOL}
        require(max(dx, dy) <= SHARDED_PDHG_RTOL,
                f"sharded_pdhg card vs CPU f64: {dx}, {dy}")
        require(bool(np.isfinite(xl).all()), "sharded_pdhg not finite")

        # MCF ranking at GOTO-128 from the pdhg_mcf_device point
        if goto_x is None:
            goto_x = pdhg_mcf_device(mcf, tol=1e-4, max_iters=5000)[0]
        xg, ug = to_cuda(goto_x, mcf.u)
        tg, hg = (torch.as_tensor(a, device=DEVICE) for a in (mcf.tails,
                                                               mcf.heads))
        ind = P.sharded_mcf_flow_indicators(mesh, goto_x, mcf.tails,
                                            mcf.heads, mcf.u, mcf.m)
        ind1 = mcf_flow_indicators(xg, tg, hg, ug, mcf.m)
        drank = (ind - ind1).abs().max().item() / ind1.abs().max().item()
        rec["ranking_goto128"] = {"arcs": mcf.n, "max_rel": drank,
                                  "rtol": RANK_RTOL}
        require(drank <= RANK_RTOL, f"sharded ranking off: {drank}")

        # the fleet barrier's device stage and the LP scenario sweep
        A, b, c, l, u = ipm_fleet_lps(*IPM_FLEET, seed=0)
        f1, _, secs1 = _launched(scx, lambda: ipm_fleet(
            A, b, c, l, u, refine=False, device=DEVICE))
        fm, _, secs = _launched(scx, lambda: ipm_fleet(
            A, b, c, l, u, refine=False, mesh=mesh))
        dxf = float(max(np.abs(fm.x - f1.x).max(), np.abs(fm.y - f1.y).max()))
        rec["ipm_fleet_mesh_64x256x512"] = {
            "max_abs_diff": dxf, "seconds": secs, "unsharded_seconds": secs1,
            "iters_equal": bool((fm.device_iters == f1.device_iters).all()),
            "atol": IPM_MESH_ATOL}
        require(bool((fm.device_iters == f1.device_iters).all())
                and fm.status == f1.status and dxf <= IPM_MESH_ATOL,
                f"ipm_fleet(mesh=) off the unsharded call: {dxf}")
        A, b, c, l, u = lp_fleet(32, 64, 256, 5)
        A0 = A[0]
        xs = np.random.default_rng(5).uniform(0.1, 0.9, (32, 256))
        bs = xs @ A0.T
        sw, _, secs = _launched(scx, lambda: P.lp_scenario_sweep(
            A0, bs[0], c[0], l[0], u[0], b_scenarios=bs, mesh=mesh))
        ref = np.array([highs_obj(A0, bk, c[0], l[0], u[0]) for bk in bs])
        rel = float(np.max(np.abs(sw["obj"] - ref) / (1 + np.abs(ref))))
        rec["lp_scenario_sweep_32x64x256"] = {
            "n_optimal": sw["status"].count("OPTIMAL"),
            "max_rel_to_highs": rel, "seconds": secs,
            "rtol": SWEEP_HIGHS_RTOL}
        require(sw["status"] == ["OPTIMAL"] * 32 and rel <= SWEEP_HIGHS_RTOL,
                f"lp_scenario_sweep(mesh=): {sw['status']}, {rel}")

        # MCF demand scenarios on GOTO-128, warm chain, against HiGHS
        t0 = time.perf_counter()
        sweep = P.mcf_scenario_sweep(mcf, b_scenarios=b_sc, warm_chain=True)
        sweep_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        refs = [f.result() for f in highs_f]
        wait_s = time.perf_counter() - t0
        require(None not in refs, "HiGHS failed on an MCF scenario")
        rel = float(np.max(np.abs(sweep["obj"] - refs) / np.abs(refs)))
        rec["mcf_scenario_sweep_goto128"] = {
            "scenarios": K_MCF, "pivots": sweep["pivots"].tolist(),
            "seconds": sweep_s, "highs_wait_s": wait_s,
            "max_rel_to_highs": rel, "rtol": EXACT_RTOL}
        require(sweep["status"] == ["OPTIMAL"] * K_MCF and rel <= EXACT_RTOL,
                f"mcf_scenario_sweep: {sweep['status']}, {rel}")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    # the multi-process entry point, one process
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "smart_crossover_tpu_torch.parallel.multihost",
         "--process-id", "0", "--num-processes", "1",
         "--coordinator", f"localhost:{port}"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    rec["multihost"] = {"rc": r.returncode,
                        "seconds": time.perf_counter() - t0,
                        "stdout": r.stdout.strip().splitlines()[-3:]}
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    require(r.returncode == 0 and "MULTIHOST_PASS proc=0 devices=1"
            in r.stdout, f"multihost: rc {r.returncode}: {r.stderr[-600:]}")
    dist.destroy_process_group()
    return counts


# ------------------------------------------------- the experiment drivers

def _driver(name, folder="scripts"):
    """<folder>/<name>.py of the repo as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_driver_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _store_check(store, base: str, what: str) -> dict:
    """Every record of a driver's store OPTIMAL, every other method equal
    to the instance's ``base`` record to EXACT_RTOL (HiGHS's objective to
    LP_OBJ_RTOL); the records by method."""
    rows = {r["method"]: r for r in store.rows()}
    require(rows and all(r["status"] == "OPTIMAL" for r in rows.values()),
            f"{what}: {[(m, r['status']) for m, r in rows.items()]}")
    ref = rows[base]["obj_val"]
    for m, r in rows.items():
        rtol = LP_OBJ_RTOL if m == "highs" else EXACT_RTOL
        require(abs(r["obj_val"] - ref) <= rtol * max(1.0, abs(ref)),
                f"{what}: {m} {r['obj_val']} against {base} {ref}")
    return {m: {"obj": r["obj_val"], "s": r.get("runtime"),
                "iters": r.get("iter_count")} for m, r in rows.items()}


def phase_drivers(scx):
    """The paper's experiment drivers (scripts/torch_run_network_crossover.py,
    scripts/torch_run_perturb_crossover.py) through their own functions,
    their stores in a temporary directory outside the repo: `total` mode
    on the network script's first MNIST-like pair (28 x 28 images, 784 pixels a
    side, 199 x 224 after the zero pixels are dropped; the Sinkhorn
    kernel once, B = 1) and on a GOTO-128 .min file
    (solve_mcf(first_order), the sparse PDHG), `crossover` mode on the
    same pair (the host barrier), and the perturbation protocol with its
    HiGHS oracle on one small staircase.  Every record OPTIMAL, each
    crossover equal to its baseline to 1e-9."""
    import tempfile

    from smart_crossover_tpu_torch.data import (
        ResultStore,
        goto_like_mcf,
        mnist_like_ot_suite,
        write_dimacs_min,
    )
    from smart_crossover_tpu_torch.data.lp_gen import optlp_scale_suite
    from smart_crossover_tpu_torch.solvers.settings import SolverSettings

    t_phase = time.perf_counter()
    net = _driver("torch_run_network_crossover")
    ptb = _driver("torch_run_perturb_crossover")
    settings = SolverSettings(log_console=0, simplexPricing="SE")
    methods = ["tnet", "cnet_ot", "cnet_mcf"]
    rec = {"phase": "drivers"}
    with tempfile.TemporaryDirectory(prefix="scx_drivers_") as tmp:
        (ot,) = mnist_like_ot_suite(num_pairs=1)
        store = ResultStore(os.path.join(tmp, "total_ot.jsonl"))
        _, counts, seconds = _launched(scx, lambda: net.run_total(
            ot.name, ot, methods, store, settings, device=DEVICE))
        require(counts["sinkhorn_fused"] == 1,
                f"total mode: K1 launched {counts['sinkhorn_fused']} times")
        rec["total_ot_28x28"] = {
            "instance": ot.name, "shape": list(ot.M.shape), "s": seconds,
            "launches": counts,
            "records": _store_check(store, "cold_network_simplex",
                                    "total mode, OT")}

        data = os.path.join(tmp, "mcf")
        os.makedirs(data)
        write_dimacs_min(goto_like_mcf(128, 128, extra_arc_factor=4, seed=0,
                                       regular=True),
                         os.path.join(data, "goto128.min"))
        ((name, mcf),) = net.load_instances("mcf", net.Path(data), 0)
        store = ResultStore(os.path.join(tmp, "total_mcf.jsonl"))
        _, counts, seconds = _launched(scx, lambda: net.run_total(
            name, mcf, methods, store, settings, device=DEVICE))
        rec["total_goto128"] = {
            "instance": name, "arcs": mcf.n, "s": seconds,
            "launches": counts,
            "records": _store_check(store, "cold_network_simplex",
                                    "total GOTO-128")}

        store = ResultStore(os.path.join(tmp, "crossover_ot.jsonl"))
        _, counts, seconds = _launched(scx, lambda: net.run_instance(
            ot.name, ot, methods, store, settings, 1e-4, device=DEVICE))
        rec["crossover_ot_28x28"] = {
            "instance": ot.name, "s": seconds, "launches": counts,
            "records": _store_check(store, "barrier_crossover",
                                    "crossover mode")}

        lps = optlp_scale_suite(num_per_family=1, scale=0.02,
                                families=("stair",))
        store = ResultStore(os.path.join(tmp, "perturb.jsonl"))
        t0 = time.perf_counter()
        ptb.run_suite([(lp.name, (lambda _lp=lp: _lp)) for lp in lps],
                      store, 1e-10, 1e-6, oracle=True, device=DEVICE)
        rec["perturb"] = {
            "instance": lps[0].name, "shape": list(lps[0].A.shape),
            "s": time.perf_counter() - t0,
            "records": _store_check(store, "ori", "perturbation")}
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def phase_example(scx):
    """The usage walkthrough, examples/torch_example.py, through its three
    demo functions on the card: TNET and CNET_OT from sinkhorn(ot) (K1
    exactly once, B = 1) OPTIMAL and equal to the cold network simplex to
    1e-9; the perturbation crossover equal to the host barrier to 1e-8;
    batched_tnet on 8 x 32^2 (K1 exactly once), its objectives those of a
    second call on the same batch, whose vertices are basic feasible with
    objective <X, M>, and equal to the CPU plain version's on the same
    batch to 1e-5 relative (float32; the CPU tests hold that one to JAX's
    batched_tnet at the same tolerance)."""
    import torch

    ex = _driver("torch_example", "examples")
    t_phase = time.perf_counter()
    ot, ot_counts, ot_s = _launched(scx, lambda: ex.ot_demo(DEVICE))
    lp, _, lp_s = _launched(scx, ex.lp_demo)
    bt, bt_counts, bt_s = _launched(scx, lambda: ex.batched_demo(DEVICE))
    s, d, M = ex.batched_batch()
    X, _, obj2 = scx.batched_tnet(s, d, M, reg=0.05, sinkhorn_iters=200,
                                  device=DEVICE)
    _, _, obj_cpu = scx.batched_tnet(s, d, M, reg=0.05, sinkhorn_iters=200,
                                     device="cpu")
    obj = np.asarray(bt["objectives"])
    Xc = X.double().cpu()
    s, d, M = (torch.as_tensor(a, dtype=torch.float64) for a in (s, d, M))
    rec = {"phase": "example", "ot": ot, "ot_s": ot_s,
           "ot_launches": ot_counts, "lp": lp, "lp_s": lp_s,
           "batched": bt, "batched_s": bt_s, "batched_launches": bt_counts,
           "batched_repeat_max_rel": float(np.max(np.abs(
               obj2.double().cpu().numpy() - obj) / np.abs(obj))),
           "batched_max_marginal_err": float(max(
               (Xc.sum(2) - s).abs().max(), (Xc.sum(1) - d).abs().max())),
           "batched_max_obj_err": float(np.max(np.abs(
               (Xc * M).sum((1, 2)).numpy() - obj) / (1 + np.abs(obj)))),
           "batched_cpu_objectives": obj_cpu.tolist(),
           "batched_cpu_max_rel": float(np.max(np.abs(
               obj_cpu.numpy() - obj) / np.abs(obj))),
           "tolerance": {"ot_rtol": EXACT_RTOL, "lp_rtol": LP_OBJ_RTOL,
                         "repeat_rtol": 1e-6, "marginal_atol": 1e-3,
                         "obj_rtol": 1e-5, "cpu_rtol": 1e-5}}
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    cold = ot["cold"]["obj"]
    for m in ("tnet", "cnet_ot", "cold"):
        require(ot[m]["status"] == "OPTIMAL", f"example {m}: {ot[m]}")
        require(abs(ot[m]["obj"] - cold) <= EXACT_RTOL * max(1.0, abs(cold)),
                f"example {m} {ot[m]['obj']} against the cold core {cold}")
    base = lp["baseline"]["obj"]
    require(lp["perturb"]["status"] == lp["baseline"]["status"] == "OPTIMAL"
            and abs(lp["perturb"]["obj"] - base)
            <= LP_OBJ_RTOL * max(1.0, abs(base)),
            f"example perturbation crossover {lp}")
    require(ot_counts["sinkhorn_fused"] == 1,
            f"example sinkhorn(ot) launched K1: {ot_counts}")
    require(bt_counts["sinkhorn_fused"] == 1,
            f"example batched_tnet launched K1: {bt_counts}")
    require(len(obj) == 8 and bool(np.isfinite(obj).all())
            and rec["batched_repeat_max_rel"] <= 1e-6
            and bool((Xc >= -1e-6).all())
            and rec["batched_max_marginal_err"] <= 1e-3
            and rec["batched_max_obj_err"] <= 1e-5,
            f"example batched vertices: {rec}")
    require(rec["batched_cpu_max_rel"] <= 1e-5,
            f"example batched objectives {obj.tolist()} against the CPU's "
            f"{obj_cpu.tolist()}")
    return {"ot": ot_counts, "batched": bt_counts}


def _torchrun(script, *args):
    """Start scripts/<script> under torchrun at one rank; returns a
    function that waits for it and gives its JSON lines and seconds
    (fails unless rc 0)."""
    waiter = start([sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", "1",
                    os.path.join("scripts", script), *args], timeout=600)

    def wait():
        rc, out, err, seconds = waiter()
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        require(rc == 0 and lines, f"torchrun {script}: rc {rc}: "
                f"{err[-600:]}")
        return [json.loads(ln) for ln in lines], seconds
    return wait


def phase_instruments(scx, torch):
    """The ports of the JAX instruments on the card: the soak (49 checks,
    no failure, K1, K3 and K4 launched), the device-simplex bench at size
    64 only (a cut of depth: the script's default sizes are 64, 128 and
    256), the perturbation profile on stair 0.02, and the weak-scaling and
    projection benches at one rank under torchrun, in subprocesses that
    run while this process runs the others."""
    t_phase = time.perf_counter()
    rec = {"phase": "instruments"}
    benches = {script: _torchrun(script) for script in (
        "torch_bench_scaling.py", "torch_bench_projection.py")}
    soak = _driver("torch_soak_round3")
    res, counts, seconds = _launched(scx, lambda: soak.main(DEVICE))
    # every timing below overlaps the torchrun benches
    rec["soak"] = {**res, "s": seconds, "launches": counts,
                   "overlapped": True}
    require(res["checks"] == 49 and res["failures"] == [],
            f"soak: {res}")
    require(all(counts[k] > 0 for k in ("sinkhorn_fused", "pdhg_chunk",
                                        "halpern_chunk")),
            f"soak launches: {counts}")

    print("instruments: torch_bench_device_simplex at size 64 only, batch "
          "16 (a cut of depth: the script's sizes are 64 128 256)",
          flush=True)
    dsx = _driver("torch_bench_device_simplex")
    (row, _), counts, seconds = _launched(scx, lambda: dsx.bench_size(
        64, 16, dsx.ENGINES, False, torch.device(DEVICE)))
    rec["device_simplex_64"] = {"row": row, "s": seconds,
                                "launches": counts, "overlapped": True}
    for engine in (*dsx.ENGINES, "host"):
        require(row[engine] is not None and row[engine]["all_optimal"],
                f"device simplex 64, {engine}: {row[engine]}")
    require(row["obj_gap_device_vs_host"] <= 1e-4,
            f"device simplex 64 gap {row['obj_gap_device_vs_host']}")
    # K2 on 'mega' alone (a warm-up and 5 timed calls), K1 on every call
    require(counts["transport_simplex_mega"] == 6
            and counts["sinkhorn_fused"] == 6 * len(dsx.ENGINES) + 1,
            f"device simplex 64 launches: {counts}")

    pp = _driver("torch_profile_perturb")
    prof = pp.main(["stair", "0.02"])
    rec["profile_perturb_stair_0.02"] = {**prof, "overlapped": True}
    statuses = [st["status"] for st in prof["stages"] if st["status"]]
    require(len(statuses) >= 2 and set(statuses) == {"OPTIMAL"},
            f"profile_perturb stages: {prof['stages']}")

    name = torch.cuda.get_device_name(0)
    for script, wait in benches.items():
        rows, seconds = wait()
        rec[script[:-3]] = {"summary": rows[-1], "s": seconds,
                            "overlapped": True}
        require(rows[-1]["device"] == name and rows[-1]["world_size"] == 1
                and [r["mesh_width"] for r in rows[-1]["results"]] == [1],
                f"{script}: {rows[-1]}")
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    import smart_crossover_tpu_torch as scx
    from smart_crossover_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_env(torch, _build)
    phase_build(_build)

    kernels = [phase_k1(), phase_k2(scx)]
    counts, cobj, ips = phase_main(scx, 64, 256, 256, seed=0, reps=5)
    counts7, cobj7, ips7 = phase_main(scx, 16, 784, 784, seed=1, reps=3)
    push = phase_push(scx)
    push.update(launches=counts["tree_push"], launches_784=counts7["tree_push"])
    certify, walk = phase_certify(scx)
    certify.update(launches=counts["certify"], launches_784=counts7["certify"])
    walk.update(launches=counts["tree_walk"],
                launches_784=counts7["tree_walk"])
    named = phase_bench(torch, {"ot_64x256x256": ips,
                                "ot_16x784x784": ips7})
    serve_row = named["serve_16x128x128x16"]
    goto_row = named["goto17_cnet_mcf"]
    for k in kernels:
        k["launches"] = counts[k["name"]]
        k["launches_784"] = counts7[k["name"]]
        k["launches_serve_per_dispatch"] = \
            serve_row["launches_per_dispatch"][k["name"]]
    nc_counts, k1_b1_ms, k1_b1_plain = phase_network_crossover(scx, cobj7[0])
    push["launches_network_crossover_tnet"] = nc_counts["tree_push"]
    walk["launches_network_crossover_tnet"] = nc_counts["tree_walk"]
    goto_fo, goto_warm, goto_x = phase_goto(scx)
    goto17 = phase_goto17(scx, goto_row)
    exact = phase_tnet_exact(scx, cobj)
    engines = phase_device_engines(scx, cobj, cobj7)
    kernels[0].update(launches_network_crossover=nc_counts["sinkhorn_fused"],
                      ms_784_b1=k1_b1_ms, plain_ms_784_b1=k1_b1_plain,
                      bound_ms_784_b1=bound(*sinkhorn_work(1, 784, 784))[0])
    for k in kernels:
        k["launches_tnet_exact_host"] = exact["host"][k["name"]]
        k["launches_tnet_exact_auto"] = exact["auto"][k["name"]]
        k["launches_device_engines"] = {
            r["engine"] + "_" + "x".join(map(str, r["shape"])):
            r["launches"][k["name"]] for r in engines["runs"]}

    kernels += [phase_k3(512, 2048, seed=3), phase_k4(512, 2048, seed=3),
                phase_k5()]
    single, single_ref = phase_lp_single(scx, 512, 2048, seed=7)
    fleet, _, fleet_rec = phase_lp_fleet(scx, 32, 64, 256, seed=5, reps=5)
    # the 64 x 256 x 512 fleet's host crossover took 188-344 s by call:
    # its first 8 instances are crossed over (K5 runs at 8 there and is
    # timed at all 64)
    fleet_big, big_ms, _ = phase_lp_fleet(scx, 64, 256, 512, seed=6,
                                          reps=3, n_cross=8)
    kernels[2]["launches"] = single["adaptive"]["pdhg_chunk"]
    kernels[3]["launches"] = single["halpern"]["halpern_chunk"]
    kernels[4]["launches"] = fleet["pdhg_batched"]
    kernels[4]["launches_64x256x512"] = fleet_big["pdhg_batched"]
    # the whole pdhg_dense_batched call at the larger fleet, 4000 iterations
    kernels[4]["call_ms_64x256x512"] = big_ms
    kernels[4]["bound_ms_64x256x512"] = bound(*fleet_work(64, 256, 512,
                                                          4000))[0]

    phase_ipm_device(scx, fleet_rec)
    front = phase_lp_front_door(scx, 512, 2048, seed=7, ref=single_ref)
    phase_perturb(scx, 800, 3200, seed=0)
    phase_cli(scx, 800, 3200, seed=1)
    ot_counts = phase_solve_ot(scx, cobj7[0])
    kernels[2]["launches_lp_front_door"] = front["pdhg_chunk"]
    for k in kernels[:2]:
        k["launches_solve_ot_device_simplex"] = \
            ot_counts["device_simplex_mega"][k["name"]]
        k["launches_solve_ot_default_engine"] = \
            ot_counts["device_simplex"][k["name"]]
    kernels[0]["launches_solve_ot_sinkhorn"] = \
        ot_counts["sinkhorn"]["sinkhorn_fused"]
    drivers = phase_drivers(scx)
    kernels[0]["launches_drivers_total_ot"] = \
        drivers["total_ot_28x28"]["launches"]["sinkhorn_fused"]
    example = phase_example(scx)
    kernels[0]["launches_example_sinkhorn_ot"] = \
        example["ot"]["sinkhorn_fused"]
    kernels[0]["launches_example_batched_tnet"] = \
        example["batched"]["sinkhorn_fused"]
    inst = phase_instruments(scx, torch)
    for k in kernels:
        k["launches_soak"] = inst["soak"]["launches"][k["name"]]
        k["launches_device_simplex_64"] = \
            inst["device_simplex_64"]["launches"][k["name"]]
    sharded = phase_sharded(scx, cobj, cobj7, goto_x)
    for k in kernels[:2]:
        for route, cnt in sharded.items():
            k[f"launches_sharded_{route}"] = cnt[k["name"]]
    # the sparse first-order route launches none of the dense PDHG kernels
    for k in kernels[2:]:
        k["launches_sparse_first_order"] = {
            "solve_mcf_goto128": goto_fo[k["name"]],
            "pdhg_mcf_goto128": goto_warm[k["name"]],
            "pdhg_mcf_goto17_250": goto17[k["name"]],
            "goto17_cnet_mcf": goto_row["launches"][k["name"]],
            "goto17_irregular_cnet_mcf":
                named["goto17_irregular_cnet_mcf"]["launches"][k["name"]],
            "drivers_total_goto128":
                drivers["total_goto128"]["launches"][k["name"]]}
    # the staircase LP's barrier runs cuBLAS and cuSOLVER, no kernel
    for k in kernels:
        k["launches_ipm_stair"] = \
            named["ipm_stair_10000x36975"]["launches"][k["name"]]

    bad = [m for m in sys.modules
           if m == "jax" or m.startswith("jax.")
           or m.split(".")[0] == "smart_crossover_tpu"]
    require(not bad, f"JAX modules were imported: {bad[:5]}")
    print(smi, flush=True)
    emit({"kernels": kernels + [push, certify, walk]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
