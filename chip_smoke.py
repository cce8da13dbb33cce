#!/usr/bin/env python3
"""Drive the PyTorch port's certified-exact OT crossover once on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each, any failure fatal (non-zero exit):
  env     the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
  build   the port's CUDA kernels, compiled from csrc/ with nvcc;
  k1, k2  each kernel against its plain PyTorch version on the card, at the
          main path's shapes (64 x 256^2), with the median time of each;
  main    the main path, batched_tnet_exact_device, at 64 x 256^2 and at
          16 x 784^2 (bench.py's shapes and seeds): every instance certified
          by the host f64 certifier, both kernels launched, stage split,
          certified instances/s;
then the card's nvidia-smi line, the kernels' summary and, last,
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

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


def emit(obj) -> None:
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


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def phase_env(torch, build):
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc = run([build._nvcc(), "--version"]).splitlines()[-1]
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
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


def phase_k1(scx, s, d, M):
    from smart_crossover_tpu_torch.ops.sinkhorn_fused import (
        sinkhorn_plan_fused, sinkhorn_plan_fused_plain)

    Mn = (M / (REG * M.amax((1, 2)))[:, None, None]).contiguous()
    (plan, f, g), ms, _ = sync_time(
        lambda: sinkhorn_plan_fused(s, d, Mn, 1.0, SINKHORN_ITERS), 5)
    (pp, pf, pg), plain_ms, _ = sync_time(
        lambda: sinkhorn_plan_fused_plain(s, d, Mn, 1.0, SINKHORN_ITERS), 3)
    df = (f - pf).abs().max().item()
    dg = (g - pg).abs().max().item()
    dplan = (plan - pp).abs().max().item()
    pmax = pp.abs().max().item()
    rec = {"phase": "k1_sinkhorn", "shape": list(M.shape),
           "iters": SINKHORN_ITERS, "max_abs_df": df, "max_abs_dg": dg,
           "max_abs_dplan": dplan, "max_plan": pmax, "ms": ms,
           "plain_ms": plain_ms,
           "tolerance": {"pot_atol": K1_POT_ATOL,
                         "plan_rtol": K1_PLAN_RTOL}}
    emit(rec)
    require(all(np.isfinite([df, dg, dplan])), "k1 produced non-finite")
    require(df <= K1_POT_ATOL and dg <= K1_POT_ATOL,
            f"k1 potentials differ from plain: {df}, {dg}")
    require(dplan <= K1_PLAN_RTOL * pmax, f"k1 plan differs: {dplan}")
    return {"name": "sinkhorn_fused", "route": "cuda",
            "source": "smart_crossover_tpu_torch/csrc/sinkhorn.cu",
            "replaces": "smart_crossover_tpu/ops/sinkhorn_pallas.py:26",
            "max_abs_err": max(df, dg), "ms": ms, "plain_ms": plain_ms}


def phase_k2(scx, s, d, M):
    from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
    from smart_crossover_tpu_torch.ops.transport_simplex_mega import (
        mega_setup, rebuild_plan, transport_simplex_mega,
        transport_simplex_mega_plain)

    X0, _, _ = scx.batched_tnet(s, d, M, REG, SINKHORN_ITERS)
    st = mega_setup(X0, boruvka_bipartite_mst((X0 > 1e-12).float()), M)
    k, ms, _ = sync_time(lambda: transport_simplex_mega(
        st, max_pivots=MAX_PIVOTS), 5)
    p, plain_ms, _ = sync_time(lambda: transport_simplex_mega_plain(
        st, max_pivots=MAX_PIVOTS), 2)
    S, D = M.shape[1:]
    M64 = M.double()
    obj_k = (rebuild_plan(k[0], k[1], S, D).double() * M64).sum((1, 2))
    obj_p = (rebuild_plan(p[0], p[1], S, D).double() * M64).sum((1, 2))
    err = (obj_k - obj_p).abs().max().item()
    rel = ((obj_k - obj_p).abs() / obj_p.abs()).max().item()
    same_basis = int((k[4] == p[4]).all((1, 2)).sum().item())
    emit({"phase": "k2_transport_simplex_mega", "shape": list(M.shape),
          "all_optimal_kernel": bool(k[6].all()),
          "all_optimal_plain": bool(p[6].all()),
          "pivots_kernel": k[5].tolist(), "pivots_plain": p[5].tolist(),
          "same_pivots": int((k[5] == p[5]).sum().item()),
          "same_final_basis": same_basis,
          "max_abs_dobj": err, "max_rel_dobj": rel, "ms": ms,
          "plain_ms": plain_ms, "tolerance": {"obj_rtol": K2_OBJ_RTOL}})
    require(bool(k[6].all()) and bool(p[6].all()), "k2 not all optimal")
    require(rel <= K2_OBJ_RTOL, f"k2 objectives differ: rel {rel}")
    return {"name": "transport_simplex_mega", "route": "cuda",
            "source": "smart_crossover_tpu_torch/csrc/"
                      "transport_simplex_mega.cu",
            "replaces": "smart_crossover_tpu/ops/transport_simplex_mega.py:73",
            # objectives of the two final plans (their bases may tie)
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def stage_split(s, d, M):
    """One run of the main path's stages, each synced and timed (ms)."""
    import torch

    from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
    from smart_crossover_tpu_torch.ops.ranking import ot_flow_indicators
    from smart_crossover_tpu_torch.ops.sinkhorn_fused import (
        sinkhorn_plan_fused)
    from smart_crossover_tpu_torch.ops.transport_simplex_mega import (
        mega_setup, rebuild_plan, transport_simplex_mega)
    from smart_crossover_tpu_torch.ops.tree import (
        bipartite_tree_solve, push_to_bfs)
    from smart_crossover_tpu_torch.solvers.sinkhorn import round_to_feasible

    ms = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def mark(name):
        nonlocal t0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ms[name] = (t1 - t0) * 1e3
        t0 = t1

    Mn = (M / (REG * M.amax((1, 2)))[:, None, None]).contiguous()
    plan, _, _ = sinkhorn_plan_fused(s, d, Mn, 1.0, SINKHORN_ITERS)
    mark("sinkhorn_kernel")
    W = ot_flow_indicators(round_to_feasible(plan, s, d), s, d)
    mark("round_indicators")
    tree = boruvka_bipartite_mst(W)
    mark("boruvka_flow")
    X = bipartite_tree_solve(tree, s, d)
    mark("tree_solve")
    X0, push = push_to_bfs(X)
    mark("push")
    Bm0 = boruvka_bipartite_mst((X0 > 1e-12).to(M.dtype))
    mark("boruvka_support")
    st = mega_setup(X0, Bm0, M)
    mark("simplex_setup")
    out = transport_simplex_mega(st, max_pivots=MAX_PIVOTS)
    mark("simplex_kernel")
    rebuild_plan(out[0], out[1], *M.shape[1:])
    mark("rebuild")
    return ms, int(push.max().item())


def phase_main(scx, B, S, D, seed, reps):
    import torch

    import bench

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
    _, dev_ms, all_ms = sync_time(go, reps)
    X, obj, push, piv, opt, Bm = out
    t0 = time.perf_counter()
    certs = scx.certify_ot_basis_batch(Bm.cpu().numpy(), s64, d64, M64)
    cert_s = time.perf_counter() - t0
    n_cert = sum(c.ok for c in certs)
    cobj = np.array([c.obj_val for c in certs])
    obj_rel = float(np.max(np.abs(obj.double().cpu().numpy() - cobj)
                           / np.abs(cobj)))
    split, push_max = stage_split(s, d, M)
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
           "launches": counts, "stage_ms": split,
           "stage_split_push_max": push_max}
    emit(rec)
    require(X.shape == (B, S, D) and bool(torch.isfinite(X).all())
            and bool(torch.isfinite(obj).all()), "main path output malformed")
    require(n_cert == B, f"only {n_cert}/{B} certified")
    require(bool(opt.all()), "device did not reach optimality everywhere")
    require(obj_rel <= 1e-4, f"device objective off certificate: {obj_rel}")
    require(all(v > 0 for v in counts.values()),
            f"a kernel was not launched on the main path: {counts}")
    return counts


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

    import bench

    s, d, M = to_cuda(*bench.make_batch(64, 256, 256, seed=0))
    kernels = [phase_k1(scx, s, d, M), phase_k2(scx, s, d, M)]
    counts = phase_main(scx, 64, 256, 256, seed=0, reps=5)
    counts7 = phase_main(scx, 16, 784, 784, seed=1, reps=3)
    for k in kernels:
        k["launches"] = counts[k["name"]]
        k["launches_784"] = counts7[k["name"]]

    bad = [m for m in sys.modules
           if m == "jax" or m.startswith("jax.")
           or m.split(".")[0] == "smart_crossover_tpu"]
    require(not bad, f"JAX modules were imported: {bad[:5]}")
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
