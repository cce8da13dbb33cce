#!/usr/bin/env python3
"""The sharded paths across ranks: one process per card on NCCL, or per
CPU process on gloo.

    torchrun --standalone --nproc-per-node 4 scripts/torch_sharded_ranks.py
    torchrun --standalone --nproc-per-node 4 scripts/torch_sharded_ranks.py \\
        --device cpu --small          # a rehearsal at small shapes

Every rank runs each sharded function over the whole group (batch-sharded
ones on a (p, 1) mesh, column-sharded ones on (1, p)) and holds the
gathered result against the port's unsharded counterpart on its own
device, at the shapes of chip_smoke.py's sharded phase: the batch-sharded
exact OT route at 64 x 256^2 (certified objectives), sharded_tnet_single
and sharded_sinkhorn_plan on the 784^2 instance, the projector at
256 x 8192, sharded_pdhg on the 512 x 2048 LP (card float32 against the
same call on the CPU in float64 over gloo), the ranking on GOTO-128,
ipm_fleet(mesh=) in both branches (64 x 256 x 512 over 'batch'; one
1000 x 4000 LP over 'model') and ipm_big(mesh=) to a host f64
certificate.  Rank 0 prints the card's nvidia-smi line and one JSON line
per check; a failed check on any rank exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# card float32 against the unsharded call on the same card, or against
# float64 on the CPU (CPU runs are float64 on both sides: 1e-8)
F32 = {"obj": 1e-3, "plan": 1e-3, "proj": 1e-4, "pdhg": 1e-3, "rank": 1e-6,
       "marginal": 1e-4, "iters_apart": 2}
F64 = {"obj": 1e-8, "plan": 1e-10, "proj": 1e-10, "pdhg": 1e-8,
       "rank": 1e-10, "marginal": 1e-8, "iters_apart": 0}
EXACT_RTOL = 1e-9           # certified objectives, host f64 on both sides
CERT_TOL = 1e-8             # ipm_big's host f64 certificate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    import bench
    import chip_smoke as cs
    import smart_crossover_tpu_torch as scx
    from smart_crossover_tpu_torch import parallel as P
    from smart_crossover_tpu_torch.data.mcf_gen import goto_like_mcf
    from smart_crossover_tpu_torch.ops.ranking import mcf_flow_indicators
    from smart_crossover_tpu_torch.ops.sinkhorn_fused import (
        sinkhorn_plan_fused_plain)
    from smart_crossover_tpu_torch.solvers.ipm_fleet import (
        ipm_big, ipm_fleet)
    from smart_crossover_tpu_torch.solvers.projection import (
        apply_projector_torch)

    torch.backends.cuda.matmul.allow_tf32 = False
    P.init_distributed(device=args.device)
    p = dist.get_world_size()
    rank = dist.get_rank()
    batch = P.make_mesh(p, 1, device=args.device)
    model = P.make_mesh(1, p, device=args.device)
    dev = model.device
    on_card = dev.type == "cuda"
    tol = F32 if on_card else F64
    small = args.small

    def emit(rec):
        if rank == 0:
            print(json.dumps(rec), flush=True)

    def check(cond, what):
        if not cond:
            raise RuntimeError(f"rank {rank}/{p}: {what}")

    def synced(fn):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    if rank == 0 and on_card:
        print(cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0], flush=True)
    emit({"phase": "ranks", "world_size": p, "device": str(dev),
          "backend": str(dist.get_backend()),
          "kind": torch.cuda.get_device_name(dev) if on_card else "cpu"})

    # the batch-sharded exact OT route, K1 + K2 on every rank
    B, S, D = (8, 16, 16) if small else (64, 256, 256)
    s, d, M = bench.make_batch(B, S, D, seed=0)
    kw = dict(reg=cs.REG, sinkhorn_iters=cs.SINKHORN_ITERS,
              max_pivots=cs.MAX_PIVOTS)
    scx.reset_kernel_launch_counts()
    out, secs = synced(lambda: P.sharded_batched_tnet_exact_device(
        batch, s, d, M, **kw))
    launches = scx.kernel_launch_counts()
    one = scx.batched_tnet_exact_device(s, d, M, device=dev, **kw)
    objs = [np.array([c.obj_val for c in scx.certify_ot_basis_batch(
        Bm.cpu().numpy(), s, d, M)]) for Bm in (out[5], one[5])]
    rel = float(np.max(np.abs(objs[0] - objs[1]) / np.abs(objs[1])))
    emit({"check": f"exact_mega_{B}x{S}x{D}", "seconds": secs,
          "max_rel_to_unsharded": rel, "launches_rank0": launches})
    check(bool(out[4].all()) and rel <= EXACT_RTOL,
          f"sharded exact route off the unsharded one: {rel}")
    check(not on_card or (launches["sinkhorn_fused"] == 1
                          and launches["transport_simplex_mega"] == 1),
          f"sharded exact route launches: {launches}")

    # one 784^2 instance over 'model': TNET, then the Sinkhorn plan
    S = 36 if small else 784
    s7, d7, M7 = (a[0] for a in bench.make_batch(2, S, S, seed=1))
    (X, pushes), secs = synced(lambda: P.sharded_tnet_single(model, s7, d7,
                                                             M7))
    rows, cols = np.nonzero(X > 0)
    mrg = max(np.abs(X.sum(1) - s7).max() / s7.max(),
              np.abs(X.sum(0) - d7).max() / d7.max())
    emit({"check": f"tnet_single_{S}x{S}", "push_iters": pushes,
          "seconds": secs, "max_marginal_rel": float(mrg),
          "support": int(rows.size), "obj": float((X * M7).sum())})
    check(mrg <= tol["marginal"] and X.min() >= 0.0
          and rows.size <= 2 * S - 1 and cs.is_forest(rows, cols, S),
          f"sharded_tnet_single is not a basic feasible flow: {mrg}")
    reg7 = cs.REG * float(M7.max())
    plan, secs = synced(lambda: P.sharded_sinkhorn_plan(
        model, s7, d7, M7, reg7, num_iters=cs.SINKHORN_ITERS))
    t = [torch.as_tensor(a[None], dtype=plan.dtype, device=dev)
         for a in (s7, d7, M7)]
    pp = sinkhorn_plan_fused_plain(*t, reg7, cs.SINKHORN_ITERS)[0][0]
    dplan = ((plan - pp).abs().max() / pp.abs().max()).item()
    emit({"check": f"sinkhorn_plan_{S}x{S}", "seconds": secs,
          "max_rel_dplan": dplan})
    check(dplan <= tol["plan"], f"sharded Sinkhorn plan: {dplan}")

    # the projector, ms per CG iteration
    m, n = (16, 64) if small else (256, 8192)
    rng = np.random.default_rng(0)
    Y, v = rng.standard_normal((m, n)), rng.standard_normal(n)
    ptol = 1e-6 if on_card else 1e-12
    p_sh = P.sharded_projector(model, Y, v, tol=ptol, max_iter=200)
    p_1 = apply_projector_torch(Y, v, tol=ptol, max_iter=200, device=dev)
    dp = ((p_sh - p_1).abs().max() / p_1.abs().max()).item()
    _, secs = synced(lambda: P.sharded_projector(model, Y, v, tol=0.0,
                                                 max_iter=100))
    emit({"check": f"projector_{m}x{n}", "max_rel_to_unsharded": dp,
          "ms_per_cg_iteration": secs * 10})
    check(dp <= tol["proj"], f"sharded projector: {dp}")

    # fixed-step PDHG: the card against float64 on the CPU (gloo)
    m, n = (12, 64) if small else (512, 2048)
    A, b, c, l, u = cs.lp_single(m, n, 7)
    x, y = P.sharded_pdhg(model, A, b, c, l, u, num_iters=1000)
    x64, y64 = P.sharded_pdhg(P.make_mesh(1, p, device="cpu"), A, b, c, l, u,
                              num_iters=1000)
    dx = max(np.abs(x - x64).max() / (1 + np.abs(x64).max()),
             np.abs(y - y64).max() / (1 + np.abs(y64).max()))
    (xl, _), secs = synced(lambda: P.sharded_pdhg(model, A, b, c, l, u))
    emit({"check": f"pdhg_{m}x{n}", "rel_to_cpu_f64_1000": float(dx),
          "ms_per_iteration": secs / 10,
          "primal_residual_rel": float(np.linalg.norm(A @ xl - b)
                                       / (1 + np.linalg.norm(b)))})
    check(dx <= tol["pdhg"], f"sharded_pdhg vs the CPU in float64: {dx}")

    # the MCF ranking (a flow with reversed and out-of-bound arcs)
    w = 8 if small else 128
    mcf = goto_like_mcf(w, w, extra_arc_factor=4, regular=True, seed=42)
    xg = np.random.default_rng(1).uniform(-0.1, 1.1, mcf.n) * mcf.u
    ind = P.sharded_mcf_flow_indicators(model, xg, mcf.tails, mcf.heads,
                                        mcf.u, mcf.m)
    ref = mcf_flow_indicators(*(torch.as_tensor(a, device=dev) for a in (
        xg.astype(np.float32) if on_card else xg, mcf.tails, mcf.heads,
        mcf.u.astype(np.float32) if on_card else mcf.u)), mcf.m)
    dr = ((ind - ref).abs().max() / ref.abs().max()).item()
    emit({"check": f"ranking_goto{w}", "arcs": mcf.n, "max_rel": dr})
    check(dr <= tol["rank"], f"sharded ranking: {dr}")

    # ipm_fleet(mesh=): the batch branch, then the column branch
    shapes = ((8, 6, 16), (8, 32)) if small else ((64, 256, 512),
                                                 (1000, 4000))
    A, b, c, l, u = cs.ipm_fleet_lps(*shapes[0], seed=0)
    for tag, mesh, lp in (("batch", batch, (A, b, c, l, u)),
                          ("column", model,
                           [a[None] for a in cs.ipm_big_lp(*shapes[1])])):
        got, secs = synced(lambda: ipm_fleet(*lp, refine=False, mesh=mesh))
        want = ipm_fleet(*lp, refine=False, device=dev)
        orel = float(np.max(np.abs(got.obj - want.obj)
                            / (1 + np.abs(want.obj))))
        apart = int(np.abs(got.device_iters - want.device_iters).max())
        emit({"check": f"ipm_fleet_{tag}_{'x'.join(map(str, lp[0].shape))}",
              "seconds": secs, "obj_max_rel": orel, "iters_apart": apart,
              "device_iters_median": float(np.median(got.device_iters))})
        check(orel <= tol["obj"] and apart <= tol["iters_apart"],
              f"ipm_fleet(mesh=) {tag}: {orel}, {apart}")
    A, b, c, l, u = cs.ipm_big_lp(*shapes[1])
    res, secs = synced(lambda: ipm_big(A, b, c, l, u, mesh=model))
    cert = cs.lp_certificate(A, b, c, l, u, res.x, res.y)
    emit({"check": f"ipm_big_{'x'.join(map(str, shapes[1]))}",
          "status": res.status, "seconds": secs,
          "device_iters": res.device_iters,
          "endgame_iters": res.endgame_iters, "certificate": cert})
    check(res.status == "OPTIMAL" and max(cert["primal_residual"],
                                          cert["box_violation"],
                                          cert["gap"]) <= CERT_TOL,
          f"ipm_big(mesh=): {res.status}, {cert}")

    dist.barrier()
    emit({"ok": True, "world_size": p})
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
