"""Multi-process execution of the sharded kernels.

Port of ``smart_crossover_tpu/parallel/multihost.py``.  In the JAX package
this is the path where a process can only place data on its own devices,
so global arrays are assembled from each process's pieces.  In the port
every sharded function is already one process per rank
(``parallel/mesh.py``): each rank passes the full host arrays and takes its
own slice, so ``multihost_projector`` and ``multihost_sinkhorn_plan`` are
``sharded_projector`` and ``sharded_sinkhorn_plan`` called by every
process of the group.  ``worker_main`` runs both across processes and
checks them against numpy oracles.

Run one worker per process (a card each, or ``--device cpu`` on gloo)::

    python -m smart_crossover_tpu_torch.parallel.multihost \\
        --process-id 0 --num-processes 2 --coordinator localhost:9876
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def multihost_projector(mesh, Y, v, tol: float = 1e-8, max_iter: int = 200):
    """Cross-process ``parallel.projector.sharded_projector``: Y (m, n)
    column-sharded over the mesh's 'model' axis spanning the processes,
    one m-vector all-reduce per CG iteration.  Every process passes the
    same Y and v; returns the full (n,) result on the process's device."""
    from smart_crossover_tpu_torch.parallel.projector import (
        sharded_projector,
    )

    return sharded_projector(mesh, Y, v, tol=tol, max_iter=max_iter)


def multihost_sinkhorn_plan(mesh, s, d, M, reg, num_iters: int = 200):
    """Cross-process single-instance Sinkhorn (demand axis sharded)."""
    from smart_crossover_tpu_torch.parallel.projector import (
        sharded_sinkhorn_plan,
    )

    return sharded_sinkhorn_plan(mesh, s, d, M, reg, num_iters=num_iters)


def _local_block_check(mesh, full, ref, atol) -> int:
    """Compare this process's column block of ``full`` (gathered, on its
    device) against the same block of the numpy ``ref``; returns the
    number of blocks checked (1)."""
    lo, hi = mesh.slice("model", ref.shape[-1])
    got = full.double().cpu().numpy()[..., lo:hi]
    np.testing.assert_allclose(got, ref[..., lo:hi], atol=atol, rtol=0)
    return 1


def _host_sinkhorn_plan(s, d, M, reg, num_iters):
    """Plain host Sinkhorn iterations (the oracle)."""
    f = np.zeros(len(s))
    g = np.zeros(len(d))
    for _ in range(num_iters):
        t = (g[None, :] - M) / reg
        tm = t.max(axis=1)
        f = reg * (np.log(s) - (tm + np.log(
            np.exp(t - tm[:, None]).sum(axis=1))))
        t2 = (f[:, None] - M) / reg
        t2m = t2.max(axis=0)
        g = reg * (np.log(d) - (t2m + np.log(
            np.exp(t2 - t2m[None, :]).sum(axis=0))))
    return np.exp((f[:, None] + g[None, :] - M) / reg)


def worker_main(process_id: int, num_processes: int,
                coordinator: str, seed: int = 0,
                m: int = 24, n: int = 96, sink_s: int = 32,
                sink_d: int = 64, *, device=None) -> None:
    """One multi-process worker: start the group (``init_distributed``,
    tcp:// rendezvous at ``coordinator``), run the sharded projector and
    Sinkhorn across all processes, verify this process's block against
    numpy oracles and print a PASS marker.  ``device``: the card unless
    "cpu" is asked for; the checks hold float64 (CPU) to the JAX
    package's tolerances and float32 (card) to float32 ones."""
    import torch
    import torch.distributed as dist

    from smart_crossover_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
    )

    init_distributed(coordinator_address=coordinator,
                     num_processes=num_processes, process_id=process_id,
                     device=device)
    n_dev = dist.get_world_size()
    if n_dev != num_processes:
        raise RuntimeError(
            f"process {process_id}: the group has {n_dev} ranks, not "
            f"{num_processes}")
    print(f"[proc {process_id}] {n_dev} global devices (1 local)",
          flush=True)
    mesh = make_mesh(n_batch=1, n_model=n_dev, device=device)
    f64 = mesh.device.type != "cuda"
    rng = np.random.default_rng(seed)   # same seed -> same data everywhere

    # --- stage 1: cross-process null-space projector --------------------
    Y = rng.standard_normal((m, n))
    v = rng.standard_normal(n)
    out = multihost_projector(mesh, Y, v, **({} if f64 else
                                             {"tol": 1e-6}))
    z = np.linalg.solve(Y @ Y.T, Y @ v)
    ref = v - Y.T @ z
    nblocks = _local_block_check(mesh, out, ref,
                                 atol=1e-7 if f64 else 1e-4)
    resid = float(np.linalg.norm(Y @ out.double().cpu().numpy()))
    print(f"[proc {process_id}] projector OK "
          f"({nblocks} local shards, |Y p|={resid:.2e})", flush=True)

    # --- stage 2: cross-process Sinkhorn ---------------------------------
    s = rng.uniform(0.5, 2.0, sink_s)
    d = rng.uniform(0.5, 2.0, sink_d)
    d *= s.sum() / d.sum()
    M = rng.uniform(0.0, 5.0, (sink_s, sink_d))
    plan = multihost_sinkhorn_plan(mesh, s, d, M, reg=0.05, num_iters=300)
    ref_plan = _host_sinkhorn_plan(s, d, M, 0.05, 300)
    nblocks = _local_block_check(
        mesh, plan, ref_plan, atol=1e-8 if f64 else 1e-3 * ref_plan.max())
    print(f"[proc {process_id}] sinkhorn OK ({nblocks} local shards)",
          flush=True)
    print(f"MULTIHOST_PASS proc={process_id} devices={n_dev}", flush=True)
    torch.distributed.barrier()
    dist.destroy_process_group()


def bench_projector(process_id: int, num_processes: int, coordinator: str,
                    m: int = 256, n: int = 8192, iters: int = 100,
                    reps: int = 5, *, device=None) -> float:
    """Time the cross-process projector CG at a fixed iteration count
    (tol 0 runs all ``iters``): prints CG iterations/s, the best of
    ``reps`` synced runs after a warm-up, and returns ms per iteration."""
    import torch
    import torch.distributed as dist

    from smart_crossover_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
    )

    init_distributed(coordinator_address=coordinator,
                     num_processes=num_processes, process_id=process_id,
                     device=device)
    n_dev = dist.get_world_size()
    mesh = make_mesh(n_batch=1, n_model=n_dev, device=device)
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((m, n))
    v = rng.standard_normal(n)

    def run():
        out = multihost_projector(mesh, Y, v, tol=0.0, max_iter=iters)
        if out.is_cuda:
            torch.cuda.synchronize()

    run()                               # warm-up
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    print(f"MULTIHOST_BENCH proc={process_id} procs={num_processes} "
          f"devices={n_dev} m={m} n={n} cg_iters_per_s={iters / best:.1f}",
          flush=True)
    return best * 1e3 / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", default="localhost:9876")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bench", action="store_true",
                    help="time the projector CG instead of the checks")
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.bench:
        bench_projector(args.process_id, args.num_processes,
                        args.coordinator, m=args.m, n=args.n,
                        device=args.device)
    else:
        worker_main(args.process_id, args.num_processes, args.coordinator,
                    seed=args.seed, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
