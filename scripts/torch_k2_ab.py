#!/usr/bin/env python3
"""Time two designs of the port's pivot-loop kernel (K2) in one process.

    git show <commit>:smart_crossover_tpu_torch/csrc/transport_simplex_mega.cu \\
        > build/k2_old/transport_simplex_mega.cu
    python3 scripts/torch_k2_ab.py --old build/k2_old/transport_simplex_mega.cu

`--old` is a source of the one-block design (one thread block per
instance, N as a V x V byte matrix in global memory; C entry point
scx_transport_simplex_mega with the one-block argument list below).  It is
built with the package's nvcc flags into build/k2_ab/ and run beside the
package's current kernel on the same warm starts (bench.py's batches, the
TNET vertex and its Borůvka tree, as chip_smoke.py makes them), at
64 x 256^2 (seed 0) and 16 x 784^2 (seed 1), in turns old, new, new, old,
each turn the median of --reps synced runs.  At 16 x 784^2 it also times
the current kernel with the cluster plan capped at 8 (its own cap) and at
4 blocks per instance, in turns (8, 4, 4, 8).  One
JSON line per measurement, then the card's nvidia-smi line.  Needs a CUDA
card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

from kernel_ab import REPO, build_shared, median_ms

sys.path.insert(0, str(REPO))

REG, SINKHORN_ITERS, MAX_PIVOTS = 0.005, 1000, 20000


def build_old(src: Path) -> ctypes.CDLL:
    lib = build_shared(src, REPO / "build" / "k2_ab" / "libk2_old.so")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # M, N_in, mask_in, parent_in, dep_in, w_in, Xv_in, N_work, mask_out,
    # parent_out, Xv_out, w_out, pot_out, stats, B, S, D, tol, max_pivots,
    # refresh, stream
    lib.scx_transport_simplex_mega.argtypes = [P] * 14 + [I, I, I, F, I, I,
                                                          P]
    lib.scx_transport_simplex_mega.restype = I
    return lib


def run_old(lib, st, tol=1e-7, max_pivots=MAX_PIVOTS, refresh=128):
    """The one-block design's wrapper: (parent, Xv, w, pot, mask, pivots,
    optimal)."""
    import torch

    M = st["M"]
    B, S, D = M.shape
    N_work = torch.empty_like(st["N"])
    mask = torch.empty_like(st["mask"])
    parent = torch.empty_like(st["parent"])
    Xv, w, pot = (torch.empty_like(st["Xv"]) for _ in range(3))
    stats = torch.empty(B, 2, dtype=torch.int32, device=M.device)
    err = lib.scx_transport_simplex_mega(
        M.data_ptr(), st["N"].data_ptr(), st["mask"].data_ptr(),
        st["parent"].data_ptr(), st["dep"].data_ptr(), st["w"].data_ptr(),
        st["Xv"].data_ptr(), N_work.data_ptr(), mask.data_ptr(),
        parent.data_ptr(), Xv.data_ptr(), w.data_ptr(), pot.data_ptr(),
        stats.data_ptr(), B, S, D, tol, max_pivots, refresh,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old K2: CUDA error {err}")
    return parent, Xv, w, pot, mask, stats[:, 0].long(), stats[:, 1] != 0


def warm_state(B, S, D, seed):
    import torch

    import bench
    import smart_crossover_tpu_torch as scx
    from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
    from smart_crossover_tpu_torch.ops.transport_simplex_mega import (
        mega_setup)

    s, d, M = (torch.tensor(a, dtype=torch.float32, device="cuda")
               for a in bench.make_batch(B, S, D, seed=seed))
    X0, _, _ = scx.batched_tnet(s, d, M, REG, SINKHORN_ITERS)
    return mega_setup(X0, boruvka_bipartite_mst((X0 > 1e-12).float()), M)


def main() -> int:
    import torch

    from smart_crossover_tpu_torch.ops import transport_simplex_mega as tsm

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_ab: no CUDA device", file=sys.stderr)
        return 2
    old = build_old(args.old)

    def new(st, C=8):
        # the cluster plan's largest C; 8 is its own
        tsm._MAX_CLUSTER = C
        try:
            return tsm.transport_simplex_mega_state(st, max_pivots=MAX_PIVOTS)
        finally:
            tsm._MAX_CLUSTER = 8

    for B, S, D, seed in ((64, 256, 256, 0), (16, 784, 784, 1)):
        st = warm_state(B, S, D, seed)
        new(st), run_old(old, st)              # first launches, untimed
        turns = [("old", lambda: run_old(old, st)), ("new", lambda: new(st)),
                 ("new", lambda: new(st)), ("old", lambda: run_old(old, st))]
        if S == 784:
            turns += [(f"new_C{c}", lambda c=c: new(st, c))
                      for c in (8, 4, 4, 8)]
        outs = {}
        for name, fn in turns:
            out, ms, times = median_ms(fn, args.reps)
            plan = dict(tsm.LAST_LAUNCH) if name != "old" else {}
            outs[name] = out
            print(json.dumps({
                "shape": [B, S, D], "seed": seed, "design": name, "ms": ms,
                "all_ms": times, "max_pivots": int(out[5].max()),
                "all_optimal": bool(out[6].all()),
                "cluster_size": plan.get("cluster_size"),
                "max_active_clusters": plan.get("max_active_clusters")}),
                flush=True)
        o, n = outs["old"], outs["new"]
        M64 = st["M"].double()
        obj = [(tsm.rebuild_plan(r[0], r[1], S, D).double() * M64)
               .sum((1, 2)) for r in (o, n)]
        print(json.dumps({
            "shape": [B, S, D], "compare": "old vs new",
            "same_pivots": int((o[5] == n[5]).sum()),
            "same_final_basis": int((o[4] == n[4]).all((1, 2)).sum()),
            "max_rel_dobj": ((obj[0] - obj[1]).abs() / obj[1].abs())
            .max().item()}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
