#!/usr/bin/env python3
"""Time two designs of the port's PDHG kernels K5 (fleet) and K3 (chunk).

    mkdir -p build/pdhg_old
    for f in pdhg_batched pdhg_chunk; do git show \\
        0f299b9:smart_crossover_tpu_torch/csrc/$f.cu > build/pdhg_old/$f.cu; done
    python3 scripts/torch_pdhg_ab.py --old build/pdhg_old [--stamps]

`--old` holds the sources of the earlier designs (one block per instance
for K5, one cooperative launch with grid syncs for K3; their C entry
points take the argument lists below).  They are built with the package's
nvcc flags into build/pdhg_ab/ and run beside the package's current kernel
(one thread-block cluster per LP, A in shared memory) on chip_smoke.py's
inputs: K5 at 32 x 64 x 256 (seed 5, 2000 iterations) and 64 x 256 x 512
(seed 6, 4000 iterations), K3 at 512 x 2048 (seed 3, one 64-iteration
chunk from the state 256 plain iterations reach).  Each shape: both designs
against the plain version, then turns old, new, new, old, each the median
of --reps synced runs (K3: of 20 chunks launched back to back, per chunk).
Then cluster sizes forced through the plan, in turns forward and back, with
both combines (all-read and scatter) at each.  `--stamps` also builds the
current source with -DSCX_PDHG_STAMPS and prints, for each forced layout,
clock64 totals per phase of rank 0 of instance 0.  One JSON line per
measurement, then the card's nvidia-smi line.  Needs a CUDA card and nvcc.
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

import chip_smoke  # noqa: E402  (the inputs of its k3 and k5 phases)

OUT = REPO / "build" / "pdhg_ab"
PHASES = ("load", "col_pass", "barrier_a", "combine_xc", "barrier_a2",
          "row_pass", "barrier_b", "decision", "output")
P, I = ctypes.c_void_p, ctypes.c_int
CHUNK_BURST = 20


def build_old(src_dir: Path):
    k5 = build_shared(src_dir / "pdhg_batched.cu", OUT / "libk5_old.so")
    # A, b, c, l, u, opnorms, x, y, x_avg, y_avg, B, m, n, iters, stream
    k5.scx_pdhg_batched.argtypes = [P] * 10 + [I] * 4 + [P]
    k3 = build_shared(src_dir / "pdhg_chunk.cu", OUT / "libk3_old.so")
    # A, b, c, l, u, eq, xbuf, ybuf, axbuf, xs, ys, scal_in, scal_out, part,
    # x_out, y_out, ax_out, m, n, chunk, stream
    k3.scx_pdhg_chunk.argtypes = [P] * 17 + [I] * 3 + [P]
    return k5, k3


def build_new(stamps: bool):
    """The current source alone, with clock64 stamps or without."""
    from smart_crossover_tpu_torch import _build

    name = "libpdhg_stamps.so" if stamps else "libpdhg_new.so"
    lib = build_shared(_build.CSRC / "pdhg_cluster.cu", OUT / name,
                       ["-DSCX_PDHG_STAMPS"] if stamps else [])
    for fn in ("scx_pdhg_batched", "scx_pdhg_chunk",
               "scx_pdhg_cluster_smem_bytes"):
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
    if stamps:
        lib.scx_pdhg_stamps.argtypes = [P]
    return lib


def stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def check(err, what):
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def k5_old(lib, A, b, c, l, u, opn, iters):
    import torch

    B, m, n = A.shape
    x, xa = torch.empty_like(c), torch.empty_like(c)
    y, ya = torch.empty_like(b), torch.empty_like(b)
    check(lib.scx_pdhg_batched(A.data_ptr(), b.data_ptr(), c.data_ptr(),
                               l.data_ptr(), u.data_ptr(), opn.data_ptr(),
                               x.data_ptr(), y.data_ptr(), xa.data_ptr(),
                               ya.data_ptr(), B, m, n, iters, stream()),
          "old K5")
    return x, y, xa, ya


def k5_new(lib, A, b, c, l, u, opn, iters, plan, scatter):
    import torch

    B, m, n = A.shape
    x, xa = torch.empty_like(c), torch.empty_like(c)
    y, ya = torch.empty_like(b), torch.empty_like(b)
    check(lib.scx_pdhg_batched(A.data_ptr(), b.data_ptr(), c.data_ptr(),
                               l.data_ptr(), u.data_ptr(), opn.data_ptr(),
                               x.data_ptr(), y.data_ptr(), xa.data_ptr(),
                               ya.data_ptr(), B, m, n, iters,
                               plan["cluster_size"], plan["n_res"], scatter,
                               stream()), "new K5")
    return x, y, xa, ya


def k3_old(lib, args, bursts=1):
    import torch

    from smart_crossover_tpu_torch.ops.pdhg_chunk import _scalars

    A, b, c, l, u, eq, x, y, Ax, xs, ys, wsum, eta, omega, k, opn = args
    m, n = A.shape
    xbuf = torch.stack([x, torch.empty_like(x)]).contiguous()
    ybuf = torch.stack([y, torch.empty_like(y)]).contiguous()
    axbuf = torch.stack([Ax, torch.empty_like(Ax)]).contiguous()
    scal_in = _scalars(A, wsum, eta, omega, k, opn)
    scal_out = torch.zeros_like(scal_in)
    part = torch.zeros(4096, dtype=A.dtype, device=A.device)
    outs = [torch.empty_like(v) for v in (x, y, Ax)]
    xs_o, ys_o = xs.clone(), ys.clone()
    for _ in range(bursts):     # the same chunk again: only the time counts
        xbuf[0], ybuf[0], axbuf[0] = x, y, Ax
        check(lib.scx_pdhg_chunk(
            A.data_ptr(), b.data_ptr(), c.data_ptr(), l.data_ptr(),
            u.data_ptr(), eq.data_ptr(), xbuf.data_ptr(), ybuf.data_ptr(),
            axbuf.data_ptr(), xs_o.data_ptr(), ys_o.data_ptr(),
            scal_in.data_ptr(), scal_out.data_ptr(), part.data_ptr(),
            *(o.data_ptr() for o in outs), m, n, 64, stream()), "old K3")
    return (*outs, xs_o, ys_o, scal_out[0], scal_out[1])


def k3_new(lib, args, plan, scatter, bursts=1):
    import torch

    from smart_crossover_tpu_torch.ops.pdhg_chunk import _scalars

    A, b, c, l, u, eq, x, y, Ax, xs, ys, wsum, eta, omega, k, opn = args
    m, n = A.shape
    scal_in = _scalars(A, wsum, eta, omega, k, opn)
    scal_out = torch.zeros_like(scal_in)
    outs = [torch.empty_like(v) for v in (x, y, Ax)]
    xs_o, ys_o = xs.clone(), ys.clone()
    for _ in range(bursts):
        check(lib.scx_pdhg_chunk(
            A.data_ptr(), b.data_ptr(), c.data_ptr(), l.data_ptr(),
            u.data_ptr(), eq.data_ptr(), x.data_ptr(), y.data_ptr(),
            Ax.data_ptr(), xs_o.data_ptr(), ys_o.data_ptr(),
            scal_in.data_ptr(), scal_out.data_ptr(),
            *(o.data_ptr() for o in outs), m, n, 64, plan["cluster_size"],
            plan["n_res"], scatter, stream()), "new K3")
    return (*outs, xs_o, ys_o, scal_out[0], scal_out[1])


def stamps_of(lib):
    st = (ctypes.c_longlong * len(PHASES))()
    check(lib.scx_pdhg_stamps(ctypes.addressof(st)), "stamps")
    return dict(zip(PHASES, list(st)))


def rel(k, p):
    return max(chip_smoke.rel_diff(a, q) for a, q in zip(k, p))


def main() -> int:
    import torch

    from smart_crossover_tpu_torch.ops import pdhg_cluster as pc
    from smart_crossover_tpu_torch.ops.pdhg_chunk import pdhg_chunk_plain
    from smart_crossover_tpu_torch.solvers.pdhg_batched import (
        _opnorms, pdhg_fixed_batched_plain)

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--stamps", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_pdhg_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    old5, old3 = build_old(args.old)
    new = build_new(False)
    stamped = build_new(True) if args.stamps else None
    lib = new

    def emit(obj):
        print(json.dumps(obj), flush=True)

    def plan_for(B, m, n, C=None):
        from smart_crossover_tpu_torch import _build

        active = pc._active_clusters(_build.library(), B, m, n)
        return pc.pdhg_cluster_plan(B, m, n, active=active, cluster_size=C)

    def layout(plan):
        return {k: plan[k] for k in ("cluster_size", "n_res", "rows_in_smem",
                                     "a_in_smem", "smem_bytes",
                                     "max_active_clusters", "waves")}

    # ---- K5 fleets
    for B, m, n, seed, iters, forced in ((32, 64, 256, 5, 2000, (1, 2, 4)),
                                         (64, 256, 512, 6, 4000, (1, 2, 3))):
        A, b, c, l, u = chip_smoke.to_cuda(*chip_smoke.lp_fleet(B, m, n, seed))
        opn = _opnorms(A)
        x0 = torch.clamp(torch.zeros_like(c), l, u)
        y0 = torch.zeros_like(b)
        plan = plan_for(B, m, n)
        sc = int(plan["scatter"])
        p50 = pdhg_fixed_batched_plain(A, b, c, l, u, opn, x0, y0, 50)
        emit({"kernel": "K5", "shape": [B, m, n], "check": "vs plain, 50 it",
              "new": rel(k5_new(lib, A, b, c, l, u, opn, 50, plan, sc), p50),
              "old": rel(k5_old(old5, A, b, c, l, u, opn, 50), p50),
              "plan": layout(plan), "scatter": sc})
        ref = k5_new(lib, A, b, c, l, u, opn, iters, plan, sc)
        again = k5_new(lib, A, b, c, l, u, opn, iters, plan, sc)
        emit({"kernel": "K5", "shape": [B, m, n], "iters": iters,
              "repeat_bit_identical": all(torch.equal(a, q)
                                          for a, q in zip(ref, again))})
        turns = [("old", lambda: k5_old(old5, A, b, c, l, u, opn, iters)),
                 ("new", lambda: k5_new(lib, A, b, c, l, u, opn, iters, plan,
                                        sc))]
        for name, fn in turns + turns[::-1]:
            _, ms, times = median_ms(fn, args.reps)
            emit({"kernel": "K5", "shape": [B, m, n], "iters": iters,
                  "design": name, "ms": ms, "all_ms": times})
        for C in forced + forced[::-1]:
            fp = plan_for(B, m, n, C)
            for scatter in (0, 1):
                out, ms, times = median_ms(lambda: k5_new(
                    lib, A, b, c, l, u, opn, iters, fp, scatter), args.reps)
                rec = {"kernel": "K5", "shape": [B, m, n], "iters": iters,
                       "scatter": scatter, "ms": ms, "all_ms": times,
                       "rel_avg_vs_default": rel(out[2:], ref[2:]),
                       **layout(fp)}
                if stamped is not None:
                    k5_new(stamped, A, b, c, l, u, opn, iters, fp, scatter)
                    torch.cuda.synchronize()
                    rec["stamp_cycles"] = stamps_of(stamped)
                emit(rec)

    # ---- K3 chunk
    m, n = 512, 2048
    A, b, c, l, u, eq, x, y, Ax, opn = chip_smoke.pdhg_start(m, n, 3)
    z = torch.zeros_like
    st = pdhg_chunk_plain(A, b, c, l, u, eq, x, y, Ax, z(x), z(y), 0.0,
                          0.9 / opn, 1.0, 0, opn, chunk=256)
    cargs = (A, b, c, l, u, eq, *st, 1.0, 256, opn)
    plan = plan_for(1, m, n)
    sc = int(plan["scatter"])
    p = pdhg_chunk_plain(*cargs)
    k = k3_new(lib, cargs, plan, sc)
    again = k3_new(lib, cargs, plan, sc)
    emit({"kernel": "K3", "shape": [m, n], "check": "vs plain, one chunk",
          "new": rel(k, p), "old": rel(k3_old(old3, cargs), p),
          "new_eta_rel": chip_smoke.rel_diff(k[6], p[6]),
          "repeat_bit_identical": all(torch.equal(a, q)
                                      for a, q in zip(k, again)),
          "plan": layout(plan), "scatter": sc})

    def per_chunk(fn):
        _, ms, times = median_ms(fn, args.reps)
        return ms / CHUNK_BURST, [t / CHUNK_BURST for t in times]

    turns = [("old", lambda: k3_old(old3, cargs, CHUNK_BURST)),
             ("new", lambda: k3_new(lib, cargs, plan, sc, CHUNK_BURST))]
    for name, fn in turns + turns[::-1]:
        ms, times = per_chunk(fn)
        emit({"kernel": "K3", "shape": [m, n], "design": name,
              "ms_per_chunk": ms, "all_ms": times})
    for C in (4, 8, 12, 16, 16, 12, 8, 4):
        fp = plan_for(1, m, n, C)
        for scatter in (0, 1):
            ms, times = per_chunk(lambda: k3_new(lib, cargs, fp, scatter,
                                                 CHUNK_BURST))
            out = k3_new(lib, cargs, fp, scatter)
            rec = {"kernel": "K3", "shape": [m, n], "scatter": scatter,
                   "ms_per_chunk": ms, "all_ms": times,
                   "rel_vs_plain": rel(out, p), **layout(fp)}
            if stamped is not None:
                k3_new(stamped, cargs, fp, scatter)
                torch.cuda.synchronize()
                rec["stamp_cycles"] = stamps_of(stamped)
            emit(rec)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
