#!/usr/bin/env python3
"""Time an earlier commit's PDHG kernels against the current ones: K5
(fleet), K3 (adaptive chunk) and K4 (Halpern chunk).

    mkdir -p build/pdhg_old
    git show <commit>:smart_crossover_tpu_torch/csrc/pdhg_cluster.cu \\
        > build/pdhg_old/pdhg_cluster.cu
    git show 66f4441:smart_crossover_tpu_torch/csrc/pdhg_chunk.cu \\
        > build/pdhg_old/pdhg_chunk.cu
    python3 scripts/torch_pdhg_ab.py --old build/pdhg_old [--stamps] \\
        [--also SOURCE ...]

`--old` holds an earlier pdhg_cluster.cu (K3 and K5, with the C entry
points they have now) and 66f4441's pdhg_chunk.cu (K4 as one cooperative
launch per chunk with two grid syncs per iteration; its entry point takes
the argument list below).  Where the earlier pdhg_cluster.cu has a Halpern
kernel too (its entry point then takes a combine flag before the stream),
that K4 runs as the design "prev" with the scatter combine.  They are
built with the package's nvcc flags into build/pdhg_ab/ and run beside the
current source (one thread-block cluster per LP, A's rows in shared
memory) on chip_smoke.py's inputs: K5 at 32 x 64 x 256 (seed 5, 2000
iterations) and 64 x 256 x 512 (seed 6, 4000 iterations), K3 at 512 x 2048
(seed 3, one 64-iteration chunk from the state 256 plain iterations
reach), K4 at 512 x 2048 (seed 3, one chunk from the state 128 plain
Halpern iterations reach, anchors at the start).  First the registers and
spills of both sources' kernels (ptxas -v) and digests of their machine
code (cuobjdump -sass), and the same of each `--also` source (e.g. a third
commit's pdhg_cluster.cu).  Then each shape: the versions
against the plain version, then turns old, new, new, old (K4: old, prev,
new, new, prev, old), each the median of --reps synced runs (K3, K4: of 20
chunks launched back to back, per chunk).  K4 also times 20 calls of the
`halpern_chunk` wrapper back to back, per call, host work included.  Then
cluster sizes forced through the plan, K5 and K3 with both combines
(all-read and scatter) at each.  `--stamps` also builds the current source
with -DSCX_PDHG_STAMPS and prints, for each forced layout, clock64 totals
per phase of rank 0 of instance 0.  One JSON line per measurement, then
the card's nvidia-smi line.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

from kernel_ab import REPO, build_shared, median_ms, ptxas_report, sass_digest

sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the inputs of its k3, k4 and k5 phases)

OUT = REPO / "build" / "pdhg_ab"
PHASES = ("load", "col_pass", "barrier_a", "combine_xc", "barrier_a2",
          "row_pass", "barrier_b", "decision", "output")
HALPERN_PHASES = ("load", "col_pass", "barrier_a", "combine_xt",
                  "barrier_a2", "row_pass", "block_sync", "output")
P, I = ctypes.c_void_p, ctypes.c_int
CHUNK_BURST = 20
CLUSTER_FNS = ("scx_pdhg_batched", "scx_pdhg_chunk", "scx_halpern_chunk")


def build_old(src_dir: Path):
    from smart_crossover_tpu_torch import _build

    cl = build_shared(src_dir / "pdhg_cluster.cu", OUT / "libcluster_old.so")
    for fn in ("scx_pdhg_batched", "scx_pdhg_chunk"):
        getattr(cl, fn).argtypes = _build._SIGNATURES[fn]
    prev = None
    if "scx_halpern_chunk" in (src_dir / "pdhg_cluster.cu").read_text():
        # A, b, c, l, u, eq, x, y, ax, xa, ya, axa, scal_in, scal_out, x_out,
        # y_out, ax_out, m, n, chunk, C, n_res, scatter, stream
        cl.scx_halpern_chunk.argtypes = [P] * 17 + [I] * 6 + [P]
        prev = cl
    k4 = build_shared(src_dir / "pdhg_chunk.cu", OUT / "libk4_old.so")
    # A, b, c, l, u, eq, x, y, ax, xa, ya, axa, xt, scal_in, scal_out, m, n,
    # chunk, stream
    k4.scx_halpern_chunk.argtypes = [P] * 15 + [I] * 3 + [P]
    return cl, k4, prev


def build_new(stamps: bool):
    """The current source alone, with clock64 stamps or without."""
    from smart_crossover_tpu_torch import _build

    name = "libpdhg_stamps.so" if stamps else "libpdhg_new.so"
    lib = build_shared(_build.CSRC / "pdhg_cluster.cu", OUT / name,
                       ["-DSCX_PDHG_STAMPS"] if stamps else [])
    for fn in CLUSTER_FNS:
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
    if stamps:
        lib.scx_pdhg_stamps.argtypes = [P]
        lib.scx_halpern_stamps.argtypes = [P]
    return lib


def stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def check(err, what):
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def k5_run(lib, A, b, c, l, u, opn, iters, plan, scatter):
    import torch

    B, m, n = A.shape
    x, xa = torch.empty_like(c), torch.empty_like(c)
    y, ya = torch.empty_like(b), torch.empty_like(b)
    check(lib.scx_pdhg_batched(A.data_ptr(), b.data_ptr(), c.data_ptr(),
                               l.data_ptr(), u.data_ptr(), opn.data_ptr(),
                               x.data_ptr(), y.data_ptr(), xa.data_ptr(),
                               ya.data_ptr(), B, m, n, iters,
                               plan["cluster_size"], plan["n_res"], scatter,
                               stream()), "K5")
    return x, y, xa, ya


def k3_run(lib, args, plan, scatter, bursts=1):
    import torch

    from smart_crossover_tpu_torch.ops.pdhg_chunk import _scalars

    A, b, c, l, u, eq, x, y, Ax, xs, ys, wsum, eta, omega, k, opn = args
    m, n = A.shape
    scal_in = _scalars(A, wsum, eta, omega, k, opn)
    scal_out = torch.zeros_like(scal_in)
    outs = [torch.empty_like(v) for v in (x, y, Ax)]
    xs_o, ys_o = xs.clone(), ys.clone()
    for _ in range(bursts):     # the same chunk again: only the time counts
        check(lib.scx_pdhg_chunk(
            A.data_ptr(), b.data_ptr(), c.data_ptr(), l.data_ptr(),
            u.data_ptr(), eq.data_ptr(), x.data_ptr(), y.data_ptr(),
            Ax.data_ptr(), xs_o.data_ptr(), ys_o.data_ptr(),
            scal_in.data_ptr(), scal_out.data_ptr(),
            *(o.data_ptr() for o in outs), m, n, 64, plan["cluster_size"],
            plan["n_res"], scatter, stream()), "K3")
    return (*outs, xs_o, ys_o, scal_out[0], scal_out[1])


def k4_old(lib, args, bursts=1):
    """The cooperative design: x, y, Ax updated in place, so a burst runs
    chunk after chunk (its time does not depend on the values)."""
    import torch

    from smart_crossover_tpu_torch.ops.pdhg_chunk import _scalars

    A, b, c, l, u, eq, x, y, Ax, xa, ya, Axa, omega, k, step = args
    m, n = A.shape
    x_o, y_o, ax_o = x.clone(), y.clone(), Ax.clone()
    xt = torch.empty_like(x)
    scal_in = _scalars(A, omega, k, step)
    scal_out = torch.zeros_like(scal_in)
    for _ in range(bursts):
        check(lib.scx_halpern_chunk(
            A.data_ptr(), b.data_ptr(), c.data_ptr(), l.data_ptr(),
            u.data_ptr(), eq.data_ptr(), x_o.data_ptr(), y_o.data_ptr(),
            ax_o.data_ptr(), xa.data_ptr(), ya.data_ptr(), Axa.data_ptr(),
            xt.data_ptr(), scal_in.data_ptr(), scal_out.data_ptr(), m, n, 64,
            stream()), "old K4")
    return x_o, y_o, ax_o, scal_out[1]


def k4_new(lib, args, plan, bursts=1, combine=()):
    """The cluster design; `combine` (1,) for an earlier build whose entry
    point takes the combine flag."""
    import torch

    from smart_crossover_tpu_torch.ops.pdhg_chunk import _scalars

    A, b, c, l, u, eq, x, y, Ax, xa, ya, Axa, omega, k, step = args
    m, n = A.shape
    scal_in = _scalars(A, omega, k, step)
    scal_out = torch.zeros_like(scal_in)
    outs = [torch.empty_like(v) for v in (x, y, Ax)]
    for _ in range(bursts):     # the same chunk again: only the time counts
        check(lib.scx_halpern_chunk(
            A.data_ptr(), b.data_ptr(), c.data_ptr(), l.data_ptr(),
            u.data_ptr(), eq.data_ptr(), x.data_ptr(), y.data_ptr(),
            Ax.data_ptr(), xa.data_ptr(), ya.data_ptr(), Axa.data_ptr(),
            scal_in.data_ptr(), scal_out.data_ptr(),
            *(o.data_ptr() for o in outs), m, n, 64, plan["cluster_size"],
            plan["n_res"], *combine, stream()), "K4")
    return (*outs, scal_out[1])


def stamps_of(lib, fn="scx_pdhg_stamps", phases=PHASES):
    st = (ctypes.c_longlong * len(phases))()
    check(getattr(lib, fn)(ctypes.addressof(st)), "stamps")
    return dict(zip(phases, list(st)))


def rel(k, p):
    return max(chip_smoke.rel_diff(a, q) for a, q in zip(k, p))


def main() -> int:
    import torch

    from smart_crossover_tpu_torch import _build
    from smart_crossover_tpu_torch.ops import pdhg_cluster as pc
    from smart_crossover_tpu_torch.ops.pdhg_chunk import (
        halpern_chunk, halpern_chunk_plain, pdhg_chunk_plain)
    from smart_crossover_tpu_torch.solvers.pdhg_batched import (
        _opnorms, pdhg_fixed_batched_plain)

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--also", type=Path, nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_pdhg_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False

    def emit(obj):
        print(json.dumps(obj), flush=True)

    for design, src in (("old", args.old / "pdhg_cluster.cu"),
                        ("new", _build.CSRC / "pdhg_cluster.cu"),
                        *((f"also{i}", s) for i, s in enumerate(args.also))):
        obj = OUT / f"ptxas_{design}.o"
        emit({"ptxas": design, "source": str(src),
              "kernels": ptxas_report(src, obj), "sass": sass_digest(obj)})
    old_cl, old4, prev4 = build_old(args.old)
    lib = build_new(False)
    stamped = build_new(True) if args.stamps else None

    def plan_for(B, m, n, C=None, layout=pc.ADAPTIVE):
        active = pc._active_clusters(_build.library(), layout, B, m, n)
        return pc.pdhg_cluster_plan(B, m, n, active=active, cluster_size=C,
                                    layout=layout)

    def layout(plan):
        return {k: plan[k] for k in ("cluster_size", "n_res", "rows_in_smem",
                                     "a_in_smem", "smem_bytes",
                                     "max_active_clusters", "waves",
                                     "scatter")}

    def per_chunk(fn):
        _, ms, times = median_ms(fn, args.reps)
        return ms / CHUNK_BURST, [t / CHUNK_BURST for t in times]

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
              "new": rel(k5_run(lib, A, b, c, l, u, opn, 50, plan, sc), p50),
              "old": rel(k5_run(old_cl, A, b, c, l, u, opn, 50, plan, sc),
                         p50),
              "plan": layout(plan)})
        ref = k5_run(lib, A, b, c, l, u, opn, iters, plan, sc)
        again = k5_run(lib, A, b, c, l, u, opn, iters, plan, sc)
        emit({"kernel": "K5", "shape": [B, m, n], "iters": iters,
              "repeat_bit_identical": all(torch.equal(a, q)
                                          for a, q in zip(ref, again))})
        turns = [(name, lambda lb=lb: k5_run(lb, A, b, c, l, u, opn, iters,
                                             plan, sc))
                 for name, lb in (("old", old_cl), ("new", lib))]
        for name, fn in turns + turns[::-1]:
            _, ms, times = median_ms(fn, args.reps)
            emit({"kernel": "K5", "shape": [B, m, n], "iters": iters,
                  "design": name, "ms": ms, "all_ms": times})
        for C in forced:
            fp = plan_for(B, m, n, C)
            for scatter in (0, 1):
                out, ms, times = median_ms(lambda: k5_run(
                    lib, A, b, c, l, u, opn, iters, fp, scatter), args.reps)
                rec = {"kernel": "K5", "shape": [B, m, n], "iters": iters,
                       "ms": ms, "all_ms": times,
                       "rel_avg_vs_default": rel(out[2:], ref[2:]),
                       **layout(fp), "scatter": scatter}
                if stamped is not None:
                    k5_run(stamped, A, b, c, l, u, opn, iters, fp, scatter)
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
    k = k3_run(lib, cargs, plan, sc)
    again = k3_run(lib, cargs, plan, sc)
    emit({"kernel": "K3", "shape": [m, n], "check": "vs plain, one chunk",
          "new": rel(k, p), "old": rel(k3_run(old_cl, cargs, plan, sc), p),
          "new_eta_rel": chip_smoke.rel_diff(k[6], p[6]),
          "repeat_bit_identical": all(torch.equal(a, q)
                                      for a, q in zip(k, again)),
          "plan": layout(plan)})
    turns = [(name, lambda lb=lb: k3_run(lb, cargs, plan, sc, CHUNK_BURST))
             for name, lb in (("old", old_cl), ("new", lib))]
    for name, fn in turns + turns[::-1]:
        ms, times = per_chunk(fn)
        emit({"kernel": "K3", "shape": [m, n], "design": name,
              "ms_per_chunk": ms, "all_ms": times})
    for C in (8, 16):
        fp = plan_for(1, m, n, C)
        for scatter in (0, 1):
            ms, times = per_chunk(lambda: k3_run(lib, cargs, fp, scatter,
                                                 CHUNK_BURST))
            out = k3_run(lib, cargs, fp, scatter)
            rec = {"kernel": "K3", "shape": [m, n], "ms_per_chunk": ms,
                   "all_ms": times, "rel_vs_plain": rel(out, p),
                   **layout(fp), "scatter": scatter}
            if stamped is not None:
                k3_run(stamped, cargs, fp, scatter)
                torch.cuda.synchronize()
                rec["stamp_cycles"] = stamps_of(stamped)
            emit(rec)

    # ---- K4 chunk (chip_smoke.py's k4 inputs)
    step = 0.99 / opn
    x1, y1, Ax1, _ = halpern_chunk_plain(A, b, c, l, u, eq, x, y, Ax, x, y,
                                         Ax, 1.0, 0.0, step, chunk=128)
    hargs = (A, b, c, l, u, eq, x1, y1, Ax1, x, y, Ax, 1.0, 128.0, step)
    plan = plan_for(1, m, n, layout=pc.HALPERN)
    p = halpern_chunk_plain(*hargs)
    k = k4_new(lib, hargs, plan)
    again = k4_new(lib, hargs, plan)
    old = k4_old(old4, hargs)
    check_rec = {"new": rel(k[:3], p[:3]), "old": rel(old[:3], p[:3]),
                 "k_new": k[3].item(), "k_old": old[3].item()}
    if prev4 is not None:
        prev = k4_new(prev4, hargs, plan, combine=(1,))
        check_rec.update(prev=rel(prev[:3], p[:3]),
                         prev_bit_identical=all(torch.equal(a, q)
                                                for a, q in zip(k, prev)))
    emit({"kernel": "K4", "shape": [m, n], "check": "vs plain, one chunk",
          **check_rec,
          "repeat_bit_identical": all(torch.equal(a, q)
                                      for a, q in zip(k, again)),
          "plan": layout(plan)})
    turns = [("old", lambda: k4_old(old4, hargs, CHUNK_BURST))]
    if prev4 is not None:
        turns.append(("prev", lambda: k4_new(prev4, hargs, plan, CHUNK_BURST,
                                             combine=(1,))))
    turns.append(("new", lambda: k4_new(lib, hargs, plan, CHUNK_BURST)))
    for name, fn in turns + turns[::-1]:
        ms, times = per_chunk(fn)
        emit({"kernel": "K4", "shape": [m, n], "design": name,
              "ms_per_chunk": ms, "all_ms": times})

    def wrapper_burst():
        for _ in range(CHUNK_BURST):
            out = halpern_chunk(*hargs)
        return out

    wrapper_burst()
    ms, times = per_chunk(wrapper_burst)
    emit({"kernel": "K4", "shape": [m, n], "design": "new, wrapper",
          "ms_per_call": ms, "all_ms": times})
    for C in (1, 2, 4, 8, 12, 16):
        fp = plan_for(1, m, n, C, layout=pc.HALPERN)
        ms, times = per_chunk(lambda: k4_new(lib, hargs, fp, CHUNK_BURST))
        out = k4_new(lib, hargs, fp)
        rec = {"kernel": "K4", "shape": [m, n], "ms_per_chunk": ms,
               "all_ms": times, "rel_vs_plain": rel(out[:3], p[:3]),
               **layout(fp)}
        if stamped is not None:
            k4_new(stamped, hargs, fp)
            torch.cuda.synchronize()
            rec["stamp_cycles"] = stamps_of(stamped, "scx_halpern_stamps",
                                            HALPERN_PHASES)
        emit(rec)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
