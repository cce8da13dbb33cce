"""One run of one cell: set-up, the measured window, the check of every
answer against the plain reference, and the result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` turns
on the harness's spans over the whole window and the device profiler
over the traced stretch, and reports the per-layer metrics.  Exit codes:
0 a result was printed (``correct`` says whether every answer held); 2
bad arguments; 3 no CUDA card, or fewer than the cell asks for; 4 a JAX
module was loaded (looked for once the window has closed and again
just before the result is printed).  The last line of standard output
is the result; the last lines of standard error are the numbers
compared beside their limits.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from dataclasses import dataclass

from benchmark.harness import spec as specs
from benchmark.harness.loop import Window, closed_loop
from benchmark.harness.spans import Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "smart_crossover_tpu")


@dataclass
class Run:
    """What the metric readers read."""
    config: dict
    traffic: dict
    window: Window
    spans: dict
    counters: list
    units: int
    setup_s: float
    trace: object = None
    device_info: dict | None = None


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def run_cell(cell: specs.Cell, seed: int, seconds: float, trace: bool,
             device, perf0: float, age0: float,
             control: bool = False) -> dict:
    """Set-up, window and judgement of one run.  Returns the pieces of the
    result (``numbers`` per request, and with ``control`` the control's
    ``control_numbers`` from the same window)."""
    import torch

    kind = specs.request_kind(cell.traffic["kind"])
    missing = [k for k in kind.NUMBERS if k not in cell.traffic["limits"]]
    if missing:
        raise KeyError(f"traffic {cell.traffic_name!r} has no limit for "
                       f"{missing}")
    cuda = torch.device(device).type == "cuda"
    info = None
    if trace and cuda:
        from benchmark.roofline.peaks import device_info
        info = device_info()
    spans = Spans(trace, device)
    before = age0 + (time.perf_counter() - perf0)
    state = kind.setup(cell.config, cell.traffic, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = age0 + (time.perf_counter() - perf0)
    print(f"setup_s {setup_s:.3f}: {before:.3f} to the cell's set-up "
          f"(interpreter, imports), {setup_s - before:.3f} in it (the card's "
          f"first use, the pool, the kernels' build or load, the warm-up)",
          file=sys.stderr, flush=True)
    win = closed_loop(kind, state, seconds, spans,
                      cell.traffic["trace_requests"] if trace else 0)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = forbidden_modules()
    tr = None
    if win.profile is not None:
        from benchmark.harness.trace import summarize
        tr = summarize(win.profile, spans.seconds)
        win.profile = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    kept = [r for r in win.records if r is not None]
    numbers = kind.judge(state, kept)
    out = {"kind": kind, "window": win, "peak": peak, "forbidden": bad,
           "numbers": numbers,
           "run": Run(cell.config, cell.traffic, win,
                      spans.seconds, [r["counters"] for r in kept],
                      sum(kind.units(r) for r in kept), setup_s, tr, info)}
    if control:
        out["control_numbers"] = kind.judge(
            state, [kind.control(state, r) for r in kept])
    return out


def verdict(cell: specs.Cell, res: dict, key: str = "numbers") -> tuple:
    """(attempted, failed, checks): a request fails where it raised, did
    not deliver, or a number passed its limit; checks holds each number's
    worst over the window beside its limit."""
    kind, win = res["kind"], res["window"]
    limits = cell.traffic["limits"]
    kept = [r for r in win.records if r is not None]
    failed = len(win.records) - len(kept)
    worst = dict.fromkeys(kind.NUMBERS, 0.0)
    for rec, nums in zip(kept, res[key]):
        over = any(not nums[k] <= limits[k] for k in kind.NUMBERS)
        failed += int(over or not kind.delivered(rec))
        for k in kind.NUMBERS:
            if not nums[k] <= worst[k]:
                worst[k] = nums[k]
    if not kept:
        worst = dict.fromkeys(kind.NUMBERS, float("inf"))
    checks = {k: {"value": _finite(worst[k]), "limit": limits[k]}
              for k in kind.NUMBERS}
    return len(win.records), failed, checks


def metrics(cell: specs.Cell, run: Run, trace: bool) -> dict:
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        reader = (specs.metric_reader if trace
                  else specs.end_to_end_reader)(m.name)
        v = reader.read(run)
        if v is not None and math.isfinite(v):
            out[m.name] = {"value": v, "unit": m.unit}
    return out


def main(argv, perf0: float, age0: float) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = specs.load_cell(args.workload)

    import torch

    import smart_crossover_tpu_torch  # noqa: F401  (the program under test)

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {n}", file=sys.stderr)
        return 3
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"), perf0, age0)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": res["peak"]}
    return report(cell, res, bool(args.trace), device)


def report(cell: specs.Cell, res: dict, trace: bool, device: dict) -> int:
    """Print the checks and the result line of a run; 4 and nothing
    printed where a JAX module was loaded by the window's close or is
    loaded now, after the judging and the metric readers."""
    if res["forbidden"]:
        print(f"benchmark: loaded {res['forbidden']} in the measured process",
              file=sys.stderr)
        return 4
    attempted, failed, checks = verdict(cell, res)
    run = res["run"]
    line = {"correct": failed == 0 and attempted > 0,
            "attempted": attempted, "failed": failed,
            "metrics": metrics(cell, run, trace), "device": device}
    if trace and run.trace is not None:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s,
                      power_limit_w=run.device_info["power_limit_w"])
        line["breakdown"] = {"device_ops": run.trace.device_ops(),
                             "idle_gaps": run.trace.idle_gaps}
    line["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {bad} before the result was printed",
              file=sys.stderr)
        return 4
    lat = sorted(1e3 * t for t in res["window"].latencies)
    if lat:
        shown = ([round(1e3 * t, 1) for t in res["window"].latencies]
                 if len(lat) <= 50 else "")
        print(f"latencies_ms n={len(lat)} min={lat[0]:.1f} "
              f"median={lat[len(lat) // 2]:.1f} max={lat[-1]:.1f} {shown}",
              file=sys.stderr, flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
