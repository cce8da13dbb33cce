#!/usr/bin/env python3
"""Readings that set the limits of ``correct``; not part of a run.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13
        --seconds <s> [--control 0|1]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` as a run makes them, then every answer judged as a run
judges it (the program's readings, whose largest over a dozen seeds is a
limit's lower reading) and, with ``--control 1``, judged again with the
reference put in the program's place one precision below the
configuration's (the control's readings, whose smallest is the upper
reading).  Prints one JSON line per seed.  Needs the card, as a run does.
"""
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import argparse

    import torch

    from benchmark.harness import cli, spec

    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("benchmark/control.py: no CUDA card")
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = cli.run_cell(cell, seed, args.seconds, False,
                           torch.device("cuda"), time.perf_counter(), 0.0,
                           control=bool(args.control))
        attempted, failed, checks = cli.verdict(cell, res)
        kept = [r for r in res["window"].records if r is not None]
        line = {"workload": args.workload, "seed": seed,
                "attempted": attempted, "failed": failed,
                "undelivered": sum(not res["kind"].delivered(r)
                                   for r in kept),
                "program": {k: c["value"] for k, c in checks.items()}}
        if args.control:
            _, c_failed, c_checks = cli.verdict(cell, res, "control_numbers")
            line.update(control_failed=c_failed, control={
                k: c["value"] for k, c in c_checks.items()})
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
