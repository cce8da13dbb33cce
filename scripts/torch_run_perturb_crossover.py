#!/usr/bin/env python3
"""Perturbation-crossover experiment driver on the PyTorch port.

    python3 scripts/torch_run_perturb_crossover.py [--data-dir data/lp]
        [--results results/perturb.jsonl] [--barrier-tol 1e-10]
        [--optimality-tol 1e-6] [--max-instances N] [--generate optlp]
        [--scale 1.0] [--num-per-family 4] [--oracle]
        [--oracle-time-limit 3600] [--reverse] [--time-limit 3600]
        [--families stair,cover,...] [--device cpu]

Port of ``scripts/run_perturb_crossover.py`` (the reference driver's
protocol, reference scripts/run_perturb_crossover.py:44-97), with its
flags, defaults and records.  For every LP instance:

* ``ori``: the host barrier with its crossover (the vendor-baseline
  analog), with the whole time budget and a pivot cap of 10^7;
* ``ptb``: the perturbation crossover, ``run_perturb_algorithm``;
* with ``--oracle``, ``highs``: scipy HiGHS's objective;

resuming where the store already holds an instance's record.  Instances
come from the ``.mps`` / ``.lp`` files (gzipped or not) in ``--data-dir``
or, with ``--generate optlp``, from the synthetic optLP-scale suite
(``data/lp_gen.py::optlp_scale_suite``), cheap families first,
``--reverse`` for a second worker sharing the store, ``--families`` for a
subset.  Closes with the summary table and the ``ptb`` vs ``ori``
comparison.

Both arms run on the host in both packages (the barrier, the
perturbation crossover, the simplex).  ``--device`` is the two
experiment scripts' common flag: the card by default, and the script
stops before any work without one unless given ``cpu``, as the port's
entry points do; the device goes to ``solve_lp``, whose barrier does not
use it.  Imports only ``smart_crossover_tpu_torch``.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from smart_crossover_tpu_torch.analysis import (  # noqa: E402
    compare,
    summarize,
    table,
)
from smart_crossover_tpu_torch.config import resolve_device  # noqa: E402
from smart_crossover_tpu_torch.data import (  # noqa: E402
    ResultStore,
    load_instance,
)
from smart_crossover_tpu_torch.lp_methods.algorithms import (  # noqa: E402
    run_perturb_algorithm,
)
from smart_crossover_tpu_torch.solvers.settings import (  # noqa: E402
    SolverSettings,
)
from smart_crossover_tpu_torch.solvers.solving import solve_lp  # noqa: E402


def _highs_objective(lp, time_limit=3600.0):
    from scipy.optimize import linprog

    eq = lp.sense == "="
    bounds = [(li if np.isfinite(li) else None,
               ui if np.isfinite(ui) else None)
              for li, ui in zip(lp.l, lp.u)]
    t0 = time.perf_counter()
    res = linprog(lp.c, A_ub=lp.A[~eq], b_ub=lp.b[~eq],
                  A_eq=lp.A[eq], b_eq=lp.b[eq], bounds=bounds,
                  method="highs", options={"time_limit": time_limit})
    return (res.fun if res.status == 0 else None,
            time.perf_counter() - t0, int(res.status))


def run_suite(instances, store: ResultStore, barrier_tol: float,
              optimality_tol: float, oracle: bool = False,
              oracle_time_limit: float = 3600.0,
              time_limit: float = 3600.0, device=None):
    """instances: iterable of (name, thunk) where thunk() -> GeneralLP."""
    for name, thunk in instances:
        lp = None
        if oracle and not store.is_solved(name, "highs"):
            lp = thunk()
            obj, rt, st = _highs_objective(lp, oracle_time_limit)
            store.record(name, "highs", status="OPTIMAL" if st == 0
                         else f"HIGHS_{st}", runtime=rt, obj_val=obj)
            print(f"  {name} highs: obj={obj} ({rt:.1f}s)")
        if not store.is_solved(name, "ptb"):
            if lp is None:
                lp = thunk()
            out = run_perturb_algorithm(lp, barrierTol=barrier_tol,
                                        optimalityTol=optimality_tol)
            store.record(name, "ptb", status=out.status, runtime=out.runtime,
                         obj_val=out.obj_val, iter_count=out.iter_count,
                         bar_iter_count=out.bar_iter_count)
            print(f"  {name} ptb: {out.status} obj={out.obj_val} "
                  f"pivots={out.iter_count} ({out.runtime})")
        if not store.is_solved(name, "ori"):
            if lp is None:
                lp = thunk()
            # the baseline gets the full time budget: the default
            # 200k pivot cap binds FIRST on hard instances (mcom hit it at
            # ~1900 s), which would under-report the vendor-analog baseline
            out = solve_lp(lp, method="barrier",
                           settings=SolverSettings(barrierTol=barrier_tol,
                                                   crossover="on",
                                                   timeLimit=time_limit,
                                                   simplexMaxIters=10_000_000),
                           device=device)
            store.record(name, "ori", status=out.status, runtime=out.runtime,
                         obj_val=out.obj_val, iter_count=out.iter_count,
                         bar_iter_count=out.bar_iter_count)
            print(f"  {name} ori: {out.status} obj={out.obj_val} "
                  f"pivots={out.iter_count} ({out.runtime})")


def main(data_dir: str = "data/lp", results: str = "results/perturb.jsonl",
         barrier_tol: float = 1e-10, optimality_tol: float = 1e-6,
         max_instances: int | None = None, generate: str | None = None,
         scale: float = 1.0, num_per_family: int = 4,
         oracle: bool = False, oracle_time_limit: float = 3600.0,
         reverse: bool = False, time_limit: float = 3600.0,
         families: str | None = None, device=None):
    dev = resolve_device(device)
    store = ResultStore(results)
    if generate == "optlp":
        from smart_crossover_tpu_torch.data.lp_gen import optlp_scale_suite

        fams = tuple(families.split(",")) if families else (
            "stair", "cover", "mcom", "rail", "tran")
        lps = optlp_scale_suite(num_per_family=num_per_family,
                                scale=scale, families=fams)
        # cheap families first (staircase/multicommodity ori finish in
        # minutes; cover's cold crossover can take ~1h each) so partial
        # runs maximise instance coverage.  --reverse runs the list
        # back-to-front: a second worker sharing the (re-read-per-check)
        # ResultStore then works the expensive tail while the first
        # works the cheap head, meeting in the middle.
        lps.sort(key=lambda lp: (lp.name.startswith("cover"), lp.name),
                 reverse=reverse)
        if max_instances:
            lps = lps[:max_instances]
        instances = [(lp.name, (lambda _lp=lp: _lp)) for lp in lps]
        print(f"{len(instances)} generated optLP-scale instances "
              f"(scale={scale})")
    else:
        paths = sorted(Path(data_dir).glob("*.mps")) \
            + sorted(Path(data_dir).glob("*.mps.gz")) \
            + sorted(Path(data_dir).glob("*.lp")) \
            + sorted(Path(data_dir).glob("*.lp.gz"))
        if max_instances:
            paths = paths[:max_instances]
        instances = [(p.stem, (lambda _p=p: load_instance(_p)))
                     for p in paths]
        print(f"{len(instances)} LP instances in {data_dir}")

    run_suite(instances, store, barrier_tol, optimality_tol,
              oracle=oracle, oracle_time_limit=oracle_time_limit,
              time_limit=time_limit, device=dev)

    print()
    print(table(summarize(store)))
    cmp = compare(store, ours="ptb", baseline="ori")
    print(f"\nptb vs ori: {cmp}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default="data/lp")
    ap.add_argument("--results", default="results/perturb.jsonl")
    ap.add_argument("--barrier-tol", type=float, default=1e-10)
    ap.add_argument("--optimality-tol", type=float, default=1e-6)
    ap.add_argument("--max-instances", type=int, default=None)
    ap.add_argument("--generate", choices=["optlp"], default=None,
                    help="generate the optLP-scale synthetic suite "
                         "instead of reading --data-dir")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--num-per-family", type=int, default=4)
    ap.add_argument("--oracle", action="store_true",
                    help="record scipy-HiGHS objectives per instance")
    ap.add_argument("--oracle-time-limit", type=float, default=3600.0)
    ap.add_argument("--reverse", action="store_true",
                    help="process instances in reverse order (second "
                         "worker sharing the same result store)")
    ap.add_argument("--time-limit", type=float, default=3600.0,
                    help="per-arm wall budget for the ori baseline "
                         "(reference protocol: 3600 s; bounded runs "
                         "disclose the budget in the table)")
    ap.add_argument("--families", default=None,
                    help="comma-separated family subset (stair,cover,"
                         "mcom,rail,tran) — lets parallel workers "
                         "partition the suite deterministically")
    ap.add_argument("--device", default=None,
                    help="cuda (default; without a card the script stops) "
                         "or cpu")
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    main(a.data_dir, a.results, a.barrier_tol, a.optimality_tol,
         a.max_instances, a.generate, a.scale, a.num_per_family,
         a.oracle, a.oracle_time_limit, a.reverse, a.time_limit,
         a.families, a.device)
