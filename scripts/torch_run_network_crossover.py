#!/usr/bin/env python3
"""Network-crossover experiment driver on the PyTorch port.

    python3 scripts/torch_run_network_crossover.py [--problem ot|mcf]
        [--test-object crossover|total] [--barrier-tol 1e-4]
        [--num-pairs 10] [--data-dir data] [--results results/network.jsonl]
        [--pricing SE|PP] [--device cpu]

Port of ``scripts/run_network_crossover.py`` (the reference driver's
protocol, reference scripts/run_network_crossover.py:51-133), with its
flags, defaults, instances and records:

* ``--test-object crossover``: per instance, the host barrier with its
  crossover (the baseline record ``barrier_crossover``), then TNET,
  CNET_OT (OT instances) and CNET_MCF (MCF instances) from its interior
  point ``x_bar``;
* ``--test-object total``: end to end, the cold network simplex
  (``cold_network_simplex``), then the first-order warm start and the
  crossover from it (``total_<method>``): for OT
  ``sinkhorn(ot, reg=0.01, num_iters=1000)``, the Sinkhorn kernel K1 at
  B = 1 on the card, for MCF ``solve_mcf(method="first_order")`` with
  20,000 iterations, the sparse PDHG on the card.

Instances: the synthetic MNIST-like OT pairs (``mnist_like_ot_suite``,
``--problem ot``), or the DIMACS ``.min`` files and network ``.mps`` files
in ``--data-dir`` (``--problem mcf``).  Records stream to a resumable
JSON-lines ``ResultStore``; a rerun skips what is solved; the summary
table closes the run.

``--device`` goes to the device entry points (``sinkhorn``,
``network_crossover``'s ranking and tree identification,
``solve_mcf(first_order)``): the card by default; ``cpu`` runs their plain
versions.  Without a card and without ``--device cpu`` the script stops
before any work, as the port's entry points do.  Imports only
``smart_crossover_tpu_torch``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from smart_crossover_tpu_torch.analysis import summarize, table  # noqa: E402
from smart_crossover_tpu_torch.config import resolve_device  # noqa: E402
from smart_crossover_tpu_torch.data import (  # noqa: E402
    ResultStore,
    mnist_like_ot_suite,
    read_dimacs_min,
)
from smart_crossover_tpu_torch.models import (  # noqa: E402
    MinCostFlow,
    OptTransport,
)
from smart_crossover_tpu_torch.network_methods import (  # noqa: E402
    network_crossover,
)
from smart_crossover_tpu_torch.solvers.settings import (  # noqa: E402
    SolverSettings,
)
from smart_crossover_tpu_torch.solvers.sinkhorn import sinkhorn  # noqa: E402
from smart_crossover_tpu_torch.solvers.solving import (  # noqa: E402
    solve_mcf,
    solve_ot,
)


def load_instances(problem: str, data_dir: Path, num_pairs: int):
    if problem == "ot":
        suite = mnist_like_ot_suite(num_pairs=num_pairs)
        return [(ot.name, ot) for ot in suite]
    insts = []
    for p in sorted(data_dir.glob("*.min")):
        insts.append((p.stem, read_dimacs_min(p)))
    for p in sorted(data_dir.glob("*.mps")):
        from smart_crossover_tpu_torch.data import read_mps

        lp = read_mps(p)
        try:
            mcf = MinCostFlow.from_incidence(lp.get_standard_A(), lp.b,
                                             lp.get_standard_c(),
                                             lp.u, name=p.stem)
            insts.append((p.stem, mcf))
        except ValueError:
            print(f"skipping {p.stem}: not a network LP")
    return insts


def run_instance(name, inst, methods, store, settings, barrier_tol,
                 device=None):
    if isinstance(inst, OptTransport):
        barrier = solve_ot(inst, method="barrier",
                           settings=SolverSettings(barrierTol=barrier_tol,
                                                   crossover="on"))
    else:
        barrier = solve_mcf(inst, method="barrier",
                            settings=SolverSettings(barrierTol=barrier_tol,
                                                    crossover="on"))
    if barrier.status != "OPTIMAL":
        store.record(name, "barrier", status=barrier.status,
                     runtime=barrier.runtime)
        return
    # baseline record: barrier + its own crossover
    store.record(name, "barrier_crossover", status=barrier.status,
                 runtime=barrier.runtime, obj_val=barrier.obj_val,
                 iter_count=barrier.iter_count,
                 bar_iter_count=barrier.bar_iter_count)
    x_bar = barrier.x_bar

    for method in methods:
        if store.is_solved(name, method):
            continue
        kwargs = ({"ot": inst} if isinstance(inst, OptTransport)
                  else {"mcf": inst})
        if isinstance(inst, MinCostFlow) and method != "cnet_mcf":
            continue
        if isinstance(inst, OptTransport) and method == "cnet_mcf":
            continue
        out = network_crossover(x=x_bar, method=method,
                                solver_settings=settings, device=device,
                                **kwargs)
        gap = (abs(out.obj_val - barrier.obj_val)
               / (abs(out.obj_val) + abs(barrier.obj_val) + 1))
        store.record(name, method, status=out.status, runtime=out.runtime,
                     obj_val=out.obj_val, iter_count=out.iter_count,
                     rel_gap_vs_barrier=gap)
        print(f"  {name} {method}: {out.status} obj={out.obj_val:.6g} "
              f"iters={out.iter_count} rt={out.runtime.total_seconds():.3f}s")


def run_total(name, inst, methods, store, settings, device=None):
    """End-to-end mode: first-order warm start + crossover vs cold network
    simplex (Sinkhorn for OT, matrix-free PDHG for MCF)."""
    if isinstance(inst, OptTransport):
        cold = solve_ot(inst, method="network_simplex")
    else:
        cold = solve_mcf(inst, method="network_simplex")
    store.record(name, "cold_network_simplex", status=cold.status,
                 runtime=cold.runtime, obj_val=cold.obj_val,
                 iter_count=cold.iter_count)
    if isinstance(inst, OptTransport):
        x = sinkhorn(inst, reg=0.01, num_iters=1000, device=device)
        run_methods = [m for m in methods if m != "cnet_mcf"]
        kwargs = {"ot": inst}
    else:
        fo = solve_mcf(inst, method="first_order",
                       settings=SolverSettings(crossover="off",
                                               firstOrderMaxIters=20_000),
                       device=device)
        x = np.clip(fo.x, 0, None)
        run_methods = ["cnet_mcf"]
        kwargs = {"mcf": inst}
    for method in run_methods:
        out = network_crossover(x=x, method=method,
                                solver_settings=settings, device=device,
                                **kwargs)
        store.record(name, f"total_{method}", status=out.status,
                     runtime=out.runtime, obj_val=out.obj_val,
                     iter_count=out.iter_count)
        print(f"  {name} total_{method}: {out.status} "
              f"obj={out.obj_val:.6g} iters={out.iter_count}")


def main(problem: str = "ot", test_object: str = "crossover",
         barrier_tol: float = 1e-4, num_pairs: int = 10,
         data_dir: str = "data", results: str = "results/network.jsonl",
         pricing: str = "SE", device=None):
    dev = resolve_device(device)
    store = ResultStore(results)
    settings = SolverSettings(log_console=0, simplexPricing=pricing)
    methods = ["tnet", "cnet_ot", "cnet_mcf"]
    instances = load_instances(problem, Path(data_dir), num_pairs)
    print(f"{len(instances)} instances ({problem}, {test_object})")
    for name, inst in instances:
        if test_object == "crossover":
            run_instance(name, inst, methods, store, settings, barrier_tol,
                         device=dev)
        else:
            run_total(name, inst, methods, store, settings, device=dev)
    print()
    print(table(summarize(store)))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="ot", choices=["ot", "mcf"])
    ap.add_argument("--test-object", default="crossover",
                    choices=["crossover", "total"])
    ap.add_argument("--barrier-tol", type=float, default=1e-4)
    ap.add_argument("--num-pairs", type=int, default=10)
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--results", default="results/network.jsonl")
    ap.add_argument("--pricing", default="SE", choices=["SE", "PP"])
    ap.add_argument("--device", default=None,
                    help="cuda (default; without a card the script stops) "
                         "or cpu: the device entry points' plain versions")
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    main(a.problem, a.test_object, a.barrier_tol, a.num_pairs, a.data_dir,
         a.results, a.pricing, a.device)
