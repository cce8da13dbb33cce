"""Command-line interface:  python -m smart_crossover_tpu_torch <command> ...

Port of ``smart_crossover_tpu/__main__.py``.  ``solve`` and ``crossover``
work as in the JAX CLI, over the port's facade; ``--device`` picks where
the device routes run (the CUDA card by default, ``cpu`` for the CPU).
Not ported yet: ``bench`` (the port has no benchmark, ROADMAP 1.0e).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="smart_crossover_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_solve = sub.add_parser("solve", help="solve an instance file")
    p_solve.add_argument("path",
                         help=".mps/.mps.gz/.lp/.lp.gz/.min/.ot/.mcf instance")
    p_solve.add_argument("--method", default="default",
                         help="default|barrier|barrier_perturb|simplex|"
                              "primal_simplex|dual_simplex|network_simplex|"
                              "first_order|sinkhorn|device_simplex")
    p_solve.add_argument("--barrier-tol", type=float, default=1e-8)
    p_solve.add_argument("--crossover", default="on", choices=["on", "off"])

    p_x = sub.add_parser("crossover", help="crossover an instance from a "
                                           "first-order warm start")
    p_x.add_argument("path")
    p_x.add_argument("--algo", default="auto",
                     help="tnet|cnet_ot|cnet_mcf|perturb|auto")
    for p in (p_solve, p_x):
        p.add_argument("--device", default=None,
                       help="where the device routes run: cuda (default) "
                            "or cpu")

    sub.add_parser("bench", help="run the throughput benchmark (not ported)")

    args = ap.parse_args(argv)

    if args.cmd == "bench":
        print("smart_crossover_tpu_torch: the port has no benchmark yet "
              "(ROADMAP 1.0e); `python -m smart_crossover_tpu bench` runs "
              "the JAX package's", file=sys.stderr)
        return 2

    from smart_crossover_tpu_torch.data.loaders import load_instance
    from smart_crossover_tpu_torch.models import MinCostFlow, OptTransport
    from smart_crossover_tpu_torch.solvers.settings import SolverSettings

    inst = load_instance(args.path)
    device = args.device

    if args.cmd == "solve":
        from smart_crossover_tpu_torch.solvers.solving import (
            solve_lp,
            solve_mcf,
            solve_ot,
        )

        settings = SolverSettings(barrierTol=args.barrier_tol,
                                  crossover=args.crossover)
        if isinstance(inst, OptTransport):
            out = solve_ot(inst, method=args.method, settings=settings,
                           device=device)
        elif isinstance(inst, MinCostFlow):
            out = solve_mcf(inst, method=args.method, settings=settings,
                            device=device)
        else:
            out = solve_lp(inst, method=args.method, settings=settings,
                           device=device)
        print(out)
        return 0 if out.status == "OPTIMAL" else 1

    # crossover command
    algo = args.algo
    if algo == "auto":
        algo = ("tnet" if isinstance(inst, OptTransport)
                else "cnet_mcf" if isinstance(inst, MinCostFlow)
                else "perturb")
    if algo == "perturb":
        from smart_crossover_tpu_torch.lp_methods.algorithms import (
            run_perturb_algorithm,
        )

        out = run_perturb_algorithm(inst)
    else:
        import numpy as np

        from smart_crossover_tpu_torch.network_methods import (
            network_crossover,
        )

        if isinstance(inst, OptTransport):
            from smart_crossover_tpu_torch.solvers.sinkhorn import sinkhorn

            x = sinkhorn(inst, reg=0.01, num_iters=1000, device=device)
            out = network_crossover(x=x, ot=inst, method=algo, device=device)
        else:
            from smart_crossover_tpu_torch.solvers.solving import solve_mcf

            fo = solve_mcf(inst, method="first_order",
                           settings=SolverSettings(crossover="off",
                                                   firstOrderMaxIters=20_000),
                           device=device)
            out = network_crossover(x=np.clip(fo.x, 0, None), mcf=inst,
                                    method=algo, device=device)
    print(out)
    return 0 if out.status == "OPTIMAL" else 1


if __name__ == "__main__":
    sys.exit(main())
