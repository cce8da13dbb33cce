#!/usr/bin/env python3
"""Run chip_smoke.py's perturbation-crossover phase at 1500 x 6000.

    python3 scripts/torch_perturb_1500x6000.py

The middle row of BENCH.md's large-LP table, random_sparse_lp(1500, 6000,
seed 0), through chip_smoke.phase_perturb: solve_lp(method=
"barrier_perturb") held to HiGHS to 1e-8 with its stage record, then the
device projector against the host one.  With HiGHS it takes longer than
chip_smoke.py's time limit allows beside its other phases, so chip_smoke
runs the phase at 800 x 3200.  Prints the card's nvidia-smi line, then
the phase's JSON line.  Needs a CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("torch_perturb_1500x6000: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    import smart_crossover_tpu_torch as scx

    print(cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]).splitlines()[0], flush=True)
    cs.phase_perturb(scx, 1500, 6000, seed=0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
