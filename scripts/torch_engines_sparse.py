#!/usr/bin/env python3
"""Run chip_smoke.py's pivot-engine and sparse first-order phases alone.

    python3 scripts/torch_engines_sparse.py

Builds the kernels, runs the two main OT phases (their certified
objectives are what the engine phases are held to), then
network_crossover_goto128 (with the first-order routes), the bench's
goto17_cnet_mcf row in a subprocess and pdhg_mcf_goto17 on its warm
start, device_engines and solve_ot_784, one JSON line each, as
chip_smoke.py runs them; any failure exits non-zero.  Prints the card's nvidia-smi line
first.  Needs a CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("torch_engines_sparse: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    import smart_crossover_tpu_torch as scx
    from smart_crossover_tpu_torch import _build

    print(cs.phase_env(torch, _build), flush=True)
    cs.phase_build(_build)
    _, cobj, _ = cs.phase_main(scx, 64, 256, 256, seed=0, reps=2)
    _, cobj7, _ = cs.phase_main(scx, 16, 784, 784, seed=1, reps=2)
    cs.phase_goto(scx)
    goto, _ = cs.run_bench("--cell", "goto17_cnet_mcf")
    cs.phase_goto17(scx, goto["detail"])
    cs.phase_device_engines(scx, cobj, cobj7)
    cs.phase_solve_ot(scx, cobj7[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
