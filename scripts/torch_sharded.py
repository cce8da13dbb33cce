#!/usr/bin/env python3
"""Run chip_smoke.py's sharded phase alone.

    python3 scripts/torch_sharded.py

Runs main_64x256x256 and main_16x784x784 first (the sharded OT routes are
held to their certified objectives; they build K1 and K2), then the
sharded phase, one JSON line each, as chip_smoke.py runs them (the GOTO-128
warm point is recomputed with pdhg_mcf_device); any failure exits
non-zero.  Prints the card's nvidia-smi line first.  Needs a CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("torch_sharded: torch sees no CUDA device", file=sys.stderr)
        return 2
    import smart_crossover_tpu_torch as scx
    from smart_crossover_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.phase_env(torch, _build), flush=True)
    cs.phase_build(_build)
    _, cobj, _ = cs.phase_main(scx, 64, 256, 256, seed=0, reps=1)
    _, cobj7, _ = cs.phase_main(scx, 16, 784, 784, seed=1, reps=1)
    cs.emit({"launches_sharded": cs.phase_sharded(scx, cobj, cobj7)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
