#!/usr/bin/env python3
"""Run chip_smoke.py's ipm_device phase alone.

    python3 scripts/torch_ipm_device.py

Runs main_lp_fleet_32x64x256 (its 'pdhg' figures stand beside the IPM
engines'; it builds K5 first) and then ipm_device, one JSON line each, as
chip_smoke.py runs them; any failure exits non-zero.  Prints the card's
nvidia-smi line first.  Needs a CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("torch_ipm_device: torch sees no CUDA device", file=sys.stderr)
        return 2
    import smart_crossover_tpu_torch as scx
    from smart_crossover_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.phase_env(torch, _build), flush=True)
    cs.phase_build(_build)
    _, _, fleet_rec = cs.phase_lp_fleet(scx, 32, 64, 256, seed=5, reps=2)
    cs.phase_ipm_device(scx, fleet_rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
