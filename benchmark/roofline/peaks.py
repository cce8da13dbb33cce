"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
full 700 W), and the card's exponential rate.

The exponential rate is the MUFU ex2 throughput: 16 per clock per SM on
Hopper, times the card's SM count, times its maximum SM clock, both read
from the card (``device_info``)."""
from __future__ import annotations

import subprocess

F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
EX2_PER_CLOCK_PER_SM = 16


def device_info() -> dict:
    """The card's SM count, maximum SM clock (MHz) and power limit, from
    torch and nvidia-smi."""
    import torch

    props = torch.cuda.get_device_properties(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    mhz, watts = (float(v) for v in smi.split(","))
    return {"sms": props.multi_processor_count, "max_sm_mhz": mhz,
            "power_limit_w": watts}


def exp_per_s(info: dict) -> float:
    return EX2_PER_CLOCK_PER_SM * info["sms"] * info["max_sm_mhz"] * 1e6


def bound_s(ops: float, nbytes: float, exps: float, info: dict) -> float:
    """The least time the card could take for ``ops`` float32 operations
    and ``exps`` exponentials that must move ``nbytes`` bytes: the
    largest of the three times at the peaks."""
    return max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S,
               exps / exp_per_s(info))
