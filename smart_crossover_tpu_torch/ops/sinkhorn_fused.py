"""Fused batched log-domain Sinkhorn: CUDA kernel and its plain version.

Replaces the TPU kernel ``smart_crossover_tpu/ops/sinkhorn_pallas.py::
_sinkhorn_kernel`` (wrapper ``sinkhorn_plan_pallas``).  Same math: per
instance, ``num_iters`` rounds of

    f = reg * (log s - LSE_j((g - M) / reg))
    g = reg * (log d - LSE_i((f - M) / reg))

each LSE taken max-first, then the plan exp((f + g - M) / reg).  The
wrapper returns (plan, f, g): the potentials cost nothing extra and let
the exact pipeline consume them.

On the H100 the kernel (``csrc/sinkhorn.cu``) is bound by reading M: each
half-iteration streams every instance's cost matrix once.  One instance's
M at 256^2 (256 KB) is larger than a block's shared memory, so the kernel
does not pin M as the TPU kernel pins it in VMEM; instead it launches one
grid per half-iteration and streams M from the 50 MB L2, which holds the
whole 64x256^2 batch (16 MB).  Rows: one warp per (b, i) row.  Columns: a
block owns 32 adjacent columns and 8 row groups, so loads coalesce and the
column reduction is split eight ways.  No TPU tiling gate: any S and D.
"""
from __future__ import annotations

import torch

from smart_crossover_tpu_torch import _build


def sinkhorn_plan_fused_plain(s, d, Mn, reg: float, num_iters: int):
    """Plain tensor version of the fused kernel (the Pallas kernel's
    arithmetic: multiply by 1/reg, max-first LSE)."""
    inv_reg = 1.0 / reg
    log_s = torch.log(s)
    log_d = torch.log(d)
    f = torch.zeros_like(log_s)
    g = torch.zeros_like(log_d)
    for _ in range(num_iters):
        t = (g[:, None, :] - Mn) * inv_reg
        tmax = t.amax(2)
        f = reg * (log_s - (tmax + torch.log(
            torch.exp(t - tmax[:, :, None]).sum(2))))
        t2 = (f[:, :, None] - Mn) * inv_reg
        t2max = t2.amax(1)
        g = reg * (log_d - (t2max + torch.log(
            torch.exp(t2 - t2max[:, None, :]).sum(1))))
    plan = torch.exp((f[:, :, None] + g[:, None, :] - Mn) * inv_reg)
    return plan, f, g


def _check(name, t, shape):
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous() \
            or tuple(t.shape) != shape:
        raise ValueError(f"sinkhorn_plan_fused: {name} must be a contiguous "
                         f"float32 CUDA tensor of shape {shape}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _sinkhorn_fused_cuda(s, d, Mn, reg: float, num_iters: int):
    B, S, D = Mn.shape
    _check("Mn", Mn, (B, S, D))
    _check("s", s, (B, S))
    _check("d", d, (B, D))
    lib = _build.library()
    plan = torch.empty_like(Mn)
    f = torch.empty_like(s)
    g = torch.empty_like(d)
    log_s = torch.empty_like(s)
    log_d = torch.empty_like(d)
    stream = torch.cuda.current_stream(Mn.device).cuda_stream
    with torch.cuda.device(Mn.device):
        err = lib.scx_sinkhorn_fused(
            s.data_ptr(), d.data_ptr(), Mn.data_ptr(), plan.data_ptr(),
            f.data_ptr(), g.data_ptr(), log_s.data_ptr(), log_d.data_ptr(),
            B, S, D, float(reg), int(num_iters), stream)
    _build.check(err, "scx_sinkhorn_fused")
    _build.LAUNCHES["sinkhorn_fused"] += 1
    return plan, f, g


def sinkhorn_plan_fused(s, d, Mn, reg: float, num_iters: int):
    """Batched Sinkhorn plans and potentials.

    Args:
        s: (B, S) supplies, d: (B, D) demands, Mn: (B, S, D) costs.
        reg: absolute regularisation, one value for the whole batch (the
            caller folds per-instance eps into Mn).

    Returns:
        (plan (B, S, D), f (B, S), g (B, D)).  A CUDA tensor runs the
        kernel; a CPU tensor runs the plain version.
    """
    if Mn.is_cuda:
        return _sinkhorn_fused_cuda(s, d, Mn, reg, num_iters)
    if Mn.device.type != "cpu":
        raise ValueError(f"sinkhorn_plan_fused: no kernel for {Mn.device}")
    return sinkhorn_plan_fused_plain(s, d, Mn, reg, num_iters)
