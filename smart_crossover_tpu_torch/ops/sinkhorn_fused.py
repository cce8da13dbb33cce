"""Fused batched log-domain Sinkhorn: CUDA kernel and its plain version.

Replaces the TPU kernel ``smart_crossover_tpu/ops/sinkhorn_pallas.py::
_sinkhorn_kernel`` (wrapper ``sinkhorn_plan_pallas``).  Same math: per
instance, ``num_iters`` rounds of

    f = reg * (log s - LSE_j((g - M) / reg))
    g = reg * (log d - LSE_i((f - M) / reg))

each LSE taken max-first, then the plan exp((f + g - M) / reg).  The
wrapper returns (plan, f, g): the potentials cost nothing extra and let
the exact pipeline consume them.

The TPU kernel pins M in VMEM for all iterations; the H100 kernel
(``csrc/sinkhorn.cu``) pins it in the shared memory of a thread-block
cluster.  One block's 227 KB cannot hold a 256^2 instance (256 KB), but a
cluster of C blocks can: rank q owns rows ``split_rows(S, C)[q]`` of M_b and
keeps as many of them as fit in its shared memory for the whole solve
(the rest are read from L2 behind the same row loop).  The row half needs
no exchange; the column half combines per-rank partial maxima, then
per-rank partial sums in rank order, through distributed shared memory.
The whole solve is one launch.  ``sinkhorn_cluster_plan`` picks C and the
layout, ``sinkhorn_plan_fused_split`` is the rank decomposition in tensor
form, for the tests.  No TPU tiling gate: any S and D.
"""
from __future__ import annotations

import torch

from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch.config import SMEM_PER_BLOCK, SMS, split_rows

_RED_FLOATS = 4096       # the kernel's row-group scratch (kRed), in floats
_CLUSTER_SIZES = tuple(range(1, 17))   # above 8: non-portable sizes

# plan of the last kernel launch, with the card's answer to how many of
# its clusters can be resident at once (read by chip_smoke.py)
LAST_LAUNCH: dict = {}
_MAX_ACTIVE: dict = {}


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


def sinkhorn_plan_fused_split(s, d, Mn, reg: float, num_iters: int, C: int):
    """The kernel's rank decomposition in tensor form: the plain version
    with each column LSE taken from C ranks' partials.  Rank q holds rows
    ``split_rows(S, C)[q]``; the column max is the max of the ranks' partial
    maxima, and the sum of exp(t - colmax) is the ranks' partial sums
    added in rank order 0..C-1 (a rank with no rows adds -inf and 0)."""
    inv_reg = 1.0 / reg
    log_s = torch.log(s)
    log_d = torch.log(d)
    f = torch.zeros_like(log_s)
    g = torch.zeros_like(log_d)
    ranges = split_rows(Mn.shape[1], C)
    for _ in range(num_iters):
        t = (g[:, None, :] - Mn) * inv_reg
        tmax = t.amax(2)
        f = reg * (log_s - (tmax + torch.log(
            torch.exp(t - tmax[:, :, None]).sum(2))))
        t2 = (f[:, :, None] - Mn) * inv_reg
        cmax = torch.full_like(log_d, -torch.inf)
        for lo, hi in ranges:
            if hi > lo:
                cmax = torch.maximum(cmax, t2[:, lo:hi].amax(1))
        total = torch.zeros_like(log_d)
        for lo, hi in ranges:
            total = total + torch.exp(t2[:, lo:hi] - cmax[:, None, :]).sum(1)
        g = reg * (log_d - (cmax + torch.log(total)))
    plan = torch.exp((f[:, :, None] + g[:, None, :] - Mn) * inv_reg)
    return plan, f, g


def sinkhorn_smem_bytes(S: int, D: int, C: int, n_res: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the CUDA
    source), float32 throughout: n_res resident rows of M, then g, log d,
    the column max and this rank's partial max and sum, each row and
    vector padded to Dp = D rounded up to 4; the row-group scratch; log s
    and f of ceil(S/C) rows; the total padded to 16."""
    Dp = -(-D // 4) * 4
    floats = n_res * Dp + 5 * Dp + _RED_FLOATS + 2 * (-(-S // C))
    return (4 * floats + 15) // 16 * 16


def sinkhorn_cluster_plan(B: int, S: int, D: int,
                          smem_budget: int = SMEM_PER_BLOCK,
                          sms: int = SMS, *, active=None,
                          cluster_size: int | None = None) -> dict:
    """How the kernel lays out a (B, S, D) batch: C blocks per instance.

    For each C in 1..16 (or ``cluster_size`` alone), rank q
    owns rows ``split_rows(S, C)[q]`` and keeps the first n_res of them in
    shared memory, n_res as large as ``smem_budget`` allows.
    ``active(C, n_res)`` is how many such clusters the card holds at once
    (the wrapper asks the card; without it, as in the CPU tests, the plan
    assumes one block per SM of ``sms``), so a batch runs in
    ceil(B / active) waves.  The plan takes the fewest waves, then the most
    of M in shared memory, then the largest C.  Raises ValueError where no
    C fits.
    """
    if cluster_size is not None and cluster_size not in _CLUSTER_SIZES:
        raise ValueError(f"sinkhorn_plan_fused: no cluster layout of size "
                         f"{cluster_size}; sizes are {_CLUSTER_SIZES}")
    best = None
    for C in ((cluster_size,) if cluster_size else _CLUSTER_SIZES):
        fixed = sinkhorn_smem_bytes(S, D, C, 0)
        if fixed > smem_budget:
            continue
        rmax = -(-S // C)
        n_res = min(rmax, (smem_budget - fixed) // (16 * -(-D // 4)))
        while sinkhorn_smem_bytes(S, D, C, n_res) > smem_budget:
            n_res -= 1
        smem = sinkhorn_smem_bytes(S, D, C, n_res)
        n_act = active(C, n_res) if active is not None else sms // C
        if n_act < 1:
            continue
        ranges = split_rows(S, C)
        resident = sum(min(hi - lo, n_res) for lo, hi in ranges)
        waves = -(-B // n_act)
        key = (waves, -resident, -C)
        if best is None or key < best[0]:
            best = (key, {
                "cluster_size": C, "row_ranges": ranges, "n_res": n_res,
                "rows_in_smem": resident, "m_in_smem": resident / S,
                "smem_bytes": smem, "max_active_clusters": n_act,
                "waves": waves})
    if best is None:
        raise ValueError(
            f"sinkhorn_plan_fused: no cluster layout fits {S} x {D} in "
            f"{smem_budget} bytes of shared memory per block (the "
            f"replicated vectors alone take {sinkhorn_smem_bytes(S, D, 16, 0)})")
    return best[1]


def _check(name, t, shape):
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous() \
            or tuple(t.shape) != shape:
        raise ValueError(f"sinkhorn_plan_fused: {name} must be a contiguous "
                         f"float32 CUDA tensor of shape {shape}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _active_clusters(lib, B, S, D):
    """The card's count of resident clusters for a layout, queried once
    per (S, D, C, n_res) and cached; 0 where the card refuses the cluster
    size."""
    def active(C, n_res):
        key = (S, D, C, n_res)
        if key not in _MAX_ACTIVE:
            n = lib.scx_sinkhorn_max_clusters(B, S, D, C, n_res)
            _MAX_ACTIVE[key] = max(n, 0)
        return _MAX_ACTIVE[key]
    return active


def _sinkhorn_fused_cuda(s, d, Mn, reg, num_iters, smem_budget, cluster_size):
    B, S, D = Mn.shape
    _check("Mn", Mn, (B, S, D))
    _check("s", s, (B, S))
    _check("d", d, (B, D))
    lib = _build.library()
    with torch.cuda.device(Mn.device):
        plan = sinkhorn_cluster_plan(
            B, S, D, smem_budget, active=_active_clusters(lib, B, S, D),
            cluster_size=cluster_size)
    C, n_res = plan["cluster_size"], plan["n_res"]
    smem = lib.scx_sinkhorn_smem_bytes(S, D, C, n_res)
    if smem != plan["smem_bytes"]:
        raise RuntimeError(f"sinkhorn_plan_fused: the kernel lays out {smem} "
                           f"bytes of shared memory, the plan "
                           f"{plan['smem_bytes']}")
    out = torch.empty_like(Mn)
    f = torch.empty_like(s)
    g = torch.empty_like(d)
    stream = torch.cuda.current_stream(Mn.device).cuda_stream
    with torch.cuda.device(Mn.device):
        err = lib.scx_sinkhorn_fused(
            s.data_ptr(), d.data_ptr(), Mn.data_ptr(), out.data_ptr(),
            f.data_ptr(), g.data_ptr(), B, S, D, float(reg), int(num_iters),
            C, n_res, stream)
    _build.check(err, "scx_sinkhorn_fused")
    _build.LAUNCHES["sinkhorn_fused"] += 1
    LAST_LAUNCH.clear()
    LAST_LAUNCH.update(plan, shape=[B, S, D])
    return out, f, g


def sinkhorn_plan_fused(s, d, Mn, reg: float, num_iters: int, *,
                        smem_budget: int = SMEM_PER_BLOCK,
                        cluster_size: int | None = None):
    """Batched Sinkhorn plans and potentials.

    Args:
        s: (B, S) supplies, d: (B, D) demands, Mn: (B, S, D) costs.
        reg: absolute regularisation, one value for the whole batch (the
            caller folds per-instance eps into Mn).
        smem_budget, cluster_size: reach ``sinkhorn_cluster_plan``
            (tests and timing scripts force layouts with them).

    Returns:
        (plan (B, S, D), f (B, S), g (B, D)).  A CUDA tensor runs the
        kernel; a CPU tensor runs the plain version.
    """
    if Mn.is_cuda:
        return _sinkhorn_fused_cuda(s, d, Mn, reg, num_iters, smem_budget,
                                    cluster_size)
    if Mn.device.type != "cpu":
        raise ValueError(f"sinkhorn_plan_fused: no kernel for {Mn.device}")
    return sinkhorn_plan_fused_plain(s, d, Mn, reg, num_iters)
