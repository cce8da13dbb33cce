"""Batched PDHG: a first-order warm-start engine for LP fleets.

Port of ``smart_crossover_tpu/solvers/pdhg_batched.py``.  Equality form
``min c'x s.t. Ax = b, l <= x <= u`` per instance, a fixed iteration count
(the fleet runs in lockstep), the PDLP adaptive step rule per instance
(omega = 1), and both the last iterate and the step-weighted average.

* ``pdhg_fixed_batched_plain``: the JAX package's vmapped XLA oracle
  (``_pdhg_fixed_batched``) with the vmap written out as a batch dimension.
* ``pdhg_dense_batched``: on a CUDA tensor one launch of the hand-written
  kernel (``csrc/pdhg_cluster.cu``, replacing the TPU kernel
  ``_batched_pdhg_kernel``; one thread-block cluster per instance holds
  its A in shared memory and loops over every iteration,
  ``ops/pdhg_cluster.py`` plans the layout); on a CPU tensor the plain
  version.  The JAX package took the
  Pallas kernel only when asked (``use_pallas``, ``block_b``); the port
  reads ``use_pallas`` as its choice between the kernel and the plain
  version (``config.use_kernel``: by default the kernel on a card), takes
  ``block_b`` as a no-op, and has no VMEM gate ``batched_pdhg_pallas_ok``.
"""
from __future__ import annotations

import torch

from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch.config import (
    SMEM_PER_BLOCK, resolve_device, to_device, use_kernel)
from smart_crossover_tpu_torch.ops.pdhg_cluster import (
    ADAPTIVE,
    cluster_plan_on_card,
)


def _opnorms(A, iters: int = 30):
    """Batched power iteration for ||A_i||_2, (B, m, n) -> (B,), from the
    all-ones start (deterministic: it matches the JAX package exactly)."""
    B, m, n = A.shape
    v = torch.ones((B, n), dtype=A.dtype, device=A.device) \
        / torch.sqrt(torch.tensor(float(n), dtype=A.dtype, device=A.device))
    for _ in range(iters):
        w = torch.einsum("bmn,bn->bm", A, v)
        z = torch.einsum("bmn,bm->bn", A, w)
        v = z / (torch.linalg.norm(z, dim=1, keepdim=True) + 1e-30)
    w = torch.einsum("bmn,bn->bm", A, v)
    return torch.linalg.norm(w, dim=1) + 1e-12


def pdhg_fixed_batched_plain(A, b, c, l, u, opnorm, x0, y0, iters: int):
    """Plain tensor version: ``iters`` adaptive PDHG iterations for every
    instance at once.  Returns (x, y, x_avg, y_avg)."""
    def col(v):                  # per-instance scalar against a vector
        return v[:, None]

    x, y = x0, y0
    Ax = torch.einsum("bmn,bn->bm", A, x0)
    xs, ys = torch.zeros_like(x0), torch.zeros_like(y0)
    eta = 0.9 / opnorm
    wsum = torch.zeros_like(eta)
    lo, hi = 1e-10 / opnorm, 1e10 / opnorm
    for k in range(iters):
        aty = torch.einsum("bmn,bm->bn", A, y)
        x_c = torch.minimum(torch.maximum(x - col(eta) * (c - aty), l), u)
        Ax_c = torch.einsum("bmn,bn->bm", A, x_c)
        y_c = y + col(eta) * (b - (2.0 * Ax_c - Ax))
        dx = x_c - x
        dy = y_c - y
        curv = torch.abs((dy * (Ax_c - Ax)).sum(1))
        nz = (dx * dx).sum(1) + (dy * dy).sum(1)
        eta_bar = torch.where(curv > 0, nz / (2.0 * curv), hi)
        accept = eta <= eta_bar
        # PDLP schedule index k + 2 for 0-based k, k^-p as exp(-p log k)
        logk1 = torch.log(torch.tensor(k + 2.0, dtype=A.dtype,
                                       device=A.device))
        eta_next = torch.minimum((1.0 - torch.exp(-0.3 * logk1)) * eta_bar,
                                 (1.0 + torch.exp(-0.6 * logk1)) * eta)
        eta_next = torch.minimum(torch.maximum(eta_next, lo), hi)
        x = torch.where(col(accept), x_c, x)
        y = torch.where(col(accept), y_c, y)
        Ax = torch.where(col(accept), Ax_c, Ax)
        w = torch.where(accept, eta, 0.0)
        xs = xs + col(w) * x
        ys = ys + col(w) * y
        wsum = wsum + w
        eta = eta_next
    safe = col(torch.where(wsum > 0, wsum, 1.0))
    return x, y, xs / safe, ys / safe


def _check(name, t, shape):
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous() \
            or tuple(t.shape) != shape:
        raise ValueError(f"pdhg_dense_batched: {name} must be a contiguous "
                         f"float32 CUDA tensor of shape {shape}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def pdhg_batched_cuda(A, b, c, l, u, opnorm, iters: int, *,
                      smem_budget: int = SMEM_PER_BLOCK,
                      cluster_size: int | None = None):
    """One cluster launch of the batched kernel from x0 = clip(0, l, u),
    y0 = 0.  ``smem_budget`` and ``cluster_size`` reach
    ``pdhg_cluster_plan`` (tests and timing scripts force layouts with
    them); a layout that does not fit raises.  Returns (x, y, x_avg,
    y_avg)."""
    B, m, n = A.shape
    _check("A", A, (B, m, n))
    _check("b", b, (B, m))
    for name, v in (("c", c), ("l", l), ("u", u)):
        _check(name, v, (B, n))
    _check("opnorm", opnorm, (B,))
    lib, plan = cluster_plan_on_card("pdhg_batched", ADAPTIVE, A, B, m, n,
                                     smem_budget, cluster_size)
    x, xa = torch.empty_like(c), torch.empty_like(c)
    y, ya = torch.empty_like(b), torch.empty_like(b)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        err = lib.scx_pdhg_batched(
            A.data_ptr(), b.data_ptr(), c.data_ptr(), l.data_ptr(),
            u.data_ptr(), opnorm.data_ptr(), x.data_ptr(), y.data_ptr(),
            xa.data_ptr(), ya.data_ptr(), B, m, n, int(iters),
            plan["cluster_size"], plan["n_res"], int(plan["scatter"]),
            stream)
    _build.check(err, "scx_pdhg_batched")
    _build.LAUNCHES["pdhg_batched"] += 1
    return x, y, xa, ya


def pdhg_dense_batched(A, b, c, l, u, iters: int = 2000,
                       use_pallas: bool | None = None,
                       block_b: int | None = None, *, device=None):
    """Fleet PDHG warm starts: (B, m, n) equality-form LPs.

    Args:
        A: (B, m, n); b: (B, m); c, l, u: (B, n), numpy arrays or tensors.
        use_pallas: the kernel (None on a card, or True) or the plain
            version (False, or None on the CPU); True without a card raises.
        block_b: the JAX package's instances per Pallas grid step; a
            no-op here (one cluster per instance).
        device: where to run (default: A's device if A is a tensor, else
            the CUDA card; without one that default raises).  CUDA runs the
            kernel in float32; ``device="cpu"`` runs the plain version in
            A's dtype.

    Returns dict with x, y (last iterates), x_avg, y_avg (step-weighted
    averages, usually the better warm start), all (B, .) tensors on the
    device, and opnorm (B,) as numpy.
    """
    dev = resolve_device(device, A)
    A = to_device(A, dev)
    b, c, l, u = (to_device(v, dev, A.dtype) for v in (b, c, l, u))
    if A.device.type not in ("cuda", "cpu"):
        raise ValueError(f"pdhg_dense_batched: no kernel for {A.device}")
    opnorm = _opnorms(A)
    if use_kernel(use_pallas, A.device):
        x, y, xa, ya = pdhg_batched_cuda(A, b, c, l, u, opnorm, iters)
    else:
        x0 = torch.minimum(torch.maximum(torch.zeros_like(c), l), u)
        y0 = torch.zeros_like(b)
        x, y, xa, ya = pdhg_fixed_batched_plain(A, b, c, l, u, opnorm,
                                                x0, y0, iters)
    return {"x": x, "y": y, "x_avg": xa, "y_avg": ya,
            "opnorm": opnorm.cpu().numpy()}
