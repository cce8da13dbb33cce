"""Chunks of single-instance PDHG: CUDA kernels and their plain versions.

Replaces the TPU kernels of ``smart_crossover_tpu/ops/pdhg_pallas.py``:
``_pdhg_chunk_kernel`` (the ``fn`` of ``get_pdhg_chunk_fn``) and
``_halpern_chunk_kernel`` (the ``fn`` of ``get_halpern_chunk_fn``).  The
wrappers take and return what those ``fn``s do, with the chunk length as a
keyword: 1-D vectors and the scalar state.

* ``pdhg_chunk``: ``chunk`` iterations of adaptive-step PDLP PDHG
  (``solvers/pdhg.py::_pdhg_core.one_iter``), with the step-weighted sums
  xs, ys, wsum; ``k`` is the global iteration count (the step schedule's
  index is k + 2).
* ``halpern_chunk``: ``chunk`` iterations of reflected-Halpern PDHG with a
  fixed step (``_pdhg_core_halpern.one_iter``); ``k`` counts iterations since
  the last restart and sets the Halpern weight (k + 1) / (k + 2).  The
  anchors xa, ya, Axa are read, never written.

On the H100 each runs as one cluster launch per chunk
(``csrc/pdhg_cluster.cu``; ``pdhg_chunk`` shares its kernel with the fleet
kernel): a thread-block cluster of up to 16 blocks holds the rows of A in
shared memory for the chunk; ``ops/pdhg_cluster.py::pdhg_cluster_plan``
picks the layout.  ``pdhg_chunk`` takes two cluster barriers per iteration
(three with the scatter combine), ``halpern_chunk``, which has no step
rule and always combines by the scatter, two.  The TPU's (8, 128) padding and VMEM gate
(``pad_lp_for_pallas``, ``pdhg_pallas_ok``) have no counterpart: the
kernels take any (m, n).  A CUDA tensor launches the kernel or raises; a
CPU tensor runs the plain version.
"""
from __future__ import annotations

import torch

from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch.config import SMEM_PER_BLOCK
from smart_crossover_tpu_torch.ops.pdhg_cluster import (
    ADAPTIVE,
    HALPERN,
    cluster_plan_on_card,
)


def _as_scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def pdhg_chunk_plain(A, b, c, l, u, eq, x, y, Ax, xs, ys,
                     wsum, eta, omega, k, opnorm, chunk: int = 64):
    """Plain tensor version of ``pdhg_chunk``: the XLA oracle's
    ``one_iter`` (``k ** -0.3`` as written there), ``chunk`` times."""
    is_eq = eq if eq.dtype == torch.bool else eq > 0
    wsum, eta, omega, opnorm = (_as_scalar(v, A)
                                for v in (wsum, eta, omega, opnorm))
    k0 = _as_scalar(k, A)
    lo, hi = 1e-10 / opnorm, 1e10 / opnorm
    for i in range(chunk):
        tau = eta / omega
        sigma = eta * omega
        x_c = torch.minimum(torch.maximum(x - tau * (c - A.T @ y), l), u)
        Ax_c = A @ x_c
        y_t = y + sigma * (b - (2.0 * Ax_c - Ax))
        y_c = torch.where(is_eq, y_t, torch.clamp(y_t, max=0.0))
        dx = x_c - x
        dy = y_c - y
        curv = torch.abs(dy @ (Ax_c - Ax))
        nz = omega * (dx @ dx) + (dy @ dy) / omega
        eta_bar = torch.where(curv > 0, nz / (2.0 * curv), hi)
        accept = eta <= eta_bar
        ks = k0 + (i + 2)
        eta_next = torch.minimum((1.0 - ks ** -0.3) * eta_bar,
                                 (1.0 + ks ** -0.6) * eta)
        eta_next = torch.minimum(torch.maximum(eta_next, lo), hi)
        x = torch.where(accept, x_c, x)
        y = torch.where(accept, y_c, y)
        Ax = torch.where(accept, Ax_c, Ax)
        w = torch.where(accept, eta, torch.zeros_like(eta))
        xs = xs + w * x
        ys = ys + w * y
        wsum = wsum + w
        eta = eta_next
    return x, y, Ax, xs, ys, wsum, eta


def halpern_chunk_plain(A, b, c, l, u, eq, x, y, Ax, xa, ya, Axa,
                        omega, k, step, chunk: int = 64):
    """Plain tensor version of ``halpern_chunk`` (the XLA oracle's
    ``_pdhg_core_halpern.one_iter``, ``chunk`` times)."""
    is_eq = eq if eq.dtype == torch.bool else eq > 0
    omega, step, k = (_as_scalar(v, A) for v in (omega, step, k))
    tau = step / omega
    sigma = step * omega
    for _ in range(chunk):
        x_t = torch.minimum(torch.maximum(x - tau * (c - A.T @ y), l), u)
        Ax_t = A @ x_t
        y_t0 = y + sigma * (b - (2.0 * Ax_t - Ax))
        y_t = torch.where(is_eq, y_t0, torch.clamp(y_t0, max=0.0))
        lam = (k + 1.0) / (k + 2.0)
        x = lam * (2.0 * x_t - x) + (1.0 - lam) * xa
        y = lam * (2.0 * y_t - y) + (1.0 - lam) * ya
        Ax = lam * (2.0 * Ax_t - Ax) + (1.0 - lam) * Axa
        k = k + 1.0
    return x, y, Ax, k


def _check(fn: str, name: str, t: torch.Tensor, shape) -> None:
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous() \
            or tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} must be a contiguous float32 CUDA "
                         f"tensor of shape {shape}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _scalars(like: torch.Tensor, *vals) -> torch.Tensor:
    """The scalar state as one float32 device vector (no host sync for
    values that are already device tensors)."""
    out = torch.zeros(8, dtype=torch.float32, device=like.device)
    for i, v in enumerate(vals):
        out[i] = v
    return out


def _vectors(fn, A, eq, **vecs):
    m, n = A.shape
    _check(fn, "A", A, (m, n))
    eq = eq.to(torch.float32) if eq.dtype == torch.bool else eq
    _check(fn, "eq", eq, (m,))
    for name, v in vecs.items():
        _check(fn, name, v, (n,) if name in ("c", "l", "u", "x", "xs", "xa")
               else (m,))
    return m, n, eq


def _pdhg_chunk_cuda(A, b, c, l, u, eq, x, y, Ax, xs, ys,
                     wsum, eta, omega, k, opnorm, chunk, smem_budget,
                     cluster_size):
    m, n, eq = _vectors("pdhg_chunk", A, eq, b=b, c=c, l=l, u=u, x=x, y=y,
                        Ax=Ax, xs=xs, ys=ys)
    lib, plan = cluster_plan_on_card("pdhg_chunk", ADAPTIVE, A, 1, m, n,
                                     smem_budget, cluster_size)
    xs_o, ys_o = xs.clone(), ys.clone()
    scal_in = _scalars(A, wsum, eta, omega, k, opnorm)
    scal_out = torch.zeros_like(scal_in)
    x_o, y_o, ax_o = torch.empty_like(x), torch.empty_like(y), \
        torch.empty_like(Ax)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        err = lib.scx_pdhg_chunk(
            A.data_ptr(), b.data_ptr(), c.data_ptr(), l.data_ptr(),
            u.data_ptr(), eq.data_ptr(), x.data_ptr(), y.data_ptr(),
            Ax.data_ptr(), xs_o.data_ptr(), ys_o.data_ptr(),
            scal_in.data_ptr(), scal_out.data_ptr(), x_o.data_ptr(),
            y_o.data_ptr(), ax_o.data_ptr(), m, n, int(chunk),
            plan["cluster_size"], plan["n_res"], int(plan["scatter"]),
            stream)
    _build.check(err, "scx_pdhg_chunk")
    _build.LAUNCHES["pdhg_chunk"] += 1
    return x_o, y_o, ax_o, xs_o, ys_o, scal_out[0], scal_out[1]


def _halpern_chunk_cuda(A, b, c, l, u, eq, x, y, Ax, xa, ya, Axa,
                        omega, k, step, chunk, smem_budget, cluster_size):
    m, n, eq = _vectors("halpern_chunk", A, eq, b=b, c=c, l=l, u=u, x=x,
                        y=y, Ax=Ax, xa=xa, ya=ya, Axa=Axa)
    lib, plan = cluster_plan_on_card("halpern_chunk", HALPERN, A, 1, m, n,
                                     smem_budget, cluster_size)
    scal_in = _scalars(A, omega, k, step)
    scal_out = torch.zeros_like(scal_in)
    x_o, y_o, ax_o = torch.empty_like(x), torch.empty_like(y), \
        torch.empty_like(Ax)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        err = lib.scx_halpern_chunk(
            A.data_ptr(), b.data_ptr(), c.data_ptr(), l.data_ptr(),
            u.data_ptr(), eq.data_ptr(), x.data_ptr(), y.data_ptr(),
            Ax.data_ptr(), xa.data_ptr(), ya.data_ptr(), Axa.data_ptr(),
            scal_in.data_ptr(), scal_out.data_ptr(), x_o.data_ptr(),
            y_o.data_ptr(), ax_o.data_ptr(), m, n, int(chunk),
            plan["cluster_size"], plan["n_res"], stream)
    _build.check(err, "scx_halpern_chunk")
    _build.LAUNCHES["halpern_chunk"] += 1
    return x_o, y_o, ax_o, scal_out[1]


def pdhg_chunk(A, b, c, l, u, eq, x, y, Ax, xs, ys,
               wsum, eta, omega, k, opnorm, chunk: int = 64, *,
               smem_budget: int = SMEM_PER_BLOCK,
               cluster_size: int | None = None):
    """``chunk`` adaptive PDHG iterations.

    Args:
        A: (m, n); b, eq, y, Ax, ys: (m,); c, l, u, x, xs: (n,) tensors.
            eq is 1.0 (or True) on '=' rows.
        wsum, eta, omega, k, opnorm: scalars (numbers or 0-d tensors).
        smem_budget, cluster_size: reach ``pdhg_cluster_plan`` (tests and
            timing scripts force layouts with them); a layout that does
            not fit raises.

    Returns (x, y, Ax, xs, ys, wsum, eta).
    """
    if A.is_cuda:
        return _pdhg_chunk_cuda(A, b, c, l, u, eq, x, y, Ax, xs, ys,
                                wsum, eta, omega, k, opnorm, chunk,
                                smem_budget, cluster_size)
    if A.device.type != "cpu":
        raise ValueError(f"pdhg_chunk: no kernel for {A.device}")
    return pdhg_chunk_plain(A, b, c, l, u, eq, x, y, Ax, xs, ys,
                            wsum, eta, omega, k, opnorm, chunk)


def halpern_chunk(A, b, c, l, u, eq, x, y, Ax, xa, ya, Axa,
                  omega, k, step, chunk: int = 64, *,
                  smem_budget: int = SMEM_PER_BLOCK,
                  cluster_size: int | None = None):
    """``chunk`` reflected-Halpern PDHG iterations around the anchor
    (xa, ya, Axa).

    Args:
        A: (m, n); b, eq, y, Ax, ya, Axa: (m,); c, l, u, x, xa: (n,)
            tensors.  eq is 1.0 (or True) on '=' rows.
        omega, k, step: scalars (numbers or 0-d tensors).
        smem_budget, cluster_size: reach ``pdhg_cluster_plan`` (tests and
            timing scripts force layouts with them); a layout that does
            not fit raises.

    Returns (x, y, Ax, k + chunk).
    """
    if A.is_cuda:
        return _halpern_chunk_cuda(A, b, c, l, u, eq, x, y, Ax, xa, ya, Axa,
                                   omega, k, step, chunk, smem_budget,
                                   cluster_size)
    if A.device.type != "cpu":
        raise ValueError(f"halpern_chunk: no kernel for {A.device}")
    return halpern_chunk_plain(A, b, c, l, u, eq, x, y, Ax, xa, ya, Axa,
                               omega, k, step, chunk)
