"""Precision / device policy for the PyTorch port.

The numerics split of the JAX package (``smart_crossover_tpu/config.py``)
carries over, with the certificate of a batch's bases on the card:

* approximate, massively-parallel work (Sinkhorn, flow ranking, Borůvka,
  tree push, the device transportation simplex) runs in the *device*
  dtype — float32 on a CUDA card; on the CPU the input's own dtype, so the
  tests can hold the port to the JAX package in float64;
* exactness-critical work (optimality certificates) runs in float64: on
  the host with numpy / scipy, except the batched OT certificate, which a
  CUDA card runs natively in float64 (``csrc/certify.cu``), independent of
  the route it certifies.
"""
from __future__ import annotations

import numpy as np
import torch

HOST_FLOAT = np.float64

# Hopper: the most shared memory one block may use, static and dynamic,
# and the SM count of an H100 SXM (the kernels' cluster plans assume it
# where no card is asked)
SMEM_PER_BLOCK = 232_448
SMS = 132


def split_rows(n: int, C: int):
    """Row ranges of a cluster's C ranks: rank q owns [q*n//C, (q+1)*n//C)
    (the kernels' ``lo_row``)."""
    return [(q * n // C, (q + 1) * n // C) for q in range(C)]


def resolve_device(device=None, like=None) -> torch.device:
    """``device`` if given, else the device of the tensor ``like``, else
    the CUDA card.  Without a card that default raises: the entry points
    run on the CPU only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain versions on the CPU")
    return torch.device("cuda")


def device_float(device, dtype=torch.float64) -> torch.dtype:
    """Float dtype for device computation: float32 on CUDA, ``dtype`` (the
    input's float dtype) elsewhere."""
    if torch.device(device).type == "cuda":
        return torch.float32
    return dtype


def to_device(x, device, dtype=None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device`` in the device float
    dtype (``dtype`` overrides)."""
    t = torch.as_tensor(x)
    if dtype is None:
        dtype = device_float(device, t.dtype if t.is_floating_point()
                             else torch.float64)
    return t.to(device=device, dtype=dtype).contiguous()


def use_kernel(use_pallas, device) -> bool:
    """The port's reading of the JAX package's ``use_pallas``: the choice
    between a hand-written kernel and its plain version.  None takes the
    kernel where there is one (a CUDA card), True asks for it and raises
    elsewhere, False runs the plain version on any device."""
    dev = torch.device(device)
    if use_pallas is None:
        return dev.type == "cuda"
    if use_pallas and dev.type != "cuda":
        raise ValueError(f"use_pallas=True asks for the CUDA kernel, and "
                         f"there is none on {dev}")
    return bool(use_pallas)
