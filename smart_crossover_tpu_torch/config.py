"""Precision / device policy for the PyTorch port.

The numerics split of the JAX package (``smart_crossover_tpu/config.py``)
carries over unchanged:

* approximate, massively-parallel work (Sinkhorn, flow ranking, Borůvka,
  tree push, the device transportation simplex) runs in the *device*
  dtype — float32 on a CUDA card; on the CPU the input's own dtype, so the
  tests can hold the port to the JAX package in float64;
* exactness-critical work (optimality certificates) runs on the host in
  float64 with numpy / scipy.
"""
from __future__ import annotations

import numpy as np
import torch

HOST_FLOAT = np.float64


def resolve_device(device=None, like=None) -> torch.device:
    """``device`` if given, else the device of the tensor ``like``, else
    the CPU."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    return torch.device("cpu")


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
