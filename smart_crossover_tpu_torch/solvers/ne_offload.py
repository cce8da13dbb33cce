"""Device offload of the host IPM's dense normal-equations formation.

Port of ``smart_crossover_tpu/solvers/ne_offload.py``.  For mid-size LPs
the host cost of one Mehrotra iteration splits between forming
``M = A diag(d) A'`` (a sparse matmat that fills in almost completely) and
factoring it.  The formation is a plain GEMM: with A resident on the card
once per solve, each iteration ships only d (n floats) down and M (m^2
floats) back.  ``ipm_solve`` uses the card while mu > 1e-6.

Accuracy: the JAX package forms M in float32 (relative entry error ~1e-7).
That stalls the host IPM: on ``random_sparse_lp(1200, 4800, seed=2)`` both
packages end STALLED far from the optimum with a float32 M, where the host
product reaches OPTIMAL (ROADMAP 3.10).  The entries of M sum terms whose
scales d spreads over many orders, so a float32 sum loses the small
eigenvalues long before mu reaches 1e-6.  The port forms M in float64
(the card computes float64), where TF32 plays no part.

Opt-in, as in the JAX package: a CUDA card (the JAX package asks for a
TPU) and ``SCX_NE_OFFLOAD=1``, for 1024 <= m <= 4096 with A's float64
buffer on the card within 4 GiB (the JAX package's bound of 2 GiB on its
float32 copy).  Unlike the JAX package, ``maybe_device_ne`` returns None
only for those documented reasons: a device error while A is moved to the
card raises instead of falling back silently to the host.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from smart_crossover_tpu_torch.config import resolve_device

_MAX_BYTES = 4 << 30    # cap of A's float64 buffer on the card (8 m n bytes)


def _enabled() -> bool:
    return torch.cuda.is_available() \
        and os.environ.get("SCX_NE_OFFLOAD") == "1"


class DeviceNE:
    """Keeps dense float64 A on the device; forms A diag(d) A' per call."""

    def __init__(self, A_csr, *, device=None):
        self.device = resolve_device(device)
        m, n = A_csr.shape
        self.shape = (m, n)
        A = np.asarray(A_csr.todense(), dtype=np.float64)
        self._A = torch.as_tensor(A, device=self.device)
        self.forms = 0          # calls of form(), read by timing scripts

    def form(self, d: np.ndarray) -> np.ndarray:
        """M = A diag(d) A' as a dense f64 host array."""
        dt = torch.as_tensor(np.asarray(d, np.float64), device=self.device)
        M = torch.matmul(self._A * dt[None, :], self._A.T)
        self.forms += 1
        return M.cpu().numpy()


def maybe_device_ne(A_csr) -> DeviceNE | None:
    """A DeviceNE for this matrix on the CUDA card, or None when the offload
    is off (no card, or ``SCX_NE_OFFLOAD`` unset) or A is outside the size
    band."""
    if not _enabled():
        return None
    m, n = A_csr.shape
    if m > 4096 or 8 * m * n > _MAX_BYTES or m < 1024:
        return None
    return DeviceNE(A_csr)
