"""Carry the JAX package's state across to the port.

The system has no weights; what crosses over is an instance batch (an OT
batch or an LP) and the intermediate state the JAX pipeline produced.  ``from_reference`` turns
those arrays (as numpy, e.g. ``np.asarray`` of JAX arrays) into the port's
tensors with their dtypes kept, so a test can feed a port stage exactly
the reference's input to that stage.
"""
from __future__ import annotations

import numpy as np
import torch

#: OT instance batch (s, d, M); warm start (X0, Bm); mega setup state
#: (parent, N, dep, w, Xv); an LP (A, b, c, l, u) and the PDHG state
#: (x, y, Ax, step-weighted sums xs, ys, Halpern anchors xa, ya, Axa, and
#: the operator norm opnorm)
NAMES = ("s", "d", "M", "X0", "Bm", "parent", "N", "dep", "w", "Xv",
         "A", "b", "c", "l", "u", "x", "y", "Ax", "xs", "ys", "xa", "ya",
         "Axa", "opnorm")


def from_reference(device="cpu", **arrays) -> dict:
    """Tensors on ``device`` from the reference's numpy arrays, keyed as
    given.  Unknown names raise, so a misspelt key cannot pass silently."""
    unknown = sorted(set(arrays) - set(NAMES))
    if unknown:
        raise ValueError(f"from_reference: unknown arrays {unknown}; "
                         f"expected some of {NAMES}")
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}
