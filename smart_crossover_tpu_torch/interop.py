"""Carry the JAX package's state across to the port.

The system has no weights; what crosses over is an instance batch (an OT
batch or an LP) and the intermediate state the JAX pipeline produced.  ``from_reference`` turns
those arrays (as numpy, e.g. ``np.asarray`` of JAX arrays) into the port's
tensors with their dtypes kept, so a test can feed a port stage exactly
the reference's input to that stage.  ``instance_from_reference`` turns
the JAX package's ``OptTransport``, ``MinCostFlow``, ``GeneralLP``,
``StandardLP`` or ``Basis`` into the port's, by their numpy and scipy
fields alone (the port never imports the JAX package).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from smart_crossover_tpu_torch.models import (
    Basis,
    GeneralLP,
    MinCostFlow,
    OptTransport,
    StandardLP,
)

#: OT instance batch (s, d, M); warm start (X0, Bm); mega setup state
#: (parent, N, dep, w, Xv); an LP (A, b, c, l, u), the PDHG state
#: (x, y, Ax, step-weighted sums xs, ys, Halpern anchors xa, ya, Axa, and
#: the operator norm opnorm) and the IPM's bound duals (zl, zu)
NAMES = ("s", "d", "M", "X0", "Bm", "parent", "N", "dep", "w", "Xv",
         "A", "b", "c", "l", "u", "x", "y", "Ax", "xs", "ys", "xa", "ya",
         "Axa", "opnorm", "zl", "zu")


def from_reference(device="cpu", **arrays) -> dict:
    """Tensors on ``device`` from the reference's numpy arrays, keyed as
    given.  Unknown names raise, so a misspelt key cannot pass silently."""
    unknown = sorted(set(arrays) - set(NAMES))
    if unknown:
        raise ValueError(f"from_reference: unknown arrays {unknown}; "
                         f"expected some of {NAMES}")
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def instance_from_reference(obj):
    """The port's ``OptTransport``, ``MinCostFlow``, ``GeneralLP``,
    ``StandardLP`` or ``Basis`` with the fields of ``obj``, an instance of
    the JAX package's class of that name (matched by its field names: s, d,
    M; tails, heads, c, u, b; A, b, c, l, u, sense; A, b, c, u; vbasis,
    cbasis).  A sparse A stays sparse.  Anything else raises TypeError."""
    def has(*names):
        return all(hasattr(obj, n) for n in names)

    def arr(name):
        return np.array(getattr(obj, name))

    name = getattr(obj, "name", None)
    if has("s", "d", "M"):
        kw = {} if name is None else {"name": name}
        return OptTransport(s=arr("s"), d=arr("d"), M=arr("M"), **kw)
    if has("tails", "heads", "c", "u", "b"):
        kw = {} if name is None else {"name": name}
        return MinCostFlow(tails=arr("tails"), heads=arr("heads"),
                           c=arr("c"), u=arr("u"), b=arr("b"), **kw)
    if has("A", "b", "c", "u"):
        A = obj.A.copy() if sp.issparse(obj.A) else arr("A")
        kw = {} if name is None else {"name": name}
        if has("sense", "l"):
            col_names = getattr(obj, "col_names", None)
            return GeneralLP(A=A, b=arr("b"), c=arr("c"), l=arr("l"),
                             u=arr("u"), sense=arr("sense"),
                             obj_offset=float(getattr(obj, "obj_offset",
                                                      0.0)),
                             col_names=None if col_names is None
                             else list(col_names), **kw)
        return StandardLP(A=A, b=arr("b"), c=arr("c"), u=arr("u"),
                          l=None if getattr(obj, "l", None) is None
                          else arr("l"), **kw)
    if has("vbasis", "cbasis"):
        return Basis(arr("vbasis"), arr("cbasis"))
    raise TypeError(f"instance_from_reference: {type(obj).__name__} is not "
                    "an OptTransport, MinCostFlow, GeneralLP, StandardLP or "
                    "Basis")
