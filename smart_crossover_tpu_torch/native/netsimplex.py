"""ctypes bridge to the native network-simplex core (netsimplex.cpp).

Copy of ``smart_crossover_tpu/native/netsimplex.py``; the library comes
from ``native.library()``, which builds it at first use and raises where
it cannot.
"""
from __future__ import annotations

import ctypes
import datetime
import time

import numpy as np

from smart_crossover_tpu_torch.models import Basis
from smart_crossover_tpu_torch.native import library

_STATUS = {0: "OPTIMAL", 1: "INFEASIBLE", 2: "UNBOUNDED",
           3: "ITERATION_LIMIT", 4: "ERROR"}


def solve(mcf, warm_basis, max_iter: int, tol: float):
    from smart_crossover_tpu_torch.solvers.network_simplex import NetSimplexResult

    t0 = time.perf_counter()
    fn = library().scx_network_simplex
    m, n = mcf.m, mcf.n
    tails = np.ascontiguousarray(mcf.tails, dtype=np.int64)
    heads = np.ascontiguousarray(mcf.heads, dtype=np.int64)
    cost = np.ascontiguousarray(mcf.c, dtype=np.float64)
    cap = np.ascontiguousarray(mcf.u, dtype=np.float64)
    b = np.ascontiguousarray(mcf.b, dtype=np.float64)
    root = m - 1
    warm_ptr = None
    if warm_basis is not None:
        vb = np.ascontiguousarray(warm_basis.vbasis, dtype=np.int32)
        if vb.size != n:
            raise ValueError(f"warm basis has {vb.size} arc statuses, the "
                             f"instance {n} arcs")
        warm_ptr = vb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        if warm_basis.cbasis.size == m:
            basic_rows = np.where(warm_basis.cbasis == 0)[0]
            if basic_rows.size:
                root = int(basic_rows[0])
    x = np.zeros(n)
    y = np.zeros(m)
    vbasis = np.zeros(n, dtype=np.int32)
    iters = ctypes.c_int64(0)

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    def pi64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    code = fn(m, n, pi64(tails), pi64(heads), p64(cost), p64(cap), p64(b),
              warm_ptr, root, max_iter, tol,
              p64(x), p64(y), vbasis.ctypes.data_as(
                  ctypes.POINTER(ctypes.c_int32)),
              ctypes.byref(iters))
    status = _STATUS.get(code, "ERROR")
    rc = cost - y[heads] + y[tails]
    cbasis = np.full(m, -1, dtype=np.int32)
    cbasis[root] = 0
    return NetSimplexResult(
        x=x, y=y, obj_val=float(cost @ x), basis=Basis(vbasis, cbasis),
        rcost=rc, iter_count=int(iters.value), status=status,
        runtime=datetime.timedelta(seconds=time.perf_counter() - t0))
