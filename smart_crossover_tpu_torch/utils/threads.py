"""Single-thread-BLAS guard for host BLAS1-dominated loops.

Host copy of ``smart_crossover_tpu/utils/threads.py``.

Threaded OpenBLAS pays its thread-pool synchronisation on EVERY call;
for the thin vector ops that dominate the host simplex pivot loop and
the Krylov solvers (ddot/axpy on 30k-130k vectors) the sync is the whole
cost: measured 12.1 ms vs 6.6 us for one 31.5k ddot on a 4-core host —
~0.2 s/pivot of pure sync at optLP scale (the round-4 mcom/cover
crossover wall).  Nothing under these guards is BLAS3, so one thread is
uniformly faster.  (BLAS3-heavy paths — the IPM's dense normal
equations — manage their own limits; see solvers/ipm.py.)
"""
from __future__ import annotations

import functools

try:
    from threadpoolctl import threadpool_limits as _tp_limits
except ImportError:  # pragma: no cover - threadpoolctl ships with scipy
    import contextlib

    def _tp_limits(*_a, **_k):
        return contextlib.nullcontext()


def single_thread_blas(fn):
    """Decorator: run ``fn`` under a 1-thread BLAS limit."""
    @functools.wraps(fn)
    def wrapped(*a, **k):
        with _tp_limits(limits=1, user_api="blas"):
            return fn(*a, **k)
    return wrapped
