"""The work of one launch of the Sinkhorn kernel K1, fixed by the shapes
and the caller's iteration count (a frozen copy of ``chip_smoke.py``'s
``sinkhorn_work``), and K1's share of its roofline."""
from __future__ import annotations

from benchmark.roofline import peaks

KERNEL = "sinkhorn_cluster_kernel"


def sinkhorn_work(B: int, S: int, D: int, iters: int) -> tuple:
    """Per cell and half-iteration: (g - M) / reg, max, subtract, add
    around one exp; the plan 3 more and one exp.  M, s, d in and plan,
    f, g out, once, in float32.  Returns (operations, bytes, exps)."""
    cells = B * S * D
    return (cells * (10 * iters + 3),
            4 * (2 * cells + 2 * B * (S + D)),
            cells * (2 * iters + 1))


def roofline_pct(run):
    """100 x the least time of the traced stretch's K1 launches over
    their device time.  Each request of the stretch records the (B, S, D)
    of its one launch under ``k1_shape``; None where the trace holds no
    K1 launch or not one launch for each of those requests."""
    if run.trace is None or run.device_info is None:
        return None
    sec, count = run.trace.total_s(KERNEL)
    if not count:
        return None
    n = run.traffic["trace_requests"]
    shapes = [c.get("k1_shape") for c in run.counters[:n] if c]
    if count != len(shapes) or None in shapes:
        return None
    iters = run.config["sinkhorn_iters"]
    bound = sum(peaks.bound_s(*sinkhorn_work(*shape, iters),
                              run.device_info) for shape in shapes)
    return 100.0 * bound / sec
