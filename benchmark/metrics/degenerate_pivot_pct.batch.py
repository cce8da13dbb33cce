"""The share of K2's pivots that moved no flow (ratio theta <= 1e-12), in
percent: the program's counters ``k2.degenerate`` over ``k2.pivots`` in
``scx.route`` over the traced stretch."""
from benchmark.harness.k2_trace import degenerate_pct


def read(run):
    return degenerate_pct()
