"""Readers of K2's own counters in the port's tracer (``k2.pivots``,
``k2.degenerate``, counted in ``scx.simplex_kernel`` while the tracer
records), over the traced stretch's calls of ``scx.route``.  Each returns
None where the record lacks them, as in a checkout of the port from
before K2 counted them."""
from __future__ import annotations

from benchmark.harness.program_trace import counter_per_request, summary

ROOT = "scx.route"


def degenerate_pct():
    """100 x the degenerate pivots over all pivots."""
    s = summary()
    c = s.get(ROOT, {}).get("counters", {}) if s else {}
    if not c.get("k2.pivots") or "k2.degenerate" not in c:
        return None
    return 100.0 * c["k2.degenerate"] / c["k2.pivots"]


def pivots_per_instance(run):
    """The pivots of a batch over its instances."""
    n = counter_per_request("k2.pivots", ROOT)
    return None if n is None else n / run.traffic["batch"]
