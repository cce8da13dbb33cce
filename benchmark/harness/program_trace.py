"""Readers of the port's own tracer (``smart_crossover_tpu_torch.utils.
trace``): its spans record only while a profiler runs, so in a
``--trace 1`` run its buffer holds the traced stretch alone (the window's
first ``trace_requests`` requests).  Each time is a mean per request: the
stretch's total over the calls of the cell's root span (``scx.route``,
``scx.network_crossover``).  A span's device time is the seconds between
its CUDA events, its host seconds where it has none (on the CPU).  A
reader returns None where the record lacks a span it reads, as in a
checkout of the port from before the tracer."""
from __future__ import annotations


def summary() -> dict | None:
    try:
        from smart_crossover_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.summary()


def _seconds(span: dict, clock: str) -> float:
    if clock == "event" and span["event_s"] is not None:
        return span["event_s"]
    return span["host_s"]


def span_per_request(names, root: str, scale: float, clock: str = "host"):
    """scale x the summed seconds of the spans ``names`` over the calls of
    ``root``; ``clock`` 'event' or 'host'."""
    s = summary()
    if not s or root not in s or any(n not in s for n in names):
        return None
    return scale * sum(_seconds(s[n], clock) for n in names) \
        / s[root]["calls"]


def counter_per_request(name: str, root: str):
    """The counter ``name`` inside ``root`` over the calls of ``root``."""
    s = summary()
    if not s or root not in s or name not in s[root]["counters"]:
        return None
    return s[root]["counters"][name] / s[root]["calls"]


def span_per_count(span: str, counter: str, scale: float,
                   clock: str = "event"):
    """scale x the seconds of ``span`` over the counter ``counter`` inside
    it."""
    s = summary()
    if not s or span not in s or not s[span]["counters"].get(counter):
        return None
    return scale * _seconds(s[span], clock) / s[span]["counters"][counter]
