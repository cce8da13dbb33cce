"""Helpers the metric readers share.  A reader that finds nothing to
read returns None, and the harness leaves its metric out of the line."""
from __future__ import annotations


def span_mean(run, name: str, scale: float):
    xs = run.spans.get(name)
    return scale * sum(xs) / len(xs) if xs else None


def counter_mean(run, name: str):
    xs = [c[name] for c in run.counters if c and name in c]
    return sum(xs) / len(xs) if xs else None


def idle_pct(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
