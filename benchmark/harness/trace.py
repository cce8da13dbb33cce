"""Reading the device trace of the traced stretch.

From ``torch.profiler``'s raw (kineto) events, not ``prof.events()``,
whose event tree takes minutes to build over the 10^5 launches of a
warm start: the device activities (kernels, copies, sets; not the
``record_function`` ranges mirrored onto the device's timeline) clipped
to the stretch, their union (busy time), time by name, and the idle gaps
between them, each labelled by what the host was doing at its middle:
the innermost harness span and the innermost other host event.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from benchmark.harness.loop import STRETCH

LABELLED_GAPS = 20000     # the longest gaps get a label; the rest "other"
TOP = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)   # name -> [seconds, count]
    idle_gaps: list = field(default_factory=list)  # [label, seconds]

    def device_ops(self) -> list:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
        return [[name[:160], sec] for name, (sec, _) in top]

    def total_s(self, pattern: str) -> tuple:
        """(seconds, launches) of the kernels whose name holds
        ``pattern``."""
        sec = cnt = 0
        for name, (s, c) in self.kernels.items():
            if pattern in name:
                sec, cnt = sec + s, cnt + c
        return sec, cnt

    def per_launch_s(self, pattern: str):
        """Mean seconds per launch of the kernels whose name holds
        ``pattern``, or None where none ran."""
        sec, cnt = self.total_s(pattern)
        return sec / cnt if cnt else None


def _annotation(e) -> bool:
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def summarize(prof, span_names) -> Trace | None:
    """The trace of the stretch, or None where the profile holds no
    stretch."""
    from torch.autograd import DeviceType

    names = set(span_names) | {STRETCH}
    dev, host, spans = [], [], []
    lo = hi = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not _annotation(e) and name not in names:
                dev.append((e.start_ns(), e.duration_ns(), name))
        elif name == STRETCH:
            lo, hi = e.start_ns(), e.start_ns() + e.duration_ns()
        elif name in names:
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        else:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    if lo is None or hi <= lo:
        return None
    kernels, ivals = {}, []
    for start, dur, name in dev:
        a, b = max(start, lo), min(start + dur, hi)
        if b <= a:
            continue
        ivals.append((a, b))
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (b - a) / 1e9
        k[1] += 1
    busy, gaps = union_and_gaps(ivals, lo, hi)
    return Trace((hi - lo) / 1e9, busy / 1e9, kernels,
                 _label_gaps(gaps, spans, host))


def union_and_gaps(ivals: list, lo, hi) -> tuple:
    """(length of the union of the intervals (a, b) inside [lo, hi], the
    gaps of [lo, hi] that no interval covers)."""
    busy, gaps, end = 0, [], lo
    for a, b in sorted(ivals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


def _innermost(events: list, starts: np.ndarray, t: int) -> str | None:
    """The latest-starting event of ``events`` (sorted by start) that
    covers t."""
    i = int(np.searchsorted(starts, t, side="right")) - 1
    for j in range(i, max(i - 256, -1), -1):
        if events[j][1] >= t:
            return events[j][2]
    return None


def _label_gaps(gaps: list, spans: list, host: list) -> list:
    spans.sort()
    host.sort()
    ss = np.array([e[0] for e in spans], np.int64)
    hs = np.array([e[0] for e in host], np.int64)
    by_len = sorted(gaps, key=lambda g: g[0] - g[1])
    total: dict = {}
    for n, (a, b) in enumerate(by_len):
        if n < LABELLED_GAPS:
            t = (a + b) // 2
            span = _innermost(spans, ss, t) if spans else None
            op = _innermost(host, hs, t) if host else None
            label = f"{span or 'between requests'}/{op or 'python'}"
        else:
            label = "other gaps"
        total[label] = total.get(label, 0.0) + (b - a) / 1e9
    top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
    return [[label[:160], sec] for label, sec in top]
