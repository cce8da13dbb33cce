"""The port's tracer: named spans and counters around the stages of its
routes.

    from smart_crossover_tpu_torch.utils import trace

    with trace.span("scx.push", X.device):
        X, iters = push_to_bfs(X)
    trace.count("push.steps", steps)

A span always measures its host time (``time.perf_counter_ns``); given a
``stats`` dict and a ``key`` it writes its seconds there, so the entry
points' ``stats=`` keep their keys.  It *records* only while a
``torch.profiler`` is active or inside ``with trace.recording():``; then
it also opens a ``torch.profiler.record_function`` range of its name,
appends one record to an in-memory buffer (name, start and end in Unix
epoch ns, the clock kineto stamps its events in; its parent span, the
request it belongs to, its thread, its counters) and, for a CUDA
``device``, records a pair of timing events on the current stream,
resolved only when the record is read, except that a request's
outermost span waits for its end event, so that its host time runs to
the device's finished result.  Off, a span is one flag test beyond its
two clock reads: no range, no event, no record, no wait.

The request of a span is the id of the outermost span open on its thread
when it started, so all spans of one call share it.  ``count`` adds to
the innermost recording span's counters; a span's counters in
``summary`` include those of the spans inside it.  The buffer holds at
most ``CAPACITY`` records; later ones are counted in ``dropped()``.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field

import torch

PREFIX = "scx."
CAPACITY = 200_000

# perf_counter_ns -> Unix epoch ns, fixed once
_EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
_profiler_enabled = torch._C._autograd._profiler_enabled


@dataclass(eq=False)
class Record:
    """One finished span.  ``events``: the CUDA (start, end) pair, or
    None."""
    name: str
    id: int
    parent: int | None
    request: int
    thread: int
    start_ns: int = 0
    end_ns: int = 0
    counters: dict = field(default_factory=dict)
    events: tuple | None = None
    _event_s: float | None = None

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def event_s(self) -> float | None:
        """Device seconds between the span's two CUDA events (waits for
        the end event), or None for a span without events."""
        if self.events is None:
            return None
        if self._event_s is None:
            start, end = self.events
            end.synchronize()
            self._event_s = start.elapsed_time(end) / 1e3
        return self._event_s


class Tracer:
    """The buffer and the open spans of each thread."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.records: list = []
        self.dropped = 0
        self.forced = 0            # open ``recording()`` blocks
        self._ids = itertools.count(1)
        self._local = threading.local()

    def recording_now(self) -> bool:
        return self.forced > 0 or _profiler_enabled()

    def stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def keep(self, rec: Record) -> None:
        if len(self.records) < self.capacity:
            self.records.append(rec)
        else:
            self.dropped += 1


TRACER = Tracer()


class span:
    """``with span(name, device=None, stats=None, key=None):`` the block
    as one span (see the module's docstring).  ``stats[key]`` gets its
    host seconds."""

    __slots__ = ("name", "device", "stats", "key", "t0", "rec", "rf")

    def __init__(self, name: str, device=None, stats: dict | None = None,
                 key: str | None = None):
        self.name, self.device, self.stats, self.key = name, device, stats, key
        self.rec = None

    def __enter__(self):
        if TRACER.recording_now():
            self._open()
        self.t0 = time.perf_counter_ns()
        return self

    def _open(self) -> None:
        st = TRACER.stack()
        i = next(TRACER._ids)
        self.rec = rec = Record(self.name, i, st[-1].id if st else None,
                                st[0].request if st else i,
                                threading.get_ident())
        st.append(rec)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        dev = self.device
        if dev is not None and torch.device(dev).type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            rec.events = (start, end)

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None and rec.events is not None:
            end = rec.events[1]
            end.record(torch.cuda.current_stream(self.device))
            if rec.parent is None:
                end.synchronize()
        t1 = time.perf_counter_ns()
        if rec is not None:
            self.rf.__exit__(*exc)
            rec.start_ns = self.t0 + _EPOCH_OFFSET_NS
            rec.end_ns = t1 + _EPOCH_OFFSET_NS
            st = TRACER.stack()
            if rec in st:
                st.remove(rec)
            TRACER.keep(rec)
        if self.stats is not None:
            self.stats[self.key] = (t1 - self.t0) / 1e9
        return False


def count(name: str, n=1, stats: dict | None = None,
          key: str | None = None) -> None:
    """Add ``n`` to the innermost recording span's counter ``name``;
    ``stats[key] = n`` where a stats dict is given (count once per call,
    with the call's total, where it is)."""
    if stats is not None:
        stats[key] = n
    if TRACER.recording_now():
        st = TRACER.stack()
        if st:
            c = st[-1].counters
            c[name] = c.get(name, 0) + n


class Stretch:
    """The records appended while a ``recording()`` block was open."""

    def __init__(self, tracer: Tracer):
        self.tracer, self.lo, self.hi = tracer, len(tracer.records), None

    def records(self) -> list:
        return self.tracer.records[self.lo:self.hi]

    def summary(self) -> dict:
        return summarize(self.records())


@contextlib.contextmanager
def recording():
    """Record spans inside the block whether or not a profiler runs.
    Yields a ``Stretch`` whose ``summary()`` covers the block."""
    stretch = Stretch(TRACER)
    TRACER.forced += 1
    try:
        yield stretch
    finally:
        TRACER.forced -= 1
        stretch.hi = len(TRACER.records)


def summarize(records: list) -> dict:
    """Per span name: ``calls``, ``host_s``, ``self_s`` (host seconds
    less the host seconds of the spans directly inside), ``event_s`` (the
    CUDA events' seconds, None where no such span had events) and
    ``counters`` (totals, the spans inside included)."""
    by_id = {r.id: r for r in records}
    child_s: dict = {}
    incl: dict = {}
    for r in records:
        if r.parent is not None:
            child_s[r.parent] = child_s.get(r.parent, 0.0) + r.host_s
        node = r if r.counters else None
        while node is not None:
            c = incl.setdefault(node.id, {})
            for k, v in r.counters.items():
                c[k] = c.get(k, 0) + v
            node = by_id.get(node.parent)
    out: dict = {}
    for r in records:
        s = out.setdefault(r.name, {"calls": 0, "host_s": 0.0, "self_s": 0.0,
                                    "event_s": None, "counters": {}})
        s["calls"] += 1
        s["host_s"] += r.host_s
        s["self_s"] += r.host_s - child_s.get(r.id, 0.0)
        ev = r.event_s
        if ev is not None:
            s["event_s"] = (s["event_s"] or 0.0) + ev
        for k, v in incl.get(r.id, {}).items():
            s["counters"][k] = s["counters"].get(k, 0) + v
    return out


def summary() -> dict:
    """``summarize`` over every record in the buffer."""
    return summarize(TRACER.records)


def records() -> list:
    """A copy of the buffer's records, oldest first."""
    return list(TRACER.records)


def dropped() -> int:
    return TRACER.dropped


def clear() -> None:
    """Empty the buffer."""
    TRACER.records.clear()
    TRACER.dropped = 0
