"""The closed loop: one client sends request k + 1 when request k has
returned, from the window's start until ``seconds`` have passed; the
request in flight at that moment runs to its end and counts, so the
window's work and time are whole requests.

Each request's inputs are fresh copies made before it is sent
(``prepare``); its latency runs from its send to the vertex it returns
(``send``); its outputs are then kept on the host for judging after the
window (``keep``).  In a traced run the device is profiled over the first
``trace_requests`` requests of the window, inside one ``record_function``
range (``STRETCH``) that marks the traced stretch.
"""
from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass, field

STRETCH = "bm.traced_stretch"


@dataclass
class Window:
    seconds: float = 0.0            # from the window's start to the last end
    latencies: list = field(default_factory=list)
    records: list = field(default_factory=list)   # None where it raised
    profile: object = None          # the torch.profiler run, traced only


def closed_loop(kind, state: dict, seconds: float, spans,
                trace_requests: int = 0) -> Window:
    import torch

    win = Window()
    prof = rng = None
    if trace_requests > 0:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        rng = torch.profiler.record_function(STRETCH)
        rng.__enter__()
    t0 = time.perf_counter()
    k = 0
    while True:
        inp = kind.prepare(state, k)
        ts = time.perf_counter()
        try:
            raw = kind.send(state, inp, spans)
        except Exception:       # a failed request counts against the run
            traceback.print_exc(file=sys.stderr)
            raw = None
        te = time.perf_counter()
        del inp
        win.latencies.append(te - ts)
        win.records.append(None if raw is None else kind.keep(state, raw))
        del raw
        k += 1
        if prof is not None and k == trace_requests:
            win.profile, prof = _stop(prof, rng), None
        if te - t0 >= seconds:
            break
    win.seconds = te - t0
    if prof is not None:
        win.profile = _stop(prof, rng)
    return win


def _stop(prof, rng):
    rng.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    return prof
