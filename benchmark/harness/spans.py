"""The harness's own spans around the calls into each layer of the port.

A span is host-clock seconds between two device synchronisations, kept
per name over the whole window, and a ``record_function`` range of the
same name, so that the device trace can say what the host was doing.
Spans are on only in a traced run (``--trace 1``); off, ``span`` adds
nothing to a request."""
from __future__ import annotations

import contextlib
import time

import torch


class Spans:
    def __init__(self, enabled: bool, device=None):
        self.enabled = enabled
        self.device = torch.device(device) if device is not None else None
        self.seconds: dict = {}

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            self._sync()
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


OFF = Spans(False)
