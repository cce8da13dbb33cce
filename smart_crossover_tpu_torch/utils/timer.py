"""Wall-clock timer with accumulation.

Host copy of ``smart_crossover_tpu/utils/timer.py``, unchanged.

Capability parity with the reference Timer (reference: timer.py:6-39): the
crossover algorithms time their own orchestration phases separately from the
sub-solver runtimes, then stitch the two together via :meth:`accumulate`.
"""
from __future__ import annotations

import datetime
import time


class Timer:
    """Accumulating wall-clock timer.

    ``start()``/``stop()`` bracket a measured phase; ``accumulate()`` adds an
    externally measured duration (e.g. a sub-solver's self-reported runtime).
    ``total`` is a ``datetime.timedelta``.
    """

    def __init__(self) -> None:
        self._t0: float | None = None
        self.total = datetime.timedelta(0)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is None:
            return
        self.total += datetime.timedelta(seconds=time.perf_counter() - self._t0)
        self._t0 = None

    def accumulate(self, duration: datetime.timedelta | float | None) -> None:
        if duration is None:
            return
        if not isinstance(duration, datetime.timedelta):
            duration = datetime.timedelta(seconds=float(duration))
        self.total += duration

    def clear(self) -> None:
        self._t0 = None
        self.total = datetime.timedelta(0)

    @property
    def seconds(self) -> float:
        return self.total.total_seconds()

    def __enter__(self) -> "Timer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
