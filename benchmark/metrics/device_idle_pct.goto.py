"""100 x (1 - the union of the device's activity / the wall time) over
the traced stretch."""
from benchmark.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
