"""Mean host-clock seconds of the synced span around ``pdhg_mcf_device``,
over every request of the window."""
from benchmark.harness.readers import span_mean


def read(run):
    return span_mean(run, "warm_start", 1.0)
