"""Mean host-clock milliseconds of the span around
``network_crossover(method="tnet")``, over every request of the
window."""
from benchmark.harness.readers import span_mean


def read(run):
    return span_mean(run, "network_crossover", 1e3)
