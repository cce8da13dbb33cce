"""Mean seconds of CNET_MCF's column generation, as the program measures
them (``network_crossover``'s ``stats["cg_s"]``), over every request of
the window."""
from benchmark.harness.readers import counter_mean


def read(run):
    return counter_mean(run, "cg_s")
