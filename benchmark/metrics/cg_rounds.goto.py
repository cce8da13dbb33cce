"""Mean column-generation rounds of CNET_MCF per request: the program's
counter ``cg.rounds`` inside ``scx.network_crossover``, over its calls in
the traced stretch."""
from benchmark.harness.program_trace import counter_per_request


def read(run):
    return counter_per_request("cg.rounds", "scx.network_crossover")
