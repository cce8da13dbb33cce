"""Mean host seconds of CNET_MCF's pricing (each round's optimality test:
reduced costs over every arc, flow on the artificial arcs) per request:
the program's span ``scx.cg.pricing`` over the calls of
``scx.network_crossover`` in the traced stretch."""
from benchmark.harness.program_trace import span_per_request


def read(run):
    return span_per_request(["scx.cg.pricing"], "scx.network_crossover",
                            1.0)
