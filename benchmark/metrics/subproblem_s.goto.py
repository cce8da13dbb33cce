"""Mean host seconds of CNET_MCF's subproblem solves (the native network
simplex, warm-started each round) per request: the program's span
``scx.cg.subproblem`` over the calls of ``scx.network_crossover`` in the
traced stretch."""
from benchmark.harness.program_trace import span_per_request


def read(run):
    return span_per_request(["scx.cg.subproblem"], "scx.network_crossover",
                            1.0)
