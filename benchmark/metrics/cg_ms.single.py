"""Mean host milliseconds of TNET's column generation (subproblems on
the native network simplex, pricing over every arc) per request: the
program's span ``scx.cg`` over the calls of ``scx.network_crossover`` in
the traced stretch."""
from benchmark.harness.program_trace import span_per_request


def read(run):
    return span_per_request(["scx.cg"], "scx.network_crossover", 1e3)
