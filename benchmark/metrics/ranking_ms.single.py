"""Mean host milliseconds of TNET's flow ranking (the manager's
``get_sorted_flows``: indicators and sort on the card, the queue back on
the host) per request: the program's span ``scx.ranking`` over the calls
of ``scx.network_crossover`` in the traced stretch."""
from benchmark.harness.program_trace import span_per_request


def read(run):
    return span_per_request(["scx.ranking"], "scx.network_crossover", 1e3)
