"""Mean host milliseconds of TNET's tree basis identification
(``tree_bi.py::tree_basis_identify``: Borůvka, tree solve and push on the
card) per request: the program's span ``scx.tree_basis`` over the calls
of ``scx.network_crossover`` in the traced stretch."""
from benchmark.harness.program_trace import span_per_request


def read(run):
    return span_per_request(["scx.tree_basis"], "scx.network_crossover",
                            1e3)
