"""Mean device milliseconds of the route's two Borůvka spanning trees
(``ops/mst.py``: over the flow indicators, then over the tree vertex's
support) per batch: the program's spans ``scx.boruvka_flow`` and
``scx.boruvka_support`` between their CUDA events, over the calls of
``scx.route`` in the traced stretch."""
from benchmark.harness.program_trace import span_per_request


def read(run):
    return span_per_request(["scx.boruvka_flow", "scx.boruvka_support"],
                            "scx.route", 1e3, "event")
