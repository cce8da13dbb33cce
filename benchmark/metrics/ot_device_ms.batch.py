"""Mean milliseconds of the device route, ``batched_tnet_exact_device``
with the copy of its basis masks, objectives, flags and pivots to the
host, per request: the harness's synced span ``ot_device`` over every
request of the window."""
from benchmark.harness.readers import span_mean


def read(run):
    return span_mean(run, "ot_device", 1e3)
