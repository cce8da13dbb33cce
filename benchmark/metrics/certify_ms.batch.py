"""Mean milliseconds of the float64 certification on the host,
``certify_ot_basis_batch``, per request: the harness's synced span
``certify`` over every request of the window."""
from benchmark.harness.readers import span_mean


def read(run):
    return span_mean(run, "certify", 1e3)
