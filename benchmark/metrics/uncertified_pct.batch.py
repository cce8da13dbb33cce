"""The share of the window's instances whose device basis the program's
float64 certificate rejected (``certify_ot_basis_batch``), in percent;
such an instance is not counted as a certified vertex."""


def read(run):
    cs = [c for c in run.counters if c and "certified" in c]
    n = sum(c["instances"] for c in cs)
    return 100.0 * (n - sum(c["certified"] for c in cs)) / n if n else None
