"""K1's share of its roofline at B = 1 (``sinkhorn(ot)``), from the
device trace (``roofline/sinkhorn.py``)."""
from benchmark.roofline.sinkhorn import roofline_pct


def read(run):
    return roofline_pct(run)
