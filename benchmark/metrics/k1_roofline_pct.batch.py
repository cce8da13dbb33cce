"""K1's share of its roofline at the batch's B, from the device trace
(``roofline/sinkhorn.py``)."""
from benchmark.roofline.sinkhorn import roofline_pct


def read(run):
    return roofline_pct(run)
