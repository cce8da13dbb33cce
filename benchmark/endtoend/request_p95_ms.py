"""The 95th percentile, by nearest rank, of the latencies of all the
window's requests, failed ones included, in milliseconds.  Ten or more
requests lie beyond it from 200 requests on."""
import math


def read(run):
    lat = sorted(run.window.latencies)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1] if lat else None
