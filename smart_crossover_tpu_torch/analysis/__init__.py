"""Result aggregation & comparison analysis.

Capability parity with the reference's visualization module
(reference visualization.py:181-195,415,428): shifted geometric means,
timeout filling, improved-instance counting and comparison tables — but fed
from the structured ResultStore instead of regex-scraped solver logs.

Host copy of ``smart_crossover_tpu/analysis/__init__.py``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Iterable

import numpy as np

TIMEOUT_FILL_SECONDS = 3600.0
GEO_SHIFT = 0.01


def geo_mean(values: Iterable[float], shift: float = GEO_SHIFT) -> float:
    """exp(mean(log(x + shift))) — the reference's aggregation."""
    v = np.asarray(list(values), dtype=np.float64)
    if v.size == 0:
        return float("nan")
    return float(np.exp(np.mean(np.log(v + shift))))


def fill_timeouts(values, statuses, fill: float = TIMEOUT_FILL_SECONDS):
    """Replace failed/timed-out runtimes with the 3600 s fill value."""
    out = []
    for v, s in zip(values, statuses):
        ok = s in ("OPTIMAL", None)
        out.append(float(v) if ok and v is not None else fill)
    return out


def summarize(store, runtime_key: str = "runtime") -> dict:
    """Per-method geometric-mean runtime / iteration summaries."""
    by_method = defaultdict(lambda: {"runtimes": [], "statuses": [],
                                     "iters": [], "instances": []})
    for row in store.rows():
        rec = by_method[row["method"]]
        rec["runtimes"].append(row.get(runtime_key))
        rec["statuses"].append(row.get("status"))
        rec["iters"].append(row.get("iter_count") or 0)
        rec["instances"].append(row["instance"])
    out = {}
    for method, rec in by_method.items():
        rts = fill_timeouts(rec["runtimes"], rec["statuses"])
        out[method] = {
            "num_instances": len(rts),
            "geo_mean_runtime": geo_mean(rts),
            "geo_mean_iters": geo_mean(rec["iters"]),
            "num_failed": sum(1 for s in rec["statuses"]
                              if s not in ("OPTIMAL", None)),
        }
    return out


def compare(store, ours: str, baseline: str,
            runtime_key: str = "runtime") -> dict:
    """Instance-matched comparison: speedup geo-mean + #improved
    (the reference's 'improved instances' metric, visualization.py:181-195)."""
    rows_by = defaultdict(dict)
    for row in store.rows():
        rows_by[row["instance"]][row["method"]] = row
    ratios = []
    improved = 0
    matched = 0
    for inst, methods in rows_by.items():
        if ours in methods and baseline in methods:
            a = methods[ours]
            b = methods[baseline]
            ta = fill_timeouts([a.get(runtime_key)], [a.get("status")])[0]
            tb = fill_timeouts([b.get(runtime_key)], [b.get("status")])[0]
            matched += 1
            ratios.append(tb / max(ta, 1e-9))
            if ta < tb:
                improved += 1
    return {
        "matched_instances": matched,
        "geo_mean_speedup": geo_mean(ratios, shift=0.0) if ratios else float("nan"),
        "num_improved": improved,
    }


def table(summary: dict) -> str:
    """Plain-text comparison table."""
    lines = [f"{'method':<16}{'n':>5}{'geo_rt(s)':>12}{'geo_iters':>12}{'fail':>6}"]
    for method, rec in sorted(summary.items()):
        lines.append(f"{method:<16}{rec['num_instances']:>5}"
                     f"{rec['geo_mean_runtime']:>12.4f}"
                     f"{rec['geo_mean_iters']:>12.1f}"
                     f"{rec['num_failed']:>6}")
    return "\n".join(lines)


def to_dataframe(store):
    """ResultStore rows as a pandas DataFrame (the reference's analysis
    operates on pandas frames, visualization.py:388-418)."""
    import pandas as pd

    return pd.DataFrame(list(store.rows()))


def pivot_table(store, value: str = "runtime"):
    """Instances x methods table of a metric (NaN where missing)."""
    import pandas as pd

    df = to_dataframe(store)
    if df.empty:
        return pd.DataFrame()
    return df.pivot_table(index="instance", columns="method", values=value,
                          aggfunc="last")
