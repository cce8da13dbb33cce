"""Comparison plots.

Capability parity with the reference's matplotlib figures
(reference visualization.py:198-335): per-instance log-scale runtime bars
for ours-vs-baseline with a relative-gap overlay.  matplotlib is imported
lazily so headless/metrics-only environments never pay for it.

Host copy of ``smart_crossover_tpu/analysis/plots.py``.
"""
from __future__ import annotations

from collections import defaultdict


def runtime_comparison_figure(store, ours: str, baseline: str,
                              gap_key: str = "rel_gap_vs_barrier",
                              save_to: str | None = None):
    """Log-scale grouped runtime bars + relative-gap scatter overlay."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    rows_by = defaultdict(dict)
    for row in store.rows():
        rows_by[row["instance"]][row["method"]] = row
    insts = sorted(i for i, ms in rows_by.items()
                   if ours in ms and baseline in ms)
    if not insts:
        raise ValueError(f"no instances with both {ours!r} and {baseline!r}")
    t_ours = [rows_by[i][ours].get("runtime") or 3600.0 for i in insts]
    t_base = [rows_by[i][baseline].get("runtime") or 3600.0 for i in insts]
    gaps = [rows_by[i][ours].get(gap_key) for i in insts]

    x = np.arange(len(insts))
    w = 0.38
    fig, ax = plt.subplots(figsize=(max(6, len(insts) * 0.7), 4))
    ax.bar(x - w / 2, t_ours, w, label=ours)
    ax.bar(x + w / 2, t_base, w, label=baseline)
    ax.set_yscale("log")
    ax.set_ylabel("runtime (s, log)")
    ax.set_xticks(x)
    ax.set_xticklabels(insts, rotation=60, ha="right", fontsize=7)
    ax.legend(loc="upper left")
    if any(g is not None for g in gaps):
        ax2 = ax.twinx()
        ax2.scatter(x, [g if g is not None else float("nan") for g in gaps],
                    color="black", marker="x", s=14, label="rel gap")
        ax2.set_yscale("log")
        ax2.set_ylabel("relative gap")
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=150)
    return fig


def perturb_comparison_figure(store, ours: str = "ptb",
                              baseline: str = "ori",
                              timeout_fill: float = 3600.0,
                              floor: float = 0.15,
                              save_to: str | None = None):
    """Paper-style perturbation-crossover figure (parity with reference
    visualization.py:198-278): grouped log-scale runtime bars
    (ours vs the vendor-crossover analog), timeouts filled at 3600 s,
    sub-0.15 s runtimes floored for visibility, with the per-instance
    relative objective gap on a -log10 right axis and the 1e-8 acceptance
    threshold dashed in."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    rows_by = defaultdict(dict)
    for row in store.rows():
        rows_by[row["instance"]][row["method"]] = row
    insts = sorted(i for i, ms in rows_by.items()
                   if ours in ms and baseline in ms)
    if not insts:
        raise ValueError(f"no instances with both {ours!r} and {baseline!r}")

    def rt(row):
        t = row.get("runtime")
        if t is None or row.get("status") in ("TIME_LIMIT",
                                              "ITERATION_LIMIT"):
            return timeout_fill
        return max(float(t), floor)

    t_ours = [rt(rows_by[i][ours]) for i in insts]
    t_base = [rt(rows_by[i][baseline]) for i in insts]
    gaps = []
    for i in insts:
        a = rows_by[i][ours].get("obj_val")
        b = rows_by[i][baseline].get("obj_val")
        if a is None or b is None:
            gaps.append(np.nan)
        else:
            gaps.append(abs(a - b) / (1 + abs(a) + abs(b)))

    x = np.arange(len(insts))
    w = 0.38
    fig, ax1 = plt.subplots(figsize=(10, 5))
    c1, c2, c3 = "Crimson", "DodgerBlue", "Goldenrod"
    ax1.set_yscale("log")
    ax1.bar(x, t_ours, w, color=c1, alpha=0.8,
            label="Perturbation Crossover")
    ax1.bar(x + w, t_base, w, color=c2, alpha=0.8,
            label="Plain Barrier Crossover")
    ax2 = ax1.twinx()
    pts = -np.log10(np.maximum(np.asarray(gaps, float), 1e-16))
    ax2.scatter(x, pts, color=c3, label="Relative Objective Gap")
    ax2.axhline(y=8, color=c3, linestyle="--", alpha=0.5)
    ax1.set_xlabel("optLP-scale benchmark problems")
    ax1.set_ylabel("Running Time (seconds)", color=c1)
    ax2.set_ylabel("Relative Gap (-log10)", color=c3)
    ax1.set_xticks(x + w / 2)
    ax1.set_xticklabels(insts, rotation=60, ha="right", fontsize=7)
    ax1.set_ylim([1e-1, 1e4])
    ax2.set_ylim([-1, 18])
    ax2.grid(False)
    ax1.legend(loc="upper left", ncol=2, frameon=True)
    ax2.legend(loc="upper right", frameon=True)
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=150)
    return fig


def speedup_ratio_figure(store, ours: str = "ptb", baseline: str = "ori",
                         timeout_fill: float = 3600.0,
                         save_to: str | None = None):
    """Ratio-bars figure (parity with reference visualization.py:281-335):
    per-instance -log10(ours/baseline) runtime ratio (bars above zero =
    the perturbation crossover wins) with the relative gap scattered on
    the right axis."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    rows_by = defaultdict(dict)
    for row in store.rows():
        rows_by[row["instance"]][row["method"]] = row
    insts = sorted(i for i, ms in rows_by.items()
                   if ours in ms and baseline in ms)
    if not insts:
        raise ValueError(f"no instances with both {ours!r} and {baseline!r}")

    def rt(row):
        t = row.get("runtime")
        if t is None or row.get("status") in ("TIME_LIMIT",
                                              "ITERATION_LIMIT"):
            return timeout_fill
        return max(float(t), 1e-3)

    ratio = np.array([rt(rows_by[i][ours]) / rt(rows_by[i][baseline])
                      for i in insts])
    gaps = np.array([
        abs((rows_by[i][ours].get("obj_val") or np.nan)
            - (rows_by[i][baseline].get("obj_val") or np.nan))
        / (1 + abs(rows_by[i][ours].get("obj_val") or 0.0))
        for i in insts])

    x = np.arange(len(insts))
    fig, ax1 = plt.subplots(figsize=(10, 5))
    c1, c2 = "Crimson", "Goldenrod"
    ax1.bar(x, -np.log10(ratio), color=c1, alpha=1.0)
    ax1.axhline(y=0.0, color="gray", linewidth=0.8)
    ax2 = ax1.twinx()
    ax2.scatter(x, -np.log10(np.maximum(gaps, 1e-16)), color=c2,
                label="Relative Gap")
    ax1.set_xlabel("optLP-scale benchmark problems")
    ax1.set_ylabel("Running-time Ratio (-log10)", color=c1)
    ax2.set_ylabel("Relative Gap (-log10)", color=c2)
    ax1.set_xticks(x)
    ax1.set_xticklabels(insts, rotation=60, ha="right", fontsize=7)
    ax2.grid(False)
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=150)
    return fig


def network_comparison_figure(store, methods=("tnet", "cnet", "baseline"),
                              value: str = "runtime",
                              save_to: str | None = None):
    """Grouped per-instance bars over any set of recorded methods (the
    capability of the reference's OT/MCF comparison dataframes,
    visualization.py:338-431, rendered directly from the ResultStore)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    rows_by = defaultdict(dict)
    for row in store.rows():
        rows_by[row["instance"]][row["method"]] = row
    methods = [m for m in methods
               if any(m in ms for ms in rows_by.values())]
    insts = sorted(i for i, ms in rows_by.items()
                   if any(m in ms for m in methods))
    if not insts or not methods:
        raise ValueError("no matching (instance, method) rows")
    x = np.arange(len(insts))
    w = 0.8 / len(methods)
    fig, ax = plt.subplots(figsize=(max(6, len(insts) * 0.7), 4))
    for k, mname in enumerate(methods):
        vals = [rows_by[i].get(mname, {}).get(value) or float("nan")
                for i in insts]
        ax.bar(x + k * w, vals, w, label=mname)
    ax.set_yscale("log")
    ax.set_ylabel(f"{value} (log)")
    ax.set_xticks(x + 0.4 - w / 2)
    ax.set_xticklabels(insts, rotation=60, ha="right", fontsize=7)
    ax.legend(loc="upper left")
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=150)
    return fig
