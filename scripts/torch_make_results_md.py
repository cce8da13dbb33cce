#!/usr/bin/env python3
"""Render a ResultStore into the docs/RESULTS.md experiment report, on the
PyTorch port.

Port of ``scripts/make_results_md.py``: the same report, byte for byte,
from the same stores, with the port's ``analysis`` and ``data`` modules
in place of the JAX package's, so the stores of
``scripts/torch_run_perturb_crossover.py`` and
``scripts/torch_run_network_crossover.py`` render without jax.  The
analysis-layer analog of the reference's pandas tables (reference
visualization.py:388-431): per-instance rows, geo-mean aggregates
(exp(mean(log(t+0.01))), timeouts filled at 3600 s), the ptb-vs-ori
comparison, and the paper-style figures.

Usage: python3 scripts/torch_make_results_md.py RESULTS.jsonl [OUT.md]
           [FIGDIR] [NETWORK.jsonl] [TOTAL.jsonl] [GOTO.json...]

The optional extra stores append the network-crossover protocol table,
the end-to-end ('total') protocol table, and GOTO-17 flagship summary
rows, so ONE command regenerates the whole experiment report from the
current stores.  Imports only ``smart_crossover_tpu_torch``.
"""
from __future__ import annotations

import json
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _store_section(title: str, proto: str, results: str) -> list[str]:
    """Generic per-method summary table for a ResultStore."""
    from smart_crossover_tpu_torch.analysis import summarize, table
    from smart_crossover_tpu_torch.data import ResultStore

    store = ResultStore(results)
    if not list(store.rows()):
        return []
    return ["", f"# {title}", "", f"Protocol: {proto}", "",
            "```", table(summarize(store)), "```", ""]


def _goto_section(paths: list[str]) -> list[str]:
    lines = ["", "# GOTO-17-class MCF flagship (131k nodes / 786k arcs)",
             "",
             "Protocol: `scripts/run_goto17.py` — instances written to and "
             "re-read from DIMACS `.min` (reference scripts/min2mcf.py), "
             "cold native network simplex vs PDHG warm start + CNET_MCF "
             "(reference scripts/run_network_crossover.py:38).", "",
             "| run | cold geo (s) | warm+crossover steady (s) | "
             "warm+crossover incl. compile (s) | cold pivots | crossover "
             "pivots | exact |",
             "|---|---|---|---|---|---|---|"]
    any_rows = False
    for p in paths:
        try:
            txt = Path(p).read_text().strip().splitlines()
            row = json.loads(next(ln for ln in reversed(txt)
                                  if ln.startswith("{")))
        except Exception:
            continue
        any_rows = True
        tag = "regular" if row.get("regular") else "irregular"
        lines.append(
            f"| {tag} ({len(row['rows'])} seeds) "
            f"| {row.get('geo_cold_s', '—')} "
            f"| {row.get('geo_e2e_steady_s', '—')} "
            f"| {row.get('geo_e2e_incl_compile_s', '—')} "
            f"| {row.get('geo_cold_pivots', '—')} "
            f"| {row.get('geo_crossover_pivots', '—')} "
            f"| {row.get('all_match', '—')} |")
    return lines + [""] if any_rows else []


def main(results: str, out_md: str = "docs/RESULTS.md",
         fig_dir: str = "docs/figures", network: str | None = None,
         total: str | None = None, *goto: str):
    from smart_crossover_tpu_torch.analysis import compare, geo_mean
    from smart_crossover_tpu_torch.data import ResultStore

    store = ResultStore(results)
    rows_by = defaultdict(dict)
    for row in store.rows():
        rows_by[row["instance"]][row["method"]] = row
    insts = sorted(rows_by)
    if not insts:
        raise SystemExit(f"no rows in {results}")

    def rt(row, fill=3600.0):
        if row is None:
            return None
        t = row.get("runtime")
        if t is None or row.get("status") in ("TIME_LIMIT",
                                              "ITERATION_LIMIT"):
            return fill
        return float(t)

    lines = [
        "# optLP-scale perturbation-crossover results",
        "",
        "Protocol: `scripts/run_perturb_crossover.py --generate optlp` — "
        "the reference's ori-vs-ptb experiment "
        "(reference scripts/run_perturb_crossover.py:44-97) on the "
        "synthetic reference-scale suite (five structure families: "
        "staircase, windowed cover, multicommodity, scattered cover, "
        "windowed transportation; `data/lp_gen.py`), barrier tol 1e-10, "
        "timeouts filled at 3600 s in the aggregates "
        "(reference visualization.py:184-200).",
        "",
        "| instance | ptb wall (s) | ptb pivots | ori wall (s) | "
        "ori pivots | rel. obj gap |",
        "|---|---|---|---|---|---|",
    ]
    t_ptb, t_ori, gaps = [], [], []
    p_ptb, p_ori = [], []
    for i in insts:
        p = rows_by[i].get("ptb")
        o = rows_by[i].get("ori")
        tp, to = rt(p), rt(o)
        gap = None
        if (p and o and p.get("obj_val") is not None
                and o.get("obj_val") is not None):
            gap = abs(p["obj_val"] - o["obj_val"]) / (
                1 + abs(p["obj_val"]) + abs(o["obj_val"]))
        fmt = lambda v, d=1: ("—" if v is None else f"{v:.{d}f}")

        def piv(row):
            return "—" if row is None or row.get("iter_count") is None \
                else str(row["iter_count"])

        def wall(row, t):
            if row is None:
                return "—"
            s = fmt(t)
            if row.get("status") in ("TIME_LIMIT", "ITERATION_LIMIT"):
                s += " (t/o)"
            return s

        lines.append(
            f"| {i} | {wall(p, tp)} | {piv(p)} | {wall(o, to)} | {piv(o)} |"
            f" {'—' if gap is None else f'{gap:.1e}'} |")
        if tp is not None and to is not None:
            t_ptb.append(tp)
            t_ori.append(to)
            if p.get("iter_count") is not None \
                    and o.get("iter_count") is not None:
                p_ptb.append(max(p["iter_count"], 0) + 0.01)
                p_ori.append(max(o["iter_count"], 0) + 0.01)
        if gap is not None:
            gaps.append(gap)

    lines.append("")
    if t_ptb:
        lines += [
            f"**Geo-mean wall**: ptb {geo_mean(t_ptb):.1f} s vs "
            f"ori {geo_mean(t_ori):.1f} s — "
            f"**{geo_mean(t_ori) / max(geo_mean(t_ptb), 1e-9):.1f}x**"
            f" over {len(t_ptb)} instances.",
        ]
    if p_ptb:
        lines.append(
            f"**Geo-mean finishing pivots**: ptb {geo_mean(p_ptb):.0f} vs "
            f"ori {geo_mean(p_ori):.0f} — "
            f"**{geo_mean(p_ori) / max(geo_mean(p_ptb), 1e-2):.1f}x "
            "fewer**.")
    if gaps:
        lines.append(f"**Max ptb-vs-ori relative objective gap**: "
                     f"{max(gaps):.2e} (mutual-agreement exactness check; "
                     "scipy HiGHS cannot finish these instances within "
                     "900 s — see BENCH.md).")
    cmp = compare(store, ours="ptb", baseline="ori")
    lines += ["", f"`analysis.compare`: `{cmp}`", ""]

    figp = Path(fig_dir)
    figp.mkdir(parents=True, exist_ok=True)
    try:
        from smart_crossover_tpu_torch.analysis.plots import (
            perturb_comparison_figure,
            speedup_ratio_figure,
        )

        perturb_comparison_figure(
            store, save_to=str(figp / "perturb_optlp.png"))
        speedup_ratio_figure(
            store, save_to=str(figp / "perturb_optlp_ratio.png"))
        lines += ["![perturb](figures/perturb_optlp.png)",
                  "", "![ratio](figures/perturb_optlp_ratio.png)", ""]
    except Exception as e:  # matplotlib optional
        lines.append(f"(figures skipped: {e})")

    if network:
        lines += _store_section(
            "Network crossover protocol (MNIST-like OT pairs)",
            "reference run_network_crossover 'crossover' mode — in-house "
            "barrier produces x_bar; TNET/CNET cross over from it; "
            "baseline is the in-house barrier+crossover on the same "
            "instance.", network)
    if total:
        lines += _store_section(
            "End-to-end ('total') protocol",
            "reference run_network_crossover 'total' mode — first-order "
            "warm start + crossover vs the cold native network simplex.",
            total)
    if goto:
        lines += _goto_section(list(goto))

    Path(out_md).parent.mkdir(parents=True, exist_ok=True)
    Path(out_md).write_text("\n".join(lines) + "\n")
    print(f"wrote {out_md} ({len(insts)} instances)")


if __name__ == "__main__":
    main(*sys.argv[1:])
