"""Judging the ``Output`` that ``network_crossover`` returns: its x over
the instance's arcs, then any artificial arcs the crossover appended,
which have to carry nothing; its basis statuses (0 basic, -1 at 0, -2 at
u) and its objective.  Shared by the request kinds that end in
``network_crossover``."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import network_lp as ref


def keep(state: dict, raw: dict) -> dict:
    """A request's ``Output`` and the crossover's stats, on the host."""
    out = raw["out"]
    return {"q": raw["q"], "x": out.x, "obj": out.obj_val,
            "vbasis": out.basis.vbasis if out.basis is not None else None,
            "status": out.status, "counters": raw["stats"]}


def units(rec: dict) -> int:
    return int(rec["status"] == "OPTIMAL")


def delivered(rec: dict) -> bool:
    return rec["status"] == "OPTIMAL"


def judge_outputs(state, records, network_of, numbers) -> list:
    """Per request, its ``numbers``.  A request whose outputs equal, bit
    for bit, outputs already judged for the same pool instance ``q`` takes
    their numbers; ``network_of(state, q)`` is the instance as the
    reference's ``Network``."""
    seen, out = {}, []
    for rec in records:
        outs = (rec["x"], rec["obj"], rec["vbasis"])
        nums = None
        for prev, prev_nums in seen.get(rec["q"], ()):
            if all(np.array_equal(a, b) for a, b in zip(prev, outs)):
                nums = prev_nums
                break
        if nums is None:
            nums = judge_output(network_of(state, rec["q"]), rec)
            seen.setdefault(rec["q"], []).append((outs, nums))
        out.append({k: nums[k] for k in numbers})
    return out


def judge_output(net: ref.Network, rec: dict) -> dict:
    """The reference's numbers for one ``Output`` on ``net``."""
    if rec["vbasis"] is None:
        return dict(ref.INF)
    x = np.asarray(rec["x"], np.float64)
    basic = np.flatnonzero(np.asarray(rec["vbasis"])[:net.n] == 0)
    return ref.judge(net, basic, x[:net.n], rec["obj"], extra=x[net.n:])


def control_output(net: ref.Network, rec: dict) -> dict:
    """The record with the program's float64 vertex and objective replaced
    by the reference's, computed in float32 from the returned basis."""
    vb = np.asarray(rec["vbasis"])
    basic = np.flatnonzero(vb[:net.n] == 0)
    x, obj = ref.vertex_of_basis(net, basic, vb[:net.n] == -2, torch.float32)
    if x is None:
        return rec
    return dict(rec, x=np.concatenate([x, np.zeros(vb.size - net.n)]),
                obj=obj)
