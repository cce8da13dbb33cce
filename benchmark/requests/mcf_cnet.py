"""Request kind: one min-cost-flow instance through the first-order warm
start and CNET_MCF.

A request builds a fresh ``MinCostFlow`` from the pool's arc list, runs
the sparse PDHG on the card (``pdhg_mcf_device``: Halpern, float32) and
then ``network_crossover(method="cnet_mcf")``: the ranking on the card,
column generation with the native network simplex on the host in
float64.  It delivers the vertex when the crossover reports OPTIMAL.

Judged for every request against the reference
(``reference/network_lp.py``) on the pool's own instance: ``vertex_err``,
``obj_err`` and ``rcost_err`` of the returned ``Output``, the last against
the reduced-cost tolerance the configuration states (``certificate``, on
costs scaled by max |c|, as CNET_MCF scales them); the artificial arcs
that CNET_MCF appends after the instance's own have to carry nothing.

Set-up runs the warm start once on the first pool instance with
``warm_pdhg_iters`` iterations (the sparse operator, cuSPARSE and every
kernel of the Halpern loop, restarts included) and CNET_MCF once on a
``warm_cnet_grid`` square instance of the same generator (the native
core's load and the ranking's kernels), so that nothing loads in the
window.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.gen.goto import goto_like
from benchmark.gen.seeds import item_seeds
from benchmark.harness.network_output import (  # noqa: F401
    control_output,
    delivered,
    judge_outputs,
    keep,
    units,
)
from benchmark.reference import network_lp as ref

NUMBERS = ("vertex_err", "obj_err", "rcost_err")


def _instance(config: dict, width: int, height: int, seed: int) -> dict:
    return goto_like(width, height,
                     extra_arc_factor=config["extra_arc_factor"],
                     supply=config["supply"], max_cost=config["max_cost"],
                     max_cap=config["max_cap"], seed=seed,
                     regular=config["regular"])


def _mcf(arcs: dict):
    from smart_crossover_tpu_torch.models import MinCostFlow

    return MinCostFlow(tails=arcs["tails"].copy(), heads=arcs["heads"].copy(),
                       c=arcs["c"].copy(), u=arcs["u"].copy(),
                       b=arcs["b"].copy())


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    from smart_crossover_tpu_torch.network_methods.algorithms import (
        network_crossover,
    )
    from smart_crossover_tpu_torch.solvers.pdhg_mcf import pdhg_mcf_device

    P = traffic["pool"]
    seeds = item_seeds(seed, P + 2)
    pool = [_instance(config, config["width"], config["height"], sd)
            for sd in seeds[:P]]
    state = {"config": config, "traffic": traffic, "device": device,
             "pool": pool, "P": P,
             "order": np.random.default_rng(seeds[P]).permutation(P)}
    pdhg_mcf_device(_mcf(pool[0]), tol=config["warm_tol"],
                    max_iters=traffic["warm_pdhg_iters"],
                    mode=config["warm_mode"], dtype=torch.float32,
                    device=device)
    g = traffic["warm_cnet_grid"]
    small = _mcf(_instance(config, g, g, seeds[P + 1]))
    wx, *_ = pdhg_mcf_device(small, tol=config["warm_tol"],
                             max_iters=config["warm_iters"],
                             mode=config["warm_mode"], dtype=torch.float32,
                             device=device)
    network_crossover(x=wx, mcf=small, method="cnet_mcf", device=device)
    return state


def prepare(state: dict, k: int) -> dict:
    q = int(state["order"][k % state["P"]])
    return {"q": q, "mcf": _mcf(state["pool"][q])}


def send(state: dict, inp: dict, spans) -> dict:
    from smart_crossover_tpu_torch.network_methods.algorithms import (
        network_crossover,
    )
    from smart_crossover_tpu_torch.solvers.pdhg_mcf import pdhg_mcf_device

    cfg, mcf, stats = state["config"], inp["mcf"], {}
    with spans.span("warm_start"):
        wx, _, iters, _, _ = pdhg_mcf_device(
            mcf, tol=cfg["warm_tol"], max_iters=cfg["warm_iters"],
            mode=cfg["warm_mode"], dtype=torch.float32,
            device=state["device"])
    with spans.span("network_crossover"):
        out = network_crossover(x=wx, mcf=mcf, method="cnet_mcf",
                                device=state["device"], stats=stats)
    stats["pdhg_iters"] = iters
    return {"q": inp["q"], "out": out, "stats": stats}


def network(state: dict, q: int) -> ref.Network:
    a = state["pool"][q]
    return ref.Network(a["tails"], a["heads"], a["c"], a["u"], a["b"],
                       rc_scale=float(np.abs(a["c"]).max()))


def judge(state: dict, records: list) -> list:
    return judge_outputs(state, records, network, NUMBERS)


def control(state: dict, rec: dict) -> dict:
    """The reference in the program's place one precision below the
    configuration's float64: the vertex of the returned basis and its
    objective computed in float32."""
    return control_output(network(state, rec["q"]), rec)
