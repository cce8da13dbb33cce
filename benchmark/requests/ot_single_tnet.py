"""Request kind: one OT instance through the paper's TNET.

The pool is ``pool`` MNIST-style pairs drawn from the seed and built as
the reference builds them (``gen/digits.py``: zero pixels dropped, unit
masses, L1 grid cost), so S and D differ from instance to instance.  A
request builds a fresh ``OptTransport``, warm-starts it with
``sinkhorn(ot)`` (the Sinkhorn kernel K1 at B = 1 on the card) and runs
``network_crossover(method="tnet")``: the flow ranking on the card, tree
basis identification and column generation with the native network
simplex on the host in float64.  It delivers the vertex when the
crossover reports OPTIMAL.

Judged for every request against the reference
(``reference/network_lp.py``) on the pool's own float64 instance:
``vertex_err``, ``obj_err`` and ``rcost_err`` of the returned ``Output``
(its x, its basis and its objective), the last against the reduced-cost
tolerance the configuration states (``certificate``).
"""
from __future__ import annotations

import numpy as np

from benchmark.gen.digits import pairs
from benchmark.gen.seeds import item_seeds
from benchmark.harness.spans import OFF
from benchmark.harness.network_output import (  # noqa: F401
    control_output,
    delivered,
    judge_outputs,
    keep,
    units,
)
from benchmark.reference import network_lp as ref

NUMBERS = ("vertex_err", "obj_err", "rcost_err")


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    P = traffic["pool"]
    data_seed, order_seed = item_seeds(seed, 2)
    pool = pairs(P, data_seed, config["side"], config["blobs"],
                 config["amplify"])
    s, d, M = ([inst[i] for inst in pool] for i in range(3))
    state = {"config": config, "traffic": traffic, "device": device,
             "s": s, "d": d, "M": M, "P": P,
             "order": np.random.default_rng(order_seed).permutation(P)}
    for k in range(traffic.get("warm_requests", 1)):
        send(state, prepare(state, k), OFF)
    return state


def prepare(state: dict, k: int) -> dict:
    from smart_crossover_tpu_torch.models import OptTransport

    q = int(state["order"][k % state["P"]])
    return {"q": q, "ot": OptTransport(s=state["s"][q].copy(),
                                       d=state["d"][q].copy(),
                                       M=state["M"][q].copy())}


def send(state: dict, inp: dict, spans) -> dict:
    from smart_crossover_tpu_torch.network_methods.algorithms import (
        network_crossover,
    )
    from smart_crossover_tpu_torch.solvers.sinkhorn import sinkhorn

    cfg, ot, stats = state["config"], inp["ot"], {}
    with spans.span("sinkhorn"):
        x = sinkhorn(ot, reg=cfg["reg"], num_iters=cfg["sinkhorn_iters"],
                     device=state["device"])
    with spans.span("network_crossover"):
        out = network_crossover(x=x, ot=ot, method="tnet",
                                device=state["device"], stats=stats)
    stats["k1_shape"] = (1, *ot.M.shape)
    return {"q": inp["q"], "out": out, "stats": stats}


def network(state: dict, q: int) -> ref.Network:
    return ref.ot_network(state["s"][q], state["d"][q], state["M"][q])


def judge(state: dict, records: list) -> list:
    return judge_outputs(state, records, network, NUMBERS)


def control(state: dict, rec: dict) -> dict:
    """The reference in the program's place one precision below the
    configuration's float64: the vertex of the returned basis and its
    objective computed in float32."""
    return control_output(network(state, rec["q"]), rec)
