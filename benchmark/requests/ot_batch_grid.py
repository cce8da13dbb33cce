"""Request kind: one batch of MNIST-style pairs on the full pixel grid to
exact vertices on the device, each certified in float64 on the host.

The request, its delivery and its judgement are ``ot_batch_exact``'s,
taken from that kind's own module: ``batched_tnet_exact_device(engine=
"mega")``, then ``certify_ot_basis_batch``, judged for every instance by
``reference/network_lp.py::judge_ot_basis``.  Only the pool differs:
``setup`` draws it from ``gen/digits_grid.py``, every pixel of both
images a point (blank ones of mass 0), so that a batch has one shape,
with the L1 grid cost.
"""
from __future__ import annotations

import numpy as np

from benchmark.gen.digits_grid import grid_cost, grid_pairs
from benchmark.gen.seeds import item_seeds
from benchmark.harness.spans import OFF
from benchmark.harness.spec import request_kind

_exact = request_kind("ot_batch_exact")

NUMBERS = _exact.NUMBERS
prepare, send, keep = _exact.prepare, _exact.send, _exact.keep
units, delivered = _exact.units, _exact.delivered
network, judge, control = _exact.network, _exact.judge, _exact.control


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    B, P, side = traffic["batch"], traffic["pool_batches"], config["side"]
    data_seed, order_seed, sample_seed = item_seeds(seed, 3)
    s, d = grid_pairs(B * P, data_seed, side, config["blobs"],
                      config["amplify"])
    state = {"config": config, "traffic": traffic, "device": device,
             "s": s, "d": d, "M": grid_cost(side), "B": B, "P": P,
             "order": np.random.default_rng(order_seed).permutation(P),
             "sample": np.random.default_rng(sample_seed)}
    for _ in range(traffic.get("warm_requests", 1)):
        send(state, prepare(state, -1), OFF)
    return state
