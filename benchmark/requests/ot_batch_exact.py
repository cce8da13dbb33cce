"""Request kind: one batch of OT instances to exact vertices on the
device, each certified in float64 on the host.

A request hands fresh copies of its batch to the port's device route,
``batched_tnet_exact_device(engine="mega")`` (the Sinkhorn kernel K1,
rounding, flow indicators, Borůvka, tree solve, push, Borůvka over the
support, then the pivot-loop kernel K2, all float32), and then the
basis masks it returns, with the float64 instance, to
``certify_ot_basis_batch``, which recomputes each basis's vertex and
duals in float64 and accepts it or not.  Each instance's answer is the
device's basis, flows and objective; an instance the certificate
accepts is delivered as a certified exact vertex (``units``).  A request
delivers where the device reports every instance optimal.

Judged for every instance of every request against the reference
(``reference/network_lp.py::judge_ot_basis``) on the pool's own float64
instance: ``device_gap`` (the device's objective, and how far its
basis's float64 vertex can lie above the optimum) and ``device_err``
(that vertex's feasibility); for the instances the program certified,
``obj_err`` and ``rcost_err`` of the float64 objective and basis, and
``sign_err``, the vertex's largest bound violation, which the
configuration's certificate holds to its stated feasibility tolerance
(absolute).  In a
sample of the requests drawn from the seed (one in ``sample_every``) it
also keeps the device's float32 flows and the certified float64
vertices, and judges those flows (``device_err``) and vertices
(``vertex_err``) too.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.gen.dotmark import cost, white_noise
from benchmark.gen.seeds import item_seeds
from benchmark.harness.spans import OFF
from benchmark.reference import network_lp as ref

NUMBERS = ("device_err", "device_gap", "vertex_err", "sign_err", "obj_err",
           "rcost_err")


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    B, P, side = traffic["batch"], traffic["pool_batches"], config["side"]
    data_seed, order_seed, sample_seed = item_seeds(seed, 3)
    s, d = white_noise(B * P, side, data_seed)
    state = {"config": config, "traffic": traffic, "device": device,
             "s": s, "d": d, "M": cost(side), "B": B, "P": P,
             "order": np.random.default_rng(order_seed).permutation(P),
             "sample": np.random.default_rng(sample_seed)}
    for _ in range(traffic.get("warm_requests", 1)):
        send(state, prepare(state, -1), OFF)
    return state


def prepare(state: dict, k: int) -> dict:
    """Fresh copies of request k's batch: masses in float64, the integer
    costs in float32, which holds them exactly.  Request k keeps its
    outputs whole with probability 1 / ``sample_every``."""
    B, p = state["B"], int(state["order"][k % state["P"]])
    sl = slice(p * B, (p + 1) * B)
    M = np.empty((B,) + state["M"].shape, np.float32)
    M[...] = state["M"]
    whole = k >= 0 and state["sample"].random() * state["traffic"][
        "sample_every"] < 1.0
    return {"p": p, "whole": whole, "s": state["s"][sl].copy(),
            "d": state["d"][sl].copy(), "M": M}


def send(state: dict, inp: dict, spans) -> dict:
    from smart_crossover_tpu_torch.network_methods.certify import (
        certify_ot_basis_batch,
    )
    from smart_crossover_tpu_torch.parallel.batched import (
        batched_tnet_exact_device,
    )

    cfg = state["config"]
    with spans.span("ot_device"):
        X, obj, _, piv, opt, Bm = batched_tnet_exact_device(
            inp["s"], inp["d"], inp["M"], reg=cfg["reg"],
            sinkhorn_iters=cfg["sinkhorn_iters"],
            max_pivots=cfg["max_pivots"], engine="mega",
            device=state["device"])
        Bm_n = Bm.cpu().numpy()
        obj_n = obj.cpu().double().numpy()
        opt_n = opt.cpu().numpy().astype(bool)
        piv_n = piv.cpu().numpy()
    with spans.span("certify"):
        certs = certify_ot_basis_batch(Bm_n, inp["s"], inp["d"], inp["M"])
    B, S, D = inp["M"].shape
    return {"p": inp["p"], "Bm": Bm_n, "obj_dev": obj_n, "opt": opt_n,
            "X_dev": X if inp["whole"] else None, "certs": certs,
            "counters": {"instances": B, "k1_shape": (B, S, D),
                         "pivots": float(piv_n.mean()),
                         "certified": int(sum(c.ok for c in certs))}}


def keep(state: dict, raw: dict) -> dict:
    certs = raw["certs"]
    whole = raw["X_dev"] is not None
    return {"p": raw["p"], "Bm": raw["Bm"], "obj_dev": raw["obj_dev"],
            "opt": raw["opt"], "X_dev": raw["X_dev"],
            "cert_ok": np.array([c.ok for c in certs], bool),
            "cert_obj": np.array([c.obj_val for c in certs]),
            "cert_x": [c.x for c in certs] if whole else None,
            "counters": raw["counters"]}


def units(rec: dict) -> int:
    """The instances delivered as certified exact vertices."""
    return int((rec["opt"] & rec["cert_ok"]).sum())


def delivered(rec: dict) -> bool:
    """The device reported every instance of the batch optimal."""
    return bool(rec["opt"].all())


def network(state: dict, q: int) -> ref.Network:
    return ref.ot_network(state["s"][q], state["d"][q], state["M"])


def _host(X) -> np.ndarray | None:
    if X is None:
        return None
    return X.detach().to("cpu", torch.float64).numpy()


def judge(state: dict, records: list) -> list:
    """Per request, the largest of each number over its instances.  An
    instance whose answer equals, bit for bit, one already judged for the
    same pool instance takes its numbers."""
    B, seen, out = state["B"], {}, []
    for rec in records:
        X = _host(rec["X_dev"])
        worst = dict.fromkeys(NUMBERS, 0.0)
        for i in range(B):
            q = rec["p"] * B + i
            ok = bool(rec["opt"][i] and rec["cert_ok"][i])
            ans = (rec["Bm"][i], rec["obj_dev"][i], ok, rec["cert_obj"][i],
                   None if X is None else X[i],
                   None if rec["cert_x"] is None else rec["cert_x"][i])
            nums = None
            for prev, prev_nums in seen.get(q, ()):
                if all(a is b or (a is not None and b is not None
                                  and np.array_equal(a, b))
                       for a, b in zip(prev, ans)):
                    nums = prev_nums
                    break
            if nums is None:
                nums = ref.judge_ot_basis(
                    network(state, q), np.flatnonzero(ans[0].ravel()),
                    ans[1], ans[4], ok, ans[3], ans[5])
                seen.setdefault(q, []).append((ans, nums))
            for k in NUMBERS:
                if not nums[k] <= worst[k]:
                    worst[k] = nums[k]
        out.append(worst)
    return out


def control(state: dict, rec: dict) -> dict:
    """The reference in the program's place one precision below each
    stage's: the device's flows and objective as the vertex of its basis
    in bfloat16 (float32 stage), the certified vertices and objectives
    in float32 (float64 stage)."""
    B = state["B"]
    obj_dev, cert_obj = rec["obj_dev"].copy(), rec["cert_obj"].copy()
    X = _host(rec["X_dev"])
    cert_x = None if rec["cert_x"] is None else list(rec["cert_x"])
    for i in range(B):
        net = network(state, rec["p"] * B + i)
        basic = np.flatnonzero(rec["Bm"][i].ravel())
        none = np.zeros(net.n, bool)
        xb, ob = ref.vertex_of_basis(net, basic, none, torch.bfloat16)
        xf, of = ref.vertex_of_basis(net, basic, none, torch.float32)
        if xb is None:
            continue
        obj_dev[i], cert_obj[i] = ob, of
        if X is not None:
            X[i] = xb.reshape(X[i].shape)
        if cert_x is not None:
            cert_x[i] = xf.reshape(cert_x[i].shape)
    return dict(rec, obj_dev=obj_dev, cert_obj=cert_obj,
                X_dev=None if X is None else torch.from_numpy(X),
                cert_x=cert_x)
