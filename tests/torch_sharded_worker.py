"""One gloo rank of the port's sharded parity tests; never imports jax.

    python tests/torch_sharded_worker.py RANK WORLD STORE OUT

Runs every sharded function of ``smart_crossover_tpu_torch.parallel`` on
CPU meshes of WORLD ranks (model-sharded (1, WORLD), batch-sharded
(WORLD, 1)) at the small sizes of ``CASES``, with float64 inputs, and
writes each rank's results to OUT/r<RANK>.npz.  The ranks meet on a
``FileStore`` at STORE.  ``tests/test_torch_sharded.py`` launches the ranks
and holds every rank's results to the JAX sharded functions at the same
mesh widths; it builds the JAX side's inputs with the same ``CASES``.
"""
from __future__ import annotations

import os
import sys

import numpy as np


def _ot(seed, S, D):
    """As tests/conftest.py::random_ot (s, d, M of one instance)."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, S)
    d = rng.uniform(0.5, 2.0, D)
    d *= s.sum() / d.sum()
    return s, d, rng.uniform(0.0, 5.0, (S, D))


def _ot_ties(seed, S, D):
    """Uniform supplies and demands over integer costs in {0, 1, 2, 3}:
    the plan, the flow indicators and the push see exact ties, so every
    tie rule (largest weight, then smallest global id) decides."""
    M = np.random.default_rng(seed).integers(0, 4, (S, D)).astype(float)
    return np.full(S, D / S), np.ones(D), M


def _ot_batch(seed, B, S, D):
    """As tests/test_parallel.py::make_batch."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(axis=1) / d.sum(axis=1))[:, None]
    return s, d, rng.uniform(0.0, 5.0, (B, S, D))


def _fleet(seed, B, m, n):
    """As tests/test_ipm_fleet.py::make_fleet: boxed equality LPs."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n))
    b = np.einsum("bmn,bn->bm", A, rng.uniform(0.2, 0.8, (B, n)))
    c = rng.standard_normal((B, n))
    return A, b, c, np.zeros((B, n)), np.ones((B, n))


def projector_case():
    rng = np.random.default_rng(1)
    return rng.standard_normal((24, 64)), rng.standard_normal(64)


def ranking_case():
    """As tests/test_parallel.py's ranking test: 40 nodes, 512 arcs."""
    rng = np.random.default_rng(3)
    m, n = 40, 512
    tails = rng.integers(0, m, n)
    heads = (tails + rng.integers(1, m, n)) % m
    u = rng.uniform(0.5, 3.0, n)
    x = rng.uniform(-0.2, 3.5, n)
    return x, tails, heads, u, m


def pdhg_case(mixed: bool):
    """A (12, 64) LP in [0, 1]; with ``mixed`` its last 6 rows are '<'."""
    rng = np.random.default_rng(4)
    m, n = 12, 64
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    sense = None
    if mixed:
        b[6:] += 0.1
        sense = np.array(["="] * 6 + ["<"] * 6)
    return A, b, rng.standard_normal(n), np.zeros(n), np.ones(n), sense


def sweep_case():
    """As tests/test_scenarios.py's mesh test: one (6, 16) LP, 8 RHS."""
    rng = np.random.default_rng(9)
    m, n, K = 6, 16, 8
    A = rng.standard_normal((m, n))
    b_sc = np.einsum("mn,kn->km", A, rng.uniform(0.2, 0.8, (K, n)))
    c = A.T @ rng.standard_normal(m) + np.abs(rng.standard_normal(n)) + 0.05
    return A, b_sc, c, np.zeros(n), np.ones(n)


# name -> (inputs, keyword arguments); every width of the tests (1, 2, 4)
# divides the sharded axis of each
CASES = {
    "projector": (projector_case(), dict(tol=1e-12, max_iter=200)),
    "sinkhorn": (_ot(2, 10, 16), dict(reg=0.2, num_iters=300)),
    "ranking": (ranking_case(), {}),
    "pdhg_eq": (pdhg_case(False), dict(num_iters=1000, restart_period=200)),
    "pdhg_mixed": (pdhg_case(True), dict(num_iters=1000, restart_period=200)),
    "tnet_8x16": (_ot(42, 8, 16), dict(reg=0.05, sinkhorn_iters=200)),
    "tnet_10x16": (_ot(3, 10, 16), dict(reg=0.02, sinkhorn_iters=300)),
    "tnet_ties": (_ot_ties(11, 8, 16), dict(reg=0.05, sinkhorn_iters=200)),
    "btnet": (_ot_batch(5, 8, 12, 16), dict(reg=0.05, sinkhorn_iters=100)),
    "exact": (_ot_batch(6, 8, 10, 12), dict(reg=0.01, sinkhorn_iters=300)),
    "fleet_batch": (_fleet(7, 8, 6, 16), dict(tol=1e-8)),
    "fleet_col": (_fleet(8, 1, 8, 32), dict(tol=1e-8)),
    "sweep": (sweep_case(), {}),
}
TNET_CASES = ("tnet_8x16", "tnet_10x16", "tnet_ties")
ENGINES = ("mega", "parent")


def run(rank: int, world: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from smart_crossover_tpu_torch import parallel as P
    from smart_crossover_tpu_torch.solvers.ipm_fleet import ipm_big, ipm_fleet

    P.init_distributed(device="cpu", store=dist.FileStore(store, world),
                       rank=rank, world_size=world)
    model = P.make_mesh(1, world, device="cpu")
    batch = P.make_mesh(world, 1, device="cpu")
    assert dict(model.shape) == {"batch": 1, "model": world}
    res = {}

    def np64(t):
        return t.double().numpy() if isinstance(t, torch.Tensor) else t

    (Y, v), kw = CASES["projector"]
    res["projector"] = np64(P.sharded_projector(model, Y, v, **kw))
    (s, d, M), kw = CASES["sinkhorn"]
    res["sinkhorn"] = np64(P.sharded_sinkhorn_plan(model, s, d, M, **kw))
    args, _ = CASES["ranking"]
    res["ranking"] = np64(P.sharded_mcf_flow_indicators(model, *args))
    res["ranking_queue"], res["ranking_sorted_ind"] = \
        P.sharded_sorted_flows(model, *args)
    for name in ("pdhg_eq", "pdhg_mixed"):
        (A, b, c, l, u, sense), kw = CASES[name]
        res[name + "_x"], res[name + "_y"] = P.sharded_pdhg(
            model, A, b, c, l, u, sense, **kw)
    for name in TNET_CASES:
        (s, d, M), kw = CASES[name]
        res[name + "_X"], res[name + "_push"] = P.sharded_tnet_single(
            model, s, d, M, **kw)

    (s, d, M), kw = CASES["btnet"]
    for key, t in zip(("X", "push", "obj"),
                      P.sharded_batched_tnet(batch, s, d, M, **kw)):
        res["btnet_" + key] = np64(t)
    (s, d, M), kw = CASES["exact"]
    for engine in ENGINES:
        out_ = P.sharded_batched_tnet_exact_device(
            batch, s, d, M, max_pivots=500, engine=engine, **kw)
        for key, t in zip(("X", "obj", "push", "pivots", "optimal", "Bm"),
                          out_):
            res[f"exact_{engine}_{key}"] = t.numpy()
    stats = {}
    X, obj, piv, opt = P.batched_tnet_exact(s, d, M, mesh=batch,
                                            stats=stats, **kw)
    res.update(exact_host_X=X, exact_host_obj=obj, exact_host_optimal=opt,
               exact_host_engine=stats["engine"])

    (A, b, c, l, u), kw = CASES["fleet_batch"]
    for refine in (False, True):
        fl = ipm_fleet(A, b, c, l, u, refine=refine, mesh=batch, **kw)
        tag = f"fleet_batch_{'refined' if refine else 'device'}"
        res.update({tag + "_x": fl.x, tag + "_y": fl.y, tag + "_obj": fl.obj,
                    tag + "_iters": fl.device_iters,
                    tag + "_status": np.array(fl.status)})
    (A, b, c, l, u), kw = CASES["fleet_col"]
    fl = ipm_fleet(A, b, c, l, u, refine=False, mesh=model, **kw)
    res.update(fleet_col_x=fl.x, fleet_col_y=fl.y,
               fleet_col_iters=fl.device_iters)
    big = ipm_big(A[0], b[0], c[0], l[0], u[0], mesh=model, **kw)
    res.update(big_x=big.x, big_obj=big.obj_val, big_status=big.status,
               big_device_iters=big.device_iters)

    (A, b_sc, c, l, u), _ = CASES["sweep"]
    sw = P.lp_scenario_sweep(A, b_sc[0], c, l, u, b_scenarios=b_sc,
                             mesh=batch)
    res.update(sweep_obj=sw["obj"], sweep_status=np.array(sw["status"]))

    # the mesh's own contract
    bads = [lambda: P.make_mesh(world + 1, 1, device="cpu")]
    if world > 1:
        bads.append(lambda: model.slice("model", 4 * world + 1))
    for bad in bads:
        try:
            bad()
            res.setdefault("errors", []).append("no ValueError")
        except ValueError:
            pass
    res["errors"] = np.array(res.get("errors", []), dtype=str)

    res["jax_imported"] = np.array(
        [m for m in sys.modules if m == "jax" or m.startswith("jax.")
         or m.split(".")[0] == "smart_crossover_tpu"], dtype=str)
    if res["jax_imported"].size:
        raise RuntimeError(f"the worker imported {res['jax_imported']}")
    np.savez(os.path.join(out, f"r{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    run(rank, world, sys.argv[3], sys.argv[4])
