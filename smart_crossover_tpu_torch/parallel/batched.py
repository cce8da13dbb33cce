"""Batched TNET pipelines, from Sinkhorn warm start to exact vertices.

Port of ``smart_crossover_tpu/parallel/batched.py`` (``tnet_single``,
``batched_tnet``, ``batched_tnet_exact_device``, ``batched_tnet_exact``).
Every stage takes the instance batch as a leading axis.  The Sinkhorn
stage always runs the fused route: per-instance eps = reg * max(M_b) is
folded into the cost and the fused kernel runs at reg = 1 (the plan is
invariant under (M / eps, eps = 1)).  The pivot stage runs one of the
device transportation-simplex engines: the in-kernel pivot loop ('mega',
K2) or the batched tensor engines 'parent', 'anc', 'packed' and 'mask'
(``ENGINES``); the host route cleans up with the native network simplex.
The ``sharded_*`` functions split the batch over a mesh's 'batch' axis
(``parallel/mesh.py``): each rank runs its slice through the single-device
pipeline, kernels included, and the results are all-gathered.
"""
from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np
import torch

from smart_crossover_tpu_torch.config import (
    resolve_device,
    to_device,
    use_kernel,
)
from smart_crossover_tpu_torch.models import Basis, OptTransport
from smart_crossover_tpu_torch.network_methods.certify import (
    certify_ot_basis_batch,
)
from smart_crossover_tpu_torch.network_methods.tree_bi import (
    identify_tree_flows,
)
from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
from smart_crossover_tpu_torch.ops.ranking import ot_flow_indicators
from smart_crossover_tpu_torch.ops.sinkhorn_fused import (
    sinkhorn_plan_fused,
    sinkhorn_plan_fused_plain,
)
from smart_crossover_tpu_torch.ops.transport_simplex import (
    batched_transport_simplex,
)
from smart_crossover_tpu_torch.ops.transport_simplex_anc import (
    batched_transport_simplex_anc,
)
from smart_crossover_tpu_torch.ops.transport_simplex_mega import (
    batched_transport_simplex_mega,
    cluster_plan,
)
from smart_crossover_tpu_torch.ops.transport_simplex_packed import (
    batched_transport_simplex_packed,
)
from smart_crossover_tpu_torch.ops.transport_simplex_parent import (
    batched_transport_simplex_parent,
)
from smart_crossover_tpu_torch.parallel.mesh import BATCH_AXIS
from smart_crossover_tpu_torch.solvers.network_simplex import network_simplex
from smart_crossover_tpu_torch.solvers.sinkhorn import round_to_feasible
from smart_crossover_tpu_torch.utils import trace

# the device pivot engines: (X0, Bm0, M, max_pivots=) -> (X, Bm, pivots,
# optimal); 'device' names the JAX package's default, 'parent'
ENGINES = {"mega": batched_transport_simplex_mega,
           "parent": batched_transport_simplex_parent,
           "anc": batched_transport_simplex_anc,
           "packed": batched_transport_simplex_packed,
           "mask": batched_transport_simplex}


def _engine(engine: str) -> str:
    name = "parent" if engine == "device" else engine
    if name not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: the device simplex "
                         f"engines are {sorted(ENGINES)} and 'device'")
    return name


def _on_device(s, d, M, device):
    dev = resolve_device(device, M)
    with trace.span("scx.upload", dev):
        M = to_device(M, dev)
        return to_device(s, dev, M.dtype), to_device(d, dev, M.dtype), M


def _warm_start(s, d, M, reg: float, sinkhorn_iters: int,
                tree_weights: str = "flow", use_pallas: bool | None = None):
    if tree_weights not in ("flow", "reduced_cost"):
        raise ValueError(f"tree_weights must be 'flow' or 'reduced_cost', "
                         f"got {tree_weights!r}")
    with trace.span("scx.sinkhorn_kernel", M.device):
        eps = reg * M.amax((1, 2))
        Mn = (M / eps[:, None, None]).contiguous()
        sink = sinkhorn_plan_fused if use_kernel(use_pallas, M.device) \
            else sinkhorn_plan_fused_plain
        plan, f, g = sink(s, d, Mn, 1.0, sinkhorn_iters)
    with trace.span("scx.round_indicators", M.device):
        if tree_weights == "reduced_cost":
            # the JAX package's -(M - f - g) over eps: a positive
            # per-instance scaling, which leaves Borůvka's tree unchanged
            W = -(Mn - f[:, :, None] - g[:, None, :])
        else:
            W = ot_flow_indicators(round_to_feasible(plan, s, d), s, d)
    return identify_tree_flows(W, s, d)


def batched_tnet(s, d, M, reg: float = 0.02, sinkhorn_iters: int = 200,
                 tree_weights: str = "flow",
                 use_pallas: bool | None = None, *, device=None):
    """TNET over a batch: s (B, S), d (B, D), M (B, S, D), numpy arrays or
    tensors.  ``tree_weights='reduced_cost'`` builds the spanning tree from
    the Sinkhorn potentials instead of the flow indicators.  ``use_pallas``
    picks the Sinkhorn kernel (None on a card, or True) or its plain
    version (False, or None on the CPU; True without a card raises).
    ``device``: M's device if M is a tensor, else the CUDA card (without one
    that default raises).  Returns (X_vertex, push_iters, obj), tensors on
    the device."""
    s, d, M = _on_device(s, d, M, device)
    X, push = _warm_start(s, d, M, reg, sinkhorn_iters, tree_weights,
                          use_pallas)
    return X, push, (X * M).sum((1, 2))


def tnet_single(s, d, M, reg: float = 0.02, sinkhorn_iters: int = 200,
                tree_weights: str = "flow", *, device=None):
    """One instance, s (S,), d (D,), M (S, D): Sinkhorn -> indicators ->
    MST -> tree solve -> push.  Returns (X_vertex, push_iters, obj)."""
    X, push, obj = batched_tnet(s[None], d[None], M[None], reg,
                                sinkhorn_iters, tree_weights, device=device)
    return X[0], push[0], obj[0]


# the basis check's tolerance on a plan's node balances and signs, over
# the instance's largest mass: float32 flows drift from their basis's
# exact vertex by up to ~1e-5 of it over 20,000 pivots, while a plan that
# leaves out a node misses by that node's whole mass
BASIS_CHECK_TOL = 1e-3


def basis_check(X, Bm, s, d):
    """Per instance, whether the plan X (B, S, D) can be the vertex of
    the basis Bm: Bm holds S + D - 1 arcs, and X is non-negative and
    meets s and d, within ``BASIS_CHECK_TOL`` of the instance's largest
    mass.  One batched reduction on X's device, no host read."""
    B, S, D = X.shape
    X = X.to(s.dtype)
    arcs = Bm.reshape(B, -1).sum(1) == S + D - 1
    off = torch.maximum((X.sum(2) - s).abs().amax(1),
                        (X.sum(1) - d).abs().amax(1))
    off = torch.maximum(off, -X.reshape(B, -1).amin(1))
    return arcs & (off <= BASIS_CHECK_TOL
                   * torch.maximum(s.amax(1), d.amax(1)))


def batched_tnet_exact_device(s, d, M, reg: float = 0.005,
                              sinkhorn_iters: int = 1000,
                              max_pivots: int = 5000,
                              engine: str = "mega",
                              chunk_b: int | None = None, *, device=None):
    """Exact batched OT crossover on one device.

    The TNET pipeline finds a feasible tree vertex per instance; Borůvka
    over its support (X0 > 1e-12) completes a spanning-tree basis, and the
    transportation simplex pivots it to optimality.

    Args:
        s, d, M: (B, S), (B, D), (B, S, D) numpy arrays or tensors.
        engine: the pivot engine (``ENGINES``): 'mega' (default), the
            whole pivot loop in one kernel launch; 'parent' (the JAX
            package's default; 'device' names it too), 'anc', 'packed'
            and 'mask' (the oracle), batched tensor code that pivots the
            batch in lockstep.
        chunk_b: the JAX package's ``lax.map`` chunk size; a no-op here
            (every engine runs the whole batch at once).
        device: where to run (default: M's device if M is a tensor, else
            the CUDA card; without one that default raises).  On CUDA the
            stages run in float32 (the Sinkhorn and 'mega' through the
            hand-written kernels); with ``device="cpu"`` in the input's
            dtype (the kernels through their plain versions).

    Masses may be 0 (a blank pixel kept as a point).  ``optimal`` holds
    only where the engine called the basis optimal and ``basis_check``
    accepts its plan (span ``scx.basis_check``).  While the tracer
    records, ``scx.route`` counts the batch's zero-mass nodes
    (``route.zero_nodes``) and the instances the check turned down
    (``route.refused``).

    Returns (X, obj, push_iters, pivots, optimal, basis_mask), batched
    tensors on ``device``; ``network_methods.certify`` recomputes the exact
    f64 vertex from basis_mask.
    """
    pivot = ENGINES[_engine(engine)]
    dev = resolve_device(device, M)
    with trace.span("scx.route", dev):
        s, d, M = _on_device(s, d, M, dev)
        recording = trace.TRACER.recording_now()
        if recording:
            trace.count("route.zero_nodes",
                        int((s == 0).sum() + (d == 0).sum()))
        X0, push = _warm_start(s, d, M, reg, sinkhorn_iters)
        with trace.span("scx.boruvka_support", dev):
            # the support first, then arcs between nonzero masses: the
            # tree joins the nonzero-mass nodes among themselves and hangs
            # the zero-mass ones off them (the same tree where no mass is 0)
            live = (s > 0)[:, :, None] & (d > 0)[:, None, :]
            Bm0 = boruvka_bipartite_mst(2 * (X0 > 1e-12).to(M.dtype)
                                        + live.to(M.dtype))
        X, Bm, pivots, claimed = pivot(X0, Bm0, M, s, d,
                                       max_pivots=max_pivots)
        with trace.span("scx.basis_check", dev):
            optimal = claimed & basis_check(X, Bm, s, d)
            if recording:
                trace.count("route.refused", int((claimed & ~optimal).sum()))
        obj = (X.to(M.dtype) * M).sum((1, 2))
    return X, obj, push, pivots, optimal, Bm


def _batch_slice(mesh, *arrays):
    """This rank's block of each array along the batch (leading) axis."""
    lo, hi = mesh.slice(BATCH_AXIS, arrays[-1].shape[0])
    return [a[lo:hi] for a in arrays]


def sharded_batched_tnet(mesh, s, d, M, reg: float = 0.02,
                         sinkhorn_iters: int = 200):
    """``batched_tnet`` with the instance batch split over the mesh's
    'batch' axis (B divisible by its width): each rank runs its instances
    (the Sinkhorn kernel on a card) and the results are all-gathered.
    Returns (X_vertex, push_iters, obj), full-batch tensors on the rank's
    device."""
    out = batched_tnet(*_batch_slice(mesh, s, d, M), reg=reg,
                       sinkhorn_iters=sinkhorn_iters, device=mesh.device)
    return tuple(mesh.gather(t, BATCH_AXIS) for t in out)


def sharded_batched_tnet_exact_device(mesh, s, d, M, reg: float = 0.005,
                                      sinkhorn_iters: int = 1000,
                                      max_pivots: int = 5000,
                                      engine: str = "mega"):
    """``batched_tnet_exact_device`` with the batch split over the mesh's
    'batch' axis: each rank runs the warm start and the pivot engine on
    its instances (on a card the Sinkhorn kernel and, with 'mega', the
    pivot-loop kernel, once per rank), with no cross-instance collective,
    and the six outputs are all-gathered.  The default engine is 'mega',
    as ``batched_tnet_exact_device``'s (the JAX package's: 'parent')."""
    out = batched_tnet_exact_device(
        *_batch_slice(mesh, s, d, M), reg=reg, sinkhorn_iters=sinkhorn_iters,
        max_pivots=max_pivots, engine=engine, device=mesh.device)
    return tuple(mesh.gather(t, BATCH_AXIS) for t in out)


def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)


def _solve_ot(s, d, M, vbasis):
    """The native network simplex on one OT instance from a warm vbasis
    over its S*D cells (cbasis roots the tree at the last node)."""
    mcf = OptTransport(s=s, d=d, M=M).to_MCF()
    cbasis = np.concatenate([-np.ones(mcf.m - 1, dtype=np.int32), [0]])
    return network_simplex(mcf, warm_basis=Basis(vbasis, cbasis))


def batched_tnet_exact(s, d, M, reg: float = 0.005,
                       sinkhorn_iters: int = 1000, mesh=None,
                       engine: str = "auto",
                       max_pivots: int | None = None, *, device=None,
                       stats: dict | None = None):
    """Batched crossover to EXACT optimal vertices, certified in float64.

    ``engine='host'``: the device runs the batched TNET pipeline (the fused
    Sinkhorn kernel); the native network simplex then cleans each instance
    up on the host from the support X > 0 of its tree vertex, over
    min(cpu_count, 8) threads (the core releases the interpreter lock).

    ``engine='mega'``, or a tensor engine ('parent', 'device' = 'parent',
    'anc', 'packed', 'mask'): ``batched_tnet_exact_device`` with that
    pivot engine; every returned basis is certified in f64
    (``certify_ot_basis_batch``, on ``device``: the card's kernel, or SciPy
    on the CPU), and each instance that fails or hit
    the pivot cap (``max_pivots``, default max(5000, 8 (S + D))) is
    repaired by the native network simplex warm-started from its device
    basis, whose pivots are added to its count.

    ``engine='auto'``: 'mega' where the pivot-loop kernel's layout
    (``transport_simplex_mega.cluster_plan``) fits the shape, else 'host'.
    This replaces the JAX package's TPU-only rule.  With a ``mesh`` every
    engine takes the host route, as in the JAX package, its device stage
    ``sharded_batched_tnet`` on the mesh's device (``device`` unused).

    Both routes rescale d to sum(s) on the host (f32 mass drift) before
    the exact solves, so the returned vertices are exact f64 whatever the
    device precision.  ``device`` is as in ``batched_tnet``.  ``stats``, if
    given, gets the route taken (``engine``), the device and host seconds
    (``device_s``, ``host_s``) and the number of instances repaired
    (``repaired``, the device engines only).

    Returns (X, obj, pivots, optimal) as numpy arrays.
    """
    if engine not in ("auto", "host"):
        engine = _engine(engine)
    B, S, D = M.shape
    if mesh is not None:
        engine = "host"
    if engine == "auto":
        try:
            cluster_plan(B, S, D)
            engine = "mega"
        except ValueError:
            engine = "host"
    stats = {} if stats is None else stats
    stats["engine"] = engine
    s64, M64 = _host64(s), _host64(M)
    d64 = _host64(d)
    d64 = d64 * (s64.sum(1) / d64.sum(1))[:, None]  # f32 mass drift
    if engine != "host":
        if max_pivots is None:
            # pivot counts from warm starts grow ~linearly in V
            max_pivots = max(5000, 8 * (S + D))
        with trace.span("scx.exact.device", stats=stats, key="device_s"):
            *_, piv, opt, Bm = batched_tnet_exact_device(
                s, d, M, reg=reg, sinkhorn_iters=sinkhorn_iters,
                max_pivots=max_pivots, engine=engine, device=device)
            piv_n = piv.cpu().numpy().astype(np.int64)
            opt_n = opt.cpu().numpy().astype(bool)
        with trace.span("scx.exact.host", stats=stats, key="host_s"):
            # the masks where they lie; the host reads them only to repair
            certs = certify_ot_basis_batch(Bm, s64, d64, M64, device=device)
            Xn = np.stack([c.x for c in certs])
            obj_n = np.array([c.obj_val for c in certs])
            ok = opt_n & np.array([c.ok for c in certs])
            # certification failures / pivot-capped instances: warm-start
            # the native core from the device basis
            bad = np.flatnonzero(~ok)
            Bm_n = Bm[torch.from_numpy(bad).to(Bm.device)].cpu().numpy()
            for i, mask in zip(bad, Bm_n):
                vbasis = np.where(mask.ravel(), 0, -1).astype(np.int32)
                res = _solve_ot(s64[i], d64[i], M64[i], vbasis)
                Xn[i] = res.x.reshape(S, D)
                obj_n[i] = res.obj_val
                piv_n[i] += res.iter_count
                ok[i] = res.status == "OPTIMAL"
            trace.count("exact.repaired", int(bad.size), stats, "repaired")
        return Xn, obj_n, piv_n, ok

    with trace.span("scx.exact.device", stats=stats, key="device_s"):
        if mesh is not None:
            X, _, _ = sharded_batched_tnet(mesh, s, d, M, reg=reg,
                                           sinkhorn_iters=sinkhorn_iters)
        else:
            X, _, _ = batched_tnet(s, d, M, reg=reg,
                                   sinkhorn_iters=sinkhorn_iters,
                                   device=device)
        X = X.to("cpu", torch.float64).numpy()
    out_X = np.empty_like(X)
    out_obj = np.empty(B)
    pivots = np.empty(B, dtype=np.int64)
    optimal = np.zeros(B, dtype=bool)

    def cleanup(i: int) -> None:
        vbasis = np.where(X[i].ravel() > 0, 0, -1).astype(np.int32)
        res = _solve_ot(s64[i], d64[i], M64[i], vbasis)
        out_X[i] = res.x.reshape(S, D)
        out_obj[i] = res.obj_val
        pivots[i] = res.iter_count
        optimal[i] = res.status == "OPTIMAL"

    workers = min(max(os.cpu_count() or 1, 1), 8)
    with trace.span("scx.exact.host", stats=stats, key="host_s"):
        if workers > 1 and B > 1:
            with cf.ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(cleanup, range(B)))
        else:
            for i in range(B):
                cleanup(i)
    return out_X, out_obj, pivots, optimal
