"""Batched transportation simplex with the whole pivot loop on the card.

Replaces the TPU kernel ``smart_crossover_tpu/ops/transport_simplex_mega.py::
_mega_kernel`` (wrapper ``batched_transport_simplex_mega``).  The CUDA
kernel (``csrc/transport_simplex_mega.cu``) runs one instance per
thread-block cluster, the whole solve in one launch; the plain version
here runs the same algorithm as batched tensor code, one Python-driven
pivot step for the whole batch at a time, finished instances masked.
Both keep the TPU
kernel's pivot rule exactly:

* pricing: Dantzig over non-basic cells of M - u - v, ties to the lowest
  flat index; optimal when dmin >= -tol;
* ratio test: theta = min Xv over the cycle's decreasing cells; the leaving
  arc is the lowest node id with ratio <= theta + 1e-12; a pivot with
  theta <= 1e-12 moves no flow and is counted as degenerate;
* the entering tree cell's cost is the exact M[ei, ej];
* potentials are refreshed from the tree every ``refresh`` pivots and at
  exit, pot[v] = (-1)^dep[v] sum_k N[v,k] (-1)^dep[k] w[k]; between
  refreshes they shift incrementally on the re-hung subtree.

The tree state is the root-path indicator matrix N (B, V, V) with per-node
parent, depth dep, tree-cell cost w and flow Xv.  The dense plan is built
from (parent, Xv) once at exit.  Unlike the TPU kernel, nothing is padded:
there are no pad leaves, so node ids are rows 0..S-1 and columns S..V-1.

On the card one thread-block cluster of C blocks runs one instance
(``cluster_plan`` picks C): each block prices a slice of M's rows and owns
a slice of N's rows, bit-packed in its shared memory where they fit; see
the source for the design.  It runs in float32, as the TPU kernel does.
The packed-row helpers below (``pack_bits``, ``packed_pivot_rows``) are the
kernel's word algebra in tensor form, for the tests.
"""
from __future__ import annotations

import math

import torch

from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch.config import SMEM_PER_BLOCK, SMS, split_rows
from smart_crossover_tpu_torch.ops.transport_simplex_anc import (
    _tree_cells,
    build_ancestor_matrix,
    rebuild_plan,
)
from smart_crossover_tpu_torch.ops.transport_simplex_parent import _price
from smart_crossover_tpu_torch.ops.tree import build_parent_from_mask
from smart_crossover_tpu_torch.utils import trace

_STATIC_SMEM = 1024      # the kernel's static shared memory, at most
_MAX_CLUSTER = 8         # the portable thread-block cluster size
# the price of a cell at a zero-mass node off the starting basis: it never
# enters (``batched_transport_simplex_mega``); finite, so that prices stay so
ZERO_MASS_COST = 1e30
# a pivot whose ratio theta is at most this moves no flow (degenerate): the
# slack of the leaving arc's ratio test, float32 in both versions
DEGENERATE_THETA = 1e-12

# plan of the last kernel launch, with the card's answer to how many of
# its clusters can be resident at once (read by chip_smoke.py)
LAST_LAUNCH: dict = {}
_MAX_ACTIVE: dict = {}


def _words(n: int) -> int:
    return (n + 31) // 32


def mega_smem_bytes(S: int, D: int, C: int, n_in_smem: bool,
                    mask_in_smem: bool) -> int:
    """Dynamic shared memory of one block (``mega_smem_bytes`` in the CUDA
    source): the cycle rows ax, ay and the rank's mask and N slices where
    they live in shared memory, as 32-bit words padded to 16 bytes; w, Xv
    (two buffers each) and pot as float32; parent (two buffers), dep, child
    and nes_at_depth as int16."""
    V = S + D
    words = 2 * _words(V)
    if mask_in_smem:
        words += -(-S // C) * _words(D)
    if n_in_smem:
        words += -(-V // C) * _words(V)
    b = (words + 3) // 4 * 16 + 4 * 5 * V + 2 * 5 * V
    return (b + 15) // 16 * 16


def max_kernel_nodes(smem_budget: int = SMEM_PER_BLOCK) -> int:
    """The largest V whose node vectors fit in one block's shared memory
    (N and the mask then live in global memory)."""
    budget = smem_budget - _STATIC_SMEM
    V = budget // 30
    while V > 0 and mega_smem_bytes(1, V - 1, 1, False, False) > budget:
        V -= 1
    return V


def cluster_plan(B: int, S: int, D: int, smem_budget: int = SMEM_PER_BLOCK,
                 sms: int = SMS) -> dict:
    """How the kernel lays out a (B, S, D) batch: C blocks per instance.

    C is the largest power of two <= 8 with B*C <= sms (1 if B > sms/2),
    raised to the smallest C whose N and mask slices fit in shared memory
    if that is larger.  Where no C <= 8 fits them, N (and then the mask)
    live in a global scratch buffer instead.  Tests lower ``smem_budget``
    below the card's limit to reach the global layouts.  Raises ValueError
    where even the node vectors do not fit (V > ``max_kernel_nodes()``).
    """
    V = S + D
    budget = smem_budget - _STATIC_SMEM

    def fits(C, n_smem, mask_smem):
        return mega_smem_bytes(S, D, C, n_smem, mask_smem) <= budget

    if not fits(1, False, False):
        raise ValueError(
            f"transport_simplex_mega: V = {V} nodes exceeds the kernel's "
            f"shared-memory limit (V <= {max_kernel_nodes(smem_budget)}: "
            f"30 bytes per node in {budget} bytes)")
    C = 1
    while C < _MAX_CLUSTER and B * C * 2 <= sms:
        C *= 2
    fit = [c for c in (1, 2, 4, 8) if fits(c, True, True)]
    if fit:
        C = max(C, fit[0])
    n_smem = fits(C, True, True)
    mask_smem = n_smem or fits(C, False, True)
    return {"cluster_size": C, "m_ranges": split_rows(S, C),
            "n_ranges": split_rows(V, C), "words_n": _words(V),
            "words_d": _words(D),
            "smem_bytes": mega_smem_bytes(S, D, C, n_smem, mask_smem),
            "n_in_smem": n_smem, "mask_in_smem": mask_smem}


def mega_setup(X, Bm, M):
    """Initial pivot state from basic feasible plans X (B, S, D) and their
    spanning-tree masks Bm: a dict of M (float32), N (bool), mask (bool),
    parent / dep (int32) and w / Xv (float32)."""
    B, S, D = M.shape
    f32 = torch.float32
    M = M.to(f32).contiguous()
    X = X.to(f32)
    Bm = Bm.to(torch.bool)
    parent = build_parent_from_mask(Bm)
    N = build_ancestor_matrix(parent)
    dep = N.sum(2) - 1
    ci, cj, notroot = _tree_cells(parent, S, D)
    flat = torch.where(notroot, ci * D + cj, 0)
    w = torch.where(notroot, M.reshape(B, -1).gather(1, flat), 0.0)
    Xv = torch.where(notroot, X.reshape(B, -1).gather(1, flat), 0.0)
    i32 = torch.int32
    return {"M": M, "N": N.contiguous(), "mask": Bm.contiguous(),
            "parent": parent.to(i32).contiguous(),
            "dep": dep.to(i32).contiguous(),
            "w": w.contiguous(), "Xv": Xv.contiguous()}


def _refresh_pot(N, dep, w):
    par = torch.where(dep % 2 == 0, 1.0, -1.0).to(w.dtype)
    acc = torch.where(N, (par * w)[:, None, :], 0.0).sum(2)
    return acc * par


def _pivot(st, go, dmin, ei, ej):
    """One pivot for the instances where ``go`` holds; ``st`` is updated in
    place (the other instances keep their state)."""
    M, N, mask = st["M"], st["N"], st["mask"]
    parent, dep, w, Xv, pot = (st["parent"], st["dep"], st["w"], st["Xv"],
                               st["pot"])
    B, S, D = M.shape
    V = S + D
    dev = M.device
    b = torch.arange(B, device=dev)
    vids = torch.arange(V, device=dev)
    is_row = vids < S
    inf = torch.tensor(math.inf, dtype=Xv.dtype, device=dev)

    x_end = ei
    y_end = S + ej
    ax = N[b, x_end]
    ay = N[b, y_end]
    onc = ax ^ ay
    sign = torch.where(onc, torch.where(ax == is_row, -1.0, 1.0),
                       0.0).to(Xv.dtype)
    ratios = torch.where(sign < -0.5, Xv, inf)
    theta = ratios.amin(1)
    st["theta"] = theta
    cl = torch.where(ratios <= (theta + 1e-12)[:, None], vids, V).amin(1)

    dep_cl = dep[b, cl]
    on_x = ax[b, cl]
    e_same = torch.where(on_x, x_end, y_end)
    e_other = torch.where(on_x, y_end, x_end)
    nes = torch.where(on_x[:, None], ax, ay)
    neo = torch.where(on_x[:, None], ay, ax)
    src = nes & (dep >= dep_cl[:, None]) & (vids != cl[:, None])
    Xvu = Xv + sign * theta[:, None]
    m_enter = M[b, ei, ej]
    row_shift = torch.where(on_x, dmin, -dmin)
    p_cl = parent[b, cl].long()
    li = torch.where(cl < S, cl, p_cl)
    lj = torch.where(cl < S, p_cl - S, cl - S)

    # N rows of the re-hung subtree C: (N ^ nes) | lca bit | neo
    C = N[b, :, cl] & go[:, None]
    common = N & nes[:, None, :]
    lca_dep = torch.where(common, dep[:, None, :], -1).amax(2)
    lca_bit = common & (dep[:, None, :] == lca_dep[:, :, None])
    N_new = (N ^ nes[:, None, :]) | lca_bit | neo[:, None, :]
    st["N"] = N = torch.where(C[:, :, None], N_new, N)
    dep_new = (N.sum(2) - 1).to(dep.dtype)

    # the reversed path e_same..cl re-keys child -> old parent
    tgt = torch.where(src, parent.long(), V)
    child = torch.full((B, V + 1), -1, dtype=torch.int64, device=dev)
    child = child.scatter(1, tgt, vids.expand(B, V))[:, :V]
    hit = child >= 0
    chc = child.clamp(min=0)
    es = vids == e_same[:, None]
    Xv_new = torch.where(es, theta[:, None],
                         torch.where(hit, Xvu.gather(1, chc), Xvu))
    w_new = torch.where(es, m_enter[:, None],
                        torch.where(hit, w.gather(1, chc), w))
    seg_hit = hit & nes & (dep >= dep_cl[:, None])
    par_new = torch.where(es, e_other[:, None].to(parent.dtype),
                          torch.where(seg_hit, child.to(parent.dtype),
                                      parent))
    shift = torch.where(is_row, row_shift[:, None], -row_shift[:, None])
    pot_new = pot + torch.where(C, shift, 0.0)

    g = go[:, None]
    st["parent"] = torch.where(g, par_new, parent)
    st["dep"] = torch.where(g, dep_new, dep)
    st["Xv"] = torch.where(g, Xv_new, Xv)
    st["w"] = torch.where(g, w_new, w)
    st["pot"] = pot_new
    bg = b[go]
    mask[bg, ei[go], ej[go]] = True
    mask[bg, li[go], lj[go]] = False


def transport_simplex_mega_plain(state, tol: float = 1e-7,
                                 max_pivots: int = 5000, refresh: int = 128):
    """Plain tensor version of the kernel, from a ``mega_setup`` state.

    Returns (parent, Xv, w, pot, mask, pivots, optimal, degenerate),
    batched; ``degenerate`` counts the pivots whose ratio theta was at
    most ``DEGENERATE_THETA`` (they move no flow).
    """
    M = state["M"]
    B = M.shape[0]
    dev = M.device
    st = {"M": M, "N": state["N"].clone(), "mask": state["mask"].clone(),
          "parent": state["parent"].clone(), "dep": state["dep"].clone(),
          "w": state["w"].clone(), "Xv": state["Xv"].clone(),
          "pot": torch.zeros_like(state["w"])}
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    degenerate = torch.zeros_like(it)
    start = torch.zeros_like(it)
    optimal = torch.zeros(B, dtype=torch.bool, device=dev)
    finished = torch.full((B,), max_pivots <= 0, dtype=torch.bool,
                          device=dev)
    need_refresh = ~finished
    while not bool(finished.all()):
        # an outer round of the kernel: refresh, then a chunk of pivots
        r = need_refresh
        st["pot"] = torch.where(r[:, None],
                                _refresh_pot(st["N"], st["dep"], st["w"]),
                                st["pot"])
        start = torch.where(r, it, start)
        dmin, ei, ej = _price(M, st["mask"], st["pot"])
        now_done = dmin >= -tol
        optimal |= r & now_done
        finished |= r & now_done
        go = ~finished & ~now_done
        _pivot(st, go, dmin, ei, ej)
        it = it + go
        degenerate = degenerate + (go & (st["theta"] <= DEGENERATE_THETA))
        chunk_end = ~finished & (now_done | (it >= start + refresh)
                                 | (it >= max_pivots))
        capped = chunk_end & (it >= max_pivots)
        finished |= capped
        need_refresh = chunk_end & ~capped
    pot = _refresh_pot(st["N"], st["dep"], st["w"])
    return (st["parent"], st["Xv"], st["w"], pot, st["mask"], it, optimal,
            degenerate)


# ------------------------------------------------ packed rows, for the tests

def pack_bits(x):
    """Bool (..., n) as 32-bit words (..., ceil(n/32)) held in int64: bit
    k % 32 of word k // 32 is x[..., k], as the kernel packs N and the
    mask."""
    n = x.shape[-1]
    pad = _words(n) * 32 - n
    x = torch.nn.functional.pad(x.to(torch.int64), (0, pad))
    x = x.reshape(*x.shape[:-1], -1, 32)
    bits = torch.arange(32, device=x.device)
    return (x << bits).sum(-1)


def unpack_bits(words, n: int):
    """Inverse of ``pack_bits``: bool (..., n)."""
    bits = torch.arange(32, device=words.device)
    x = (words[..., None] >> bits) & 1
    return x.reshape(*words.shape[:-1], -1)[..., :n].bool()


def _popcount(words):
    return unpack_bits(words, words.shape[-1] * 32).sum(-1)


def packed_pivot_rows(Nw, dep, Xv, S: int, ei: int, ej: int):
    """The tree update of one pivot on the entering cell (ei, ej), in the
    kernel's word algebra, for one instance: Nw (V, W) packed root-path
    rows, dep (V,) and Xv (V,) before the pivot.  Returns (Nw', dep').

    The cycle's decreasing cells are (ax ^ ay) & ~(ax ^ rows) word by word;
    the leaving node cl is the lowest id with Xv <= theta + 1e-12.  Each
    row t in the re-hung subtree (bit cl of row t set) becomes
    (N[t] ^ nes) | lca_bit | neo, where N[t] & nes is the root path t
    shares with e_same, so the LCA is the nes node at depth
    popcount(N[t] & nes) - 1, read from a table built once per pivot; the
    new depth is popcount(N'[t]) - 1.
    """
    V = dep.shape[0]
    full = (1 << 32) - 1
    ax, ay = Nw[ei], Nw[S + ej]
    rows = pack_bits(torch.arange(V, device=Nw.device) < S)
    dec = unpack_bits((ax ^ ay) & ~(ax ^ rows) & full, V)
    theta = Xv[dec].min()
    cl = int(torch.nonzero(dec & (Xv <= theta + 1e-12))[0, 0])
    on_x = bool((ax[cl >> 5] >> (cl & 31)) & 1)
    nes, neo = (ax, ay) if on_x else (ay, ax)
    nes_b = unpack_bits(nes, V)
    nes_at_depth = torch.full((V,), -1, dtype=torch.int64, device=Nw.device)
    nes_at_depth[dep[nes_b].long()] = torch.nonzero(nes_b)[:, 0]
    inC = ((Nw[:, cl >> 5] >> (cl & 31)) & 1).bool()
    lca = nes_at_depth[_popcount(Nw & nes) - 1]
    lca_bit = torch.zeros_like(Nw)
    lca_bit[torch.arange(V), lca >> 5] = 1 << (lca & 31)
    new = (Nw ^ nes) | lca_bit | neo
    Nw_new = torch.where(inC[:, None], new, Nw)
    dep_new = torch.where(inC, _popcount(new) - 1, dep.long()).to(dep.dtype)
    return Nw_new, dep_new


def _check(name, t, dtype, shape):
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != shape:
        raise ValueError(f"transport_simplex_mega: {name} must be a "
                         f"contiguous {dtype} CUDA tensor of shape {shape}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _max_active_clusters(lib, B, plan, S, D):
    """The card's count of this launch's clusters that fit at once,
    queried once per (C, layout) and cached."""
    key = (plan["cluster_size"], plan["smem_bytes"], S, D)
    if key not in _MAX_ACTIVE:
        n = lib.scx_transport_simplex_mega_max_clusters(
            B, S, D, plan["cluster_size"], int(plan["n_in_smem"]),
            int(plan["mask_in_smem"]))
        if n < 0:
            _build.check(-n, "scx_transport_simplex_mega_max_clusters")
        _MAX_ACTIVE[key] = n
    return _MAX_ACTIVE[key]


def _transport_simplex_mega_cuda(state, tol, max_pivots, refresh,
                                 smem_budget):
    M = state["M"]
    B, S, D = M.shape
    V = S + D
    _check("M", M, torch.float32, (B, S, D))
    _check("N", state["N"], torch.bool, (B, V, V))
    _check("mask", state["mask"], torch.bool, (B, S, D))
    for k in ("parent", "dep"):
        _check(k, state[k], torch.int32, (B, V))
    for k in ("w", "Xv"):
        _check(k, state[k], torch.float32, (B, V))
    sms = torch.cuda.get_device_properties(M.device).multi_processor_count
    plan = cluster_plan(B, S, D, smem_budget, sms)
    C, n_smem, m_smem = (plan["cluster_size"], plan["n_in_smem"],
                         plan["mask_in_smem"])
    lib = _build.library()
    smem = lib.scx_transport_simplex_mega_smem_bytes(S, D, C, int(n_smem),
                                                     int(m_smem))
    if smem != plan["smem_bytes"]:
        raise RuntimeError(f"transport_simplex_mega: the kernel lays out "
                           f"{smem} bytes of shared memory, the plan "
                           f"{plan['smem_bytes']}")
    i32 = dict(dtype=torch.int32, device=M.device)
    # global scratch for the packed N and mask where they do not fit
    N_glob = torch.empty(1 if n_smem else B * V * plan["words_n"], **i32)
    mask_glob = torch.empty(1 if m_smem else B * S * plan["words_d"], **i32)
    mask = torch.empty_like(state["mask"])
    parent = torch.empty_like(state["parent"])
    Xv = torch.empty_like(state["Xv"])
    w = torch.empty_like(state["w"])
    pot = torch.empty_like(state["w"])
    stats = torch.empty(B, 3, **i32)
    stream = torch.cuda.current_stream(M.device).cuda_stream
    with torch.cuda.device(M.device):
        active = _max_active_clusters(lib, B, plan, S, D)
        err = lib.scx_transport_simplex_mega(
            M.data_ptr(), state["N"].data_ptr(), state["mask"].data_ptr(),
            state["parent"].data_ptr(), state["dep"].data_ptr(),
            state["w"].data_ptr(), state["Xv"].data_ptr(),
            N_glob.data_ptr(), mask_glob.data_ptr(), mask.data_ptr(),
            parent.data_ptr(), Xv.data_ptr(), w.data_ptr(), pot.data_ptr(),
            stats.data_ptr(), B, S, D, C, int(n_smem), int(m_smem),
            float(tol), int(max_pivots), int(refresh), stream)
    _build.check(err, "scx_transport_simplex_mega")
    _build.LAUNCHES["transport_simplex_mega"] += 1
    LAST_LAUNCH.clear()
    LAST_LAUNCH.update(plan, shape=[B, S, D], max_active_clusters=active)
    return (parent, Xv, w, pot, mask, stats[:, 0].long(), stats[:, 1] != 0,
            stats[:, 2].long())


def transport_simplex_mega_state(state, tol: float = 1e-7,
                                 max_pivots: int = 5000, refresh: int = 128,
                                 *, smem_budget: int = SMEM_PER_BLOCK):
    """Pivot a ``mega_setup`` state to optimality: the kernel for CUDA
    tensors, the plain version for CPU tensors.  Returns (parent, Xv, w,
    pot, mask, pivots, optimal, degenerate), ``degenerate`` the pivots of
    each instance that moved no flow.  ``smem_budget`` reaches
    ``cluster_plan`` (tests lower it)."""
    if state["M"].is_cuda:
        return _transport_simplex_mega_cuda(state, tol, max_pivots, refresh,
                                            smem_budget)
    if state["M"].device.type != "cpu":
        raise ValueError(
            f"transport_simplex_mega: no kernel for {state['M'].device}")
    return transport_simplex_mega_plain(state, tol, max_pivots, refresh)


def complete_zero_masses(M, mask, pot, live_s, live_d):
    """The basis of a transport with zero masses, from the optimal basis
    of the transport between its nonzero-mass nodes.

    Every arc at a zero-mass node carries 0, so the plan is already
    optimal; what the zero-mass nodes still need is potentials under
    which no cell's reduced cost M - u - v is negative, and a tree arc
    each that is tight under them.  Given the potentials ``pot`` (B, V)
    of the nonzero nodes (u on rows, v on columns), each zero-mass column
    takes v = min over nonzero rows of M - u, and then each zero-mass row
    u = min over all columns of M - v, each hung from its minimising node
    (ties to the lowest index): every inequality holds by construction.
    ``mask`` must join the nonzero nodes among themselves (S+ + D+ - 1
    arcs); its arcs at zero-mass nodes are replaced.  Returns the new
    mask (B, S, D)."""
    S, D = M.shape[1:]
    u, v = pot[:, :S], pot[:, S:]
    inf = torch.tensor(math.inf, dtype=pot.dtype, device=pot.device)
    v_col, i_col = torch.where(live_s[:, :, None], M - u[:, :, None],
                               inf).min(1)
    v = torch.where(live_d, v, v_col)
    j_row = (M - v[:, None, :]).argmin(2)
    rows = torch.arange(S, device=M.device)
    cols = torch.arange(D, device=M.device)
    hang = ((rows[None, :, None] == i_col[:, None, :])
            & ~live_d[:, None, :])
    hang |= (cols[None, None, :] == j_row[:, :, None]) & ~live_s[:, :, None]
    return (mask & live_s[:, :, None] & live_d[:, None, :]) | hang


def batched_transport_simplex_mega(X, Bm, M, s=None, d=None,
                                   tol: float = 1e-7,
                                   max_pivots: int = 5000,
                                   refresh: int = 128,
                                   interpret: bool | None = None):
    """Pivot a batch of basic feasible plans to optimality.

    Same contract as the other device engines (and the JAX package's
    ``batched_transport_simplex_mega``): X (B, S, D) basic feasible plans,
    Bm (B, S, D) spanning-tree masks, M (B, S, D) costs.  ``interpret``
    (the JAX package's Pallas interpret mode) is a no-op: the route
    follows M's device.  Returns (X_opt, Bm_opt, pivots, optimal) with
    batch dims; X_opt is float32, as the pivot loop runs in float32.
    While the tracer records, the batch's pivots and degenerate pivots
    count as ``k2.pivots`` and ``k2.degenerate`` in ``scx.simplex_kernel``.

    s and d (B, S), (B, D), unused in the JAX package, name the zero-mass
    nodes where given.  Their arcs all carry 0, and a pivot that enters
    one moves no flow: pivoting them into place took tens of thousands of
    degenerate pivots on 784 x 784 pairs of mostly blank images.  So the
    loop pivots the transport between the nonzero-mass nodes alone (every
    other cell off Bm is priced at ``ZERO_MASS_COST``, so it never
    enters), and ``complete_zero_masses`` then hangs the zero-mass nodes
    in one step.  That needs Bm to join the nonzero nodes among
    themselves, with the zero-mass ones in subtrees off them (the route's
    Borůvka builds it so); an instance whose final basis does not is not
    called optimal.  With every mass positive nothing changes.
    """
    B, S, D = M.shape
    zeros = s is not None and d is not None
    with trace.span("scx.simplex_setup", M.device):
        Mk = M
        if zeros:
            live_s = torch.as_tensor(s, device=M.device) > 0
            live_d = torch.as_tensor(d, device=M.device) > 0
            live = live_s[:, :, None] & live_d[:, None, :]
            Mk = torch.where(live | Bm.to(torch.bool), M, ZERO_MASS_COST)
        state = mega_setup(X, Bm, Mk)
    with trace.span("scx.simplex_kernel", M.device):
        parent, Xv, _, pot, mask, pivots, optimal, degenerate = \
            transport_simplex_mega_state(state, tol, max_pivots, refresh)
        if trace.TRACER.recording_now():
            trace.count("k2.pivots", int(pivots.sum()))
            trace.count("k2.degenerate", int(degenerate.sum()))
    with trace.span("scx.rebuild", M.device):
        X_out = rebuild_plan(parent, Xv, S, D).clamp(min=0.0)
        if zeros:
            n_live = live_s.sum(1) + live_d.sum(1) - 1
            optimal = optimal & ((mask & live).sum((1, 2)) == n_live)
            mask = complete_zero_masses(M.to(pot.dtype), mask, pot, live_s,
                                        live_d)
    return X_out, mask, pivots, optimal


def transport_simplex_mega(X, Bm, M, s=None, d=None, tol: float = 1e-7,
                           max_pivots: int = 5000, refresh: int = 128):
    """Single-instance wrapper matching the other engines' signature."""
    Xb, Bmb, piv, opt = batched_transport_simplex_mega(
        X[None], Bm[None], M[None], None, None, tol, max_pivots, refresh)
    return Xb[0], Bmb[0], piv[0], opt[0]
