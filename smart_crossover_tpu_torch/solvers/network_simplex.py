"""Warm-startable primal network simplex for min-cost flow.

Host copy of ``smart_crossover_tpu/solvers/network_simplex.py``: the numpy
core ``_network_simplex_py``, ``NetSimplexResult`` and
``network_simplex_output`` unchanged; ``network_simplex`` dispatches to
the native core, which is built at first use and raises where it
cannot be (the JAX package falls back to numpy without a word).

In-house replacement for the vendor network-simplex / default-simplex solves
the reference delegates to (reference net_manager.py:211-222 and :457-468 via
solver_caller).  The solver:

* accepts an arbitrary vbasis/cbasis warm start in the reference's
  0/-1/-2 encoding, repairs it into a spanning tree (filling connectivity
  with internal artificial root arcs), and pivots from there;
* maintains the basis as a rooted spanning tree (parent / parent-arc /
  subtree-size arrays), prices with vectorised numpy reduced costs (Dantzig with a
  Bland's-rule fallback after long degenerate runs);
* returns primal flows, node potentials, reduced costs, the final basis and
  the pivot count.

This is the exact, float64 host path of the framework (TPU does the
approximate, massively parallel work; see config.py).  A C++ core with
O(subtree) potential updates mirrors this algorithm for speed
(native/netsimplex.cpp); this numpy version doubles as its test oracle.
"""
from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass

import numpy as np

# per-pivot conservation invariant check (debug): SCX_NS_DEBUG=1
_NS_DEBUG = bool(os.environ.get("SCX_NS_DEBUG"))

from smart_crossover_tpu_torch.models import Basis, MinCostFlow, Output
from smart_crossover_tpu_torch.models.output import (
    VBASIS_AT_LOWER,
    VBASIS_AT_UPPER,
    VBASIS_BASIC,
)

_BASIC = 0
_AT_LOWER = -1
_AT_UPPER = -2


@dataclass
class NetSimplexResult:
    x: np.ndarray
    y: np.ndarray
    obj_val: float
    basis: Basis
    rcost: np.ndarray
    iter_count: int
    status: str
    runtime: datetime.timedelta


def network_simplex(mcf: MinCostFlow,
                    warm_basis: Basis | None = None,
                    max_iter: int = 10_000_000,
                    tol: float = 1e-9,
                    use_native: bool = True,
                    time_limit: float | None = None) -> NetSimplexResult:
    """Solve a MinCostFlow to an optimal basic solution.

    Args:
        mcf: the instance (tails/heads/c/u/b).
        warm_basis: optional starting basis (vbasis over arcs, cbasis over
            nodes; the node with cbasis == 0 is used as the tree root).
        max_iter: pivot limit.
        tol: feasibility/optimality tolerance.
        use_native: run the C++ core (built at first use; a failed build
            or load raises); False runs the numpy version.

    Returns:
        NetSimplexResult. ``status`` is 'OPTIMAL', 'INFEASIBLE' (artificial
        flow remains), 'UNBOUNDED' or 'ITERATION_LIMIT'.
    """
    if use_native:
        from smart_crossover_tpu_torch.native.netsimplex import solve

        # the native core enforces the pivot limit, not a time limit
        return solve(mcf, warm_basis, max_iter, tol)
    return _network_simplex_py(mcf, warm_basis, max_iter, tol, time_limit)


def _network_simplex_py(mcf: MinCostFlow,
                        warm_basis: Basis | None,
                        max_iter: int,
                        tol: float,
                        time_limit: float | None = None) -> NetSimplexResult:
    t0 = time.perf_counter()
    m, n = mcf.m, mcf.n

    root = m - 1
    if warm_basis is not None and warm_basis.cbasis.size == m:
        basic_rows = np.where(warm_basis.cbasis == 0)[0]
        if basic_rows.size >= 1:
            root = int(basic_rows[0])

    # Arc arrays: n original arcs + 2m artificial root arcs
    # (node->root at n+2i, root->node at n+2i+1), cost BIG, cap inf.
    cmax = float(np.max(np.abs(mcf.c))) if n else 1.0
    BIG = (cmax + 1.0) * m
    # artificial arc n+2i: node i -> root; arc n+2i+1: root -> node i
    nodes = np.arange(m, dtype=np.int64)
    art_tails = np.empty(2 * m, dtype=np.int64)
    art_heads = np.empty(2 * m, dtype=np.int64)
    art_tails[0::2] = nodes
    art_heads[0::2] = root
    art_tails[1::2] = root
    art_heads[1::2] = nodes
    tails = np.concatenate([mcf.tails, art_tails])
    heads = np.concatenate([mcf.heads, art_heads])
    cost = np.concatenate([mcf.c, np.full(2 * m, BIG)])
    cap = np.concatenate([mcf.u, np.full(2 * m, np.inf)])
    ntot = n + 2 * m

    status = np.full(ntot, _AT_LOWER, dtype=np.int8)
    x = np.zeros(ntot)

    if warm_basis is not None:
        vb = warm_basis.vbasis
        status[:n][vb == VBASIS_BASIC] = _BASIC
        at_up = (vb == VBASIS_AT_UPPER) & np.isfinite(mcf.u)
        status[:n][at_up] = _AT_UPPER
        x[:n][at_up] = mcf.u[at_up]

    parent = [-1] * m
    parent_arc = [-1] * m
    # plain lists: scalar reads/writes in the pivot loop are ~3x faster
    # than numpy element access
    sz = [1] * m                 # subtree sizes (min-side updates)
    stamp = [-1] * m             # cycle-walk visit marks
    pside = [0] * m
    ppos = [0] * m
    y = np.zeros(m)
    children: list = []

    # ---- helpers -----------------------------------------------------------
    def rebuild_tree_from_status() -> bool:
        """(Re)build a spanning tree from the current basic set, completing
        connectivity with artificial arcs, then compute tree flows.
        Returns False if some basic arc flows violate bounds (caller repairs)."""
        # union-find over basic original+artificial arcs
        uf = np.arange(m)

        def find(a):
            while uf[a] != a:
                uf[a] = uf[uf[a]]
                a = uf[a]
            return a

        adj_head = [[] for _ in range(m)]  # (neighbor, arc)
        basic_arcs = np.where(status == _BASIC)[0]
        for a in basic_arcs:
            t, h = tails[a], heads[a]
            rt, rh = find(t), find(h)
            if rt == rh:
                # redundant basic arc (cycle) -> demote to its nearest bound
                status[a] = _AT_LOWER
                x[a] = 0.0
                continue
            uf[rt] = rh
            adj_head[t].append((h, a))
            adj_head[h].append((t, a))

        # connect remaining components to root with artificial arcs
        rroot = find(root)
        for v in range(m):
            if find(v) != rroot:
                # choose orientation later by flow sign; start with v->root
                a = n + 2 * v
                status[a] = _BASIC
                uf[find(v)] = rroot
                adj_head[v].append((root, a))
                adj_head[root].append((v, a))

        # BFS from root to set parents
        order = np.empty(m, dtype=np.int64)
        parent[root] = -1
        parent_arc[root] = -1
        seen = np.zeros(m, dtype=bool)
        seen[root] = True
        order[0] = root
        qi, qn = 0, 1
        while qi < qn:
            v = order[qi]
            qi += 1
            for w, a in adj_head[v]:
                if not seen[w]:
                    seen[w] = True
                    parent[w] = v
                    parent_arc[w] = a
                    order[qn] = w
                    qn += 1
        assert qn == m, "tree construction failed to span all nodes"
        children.clear()
        children.extend(set() for _ in range(m))
        for v in range(m):
            if v != root:
                children[parent[v]].add(v)

        # residuals r = b - N x_nonbasic: a nonbasic flow f contributes +f at
        # its head and -f at its tail, so subtracting it adds +f at the tail
        # and -f at the head.
        r = mcf.b.astype(np.float64).copy()
        nb_up = np.where(status[:n] == _AT_UPPER)[0]
        if nb_up.size:
            flows = x[nb_up]
            np.add.at(r, tails[nb_up], flows)
            np.add.at(r, heads[nb_up], -flows)

        # reverse-BFS accumulation of subtree residuals
        R = r.copy()
        for idx in range(m - 1, 0, -1):
            v = order[idx]
            p = parent[v]
            a = parent_arc[v]
            # arc crossing subtree S_v: points INTO S_v iff heads[a] == v
            if heads[a] == v:
                x[a] = R[v]
            else:
                x[a] = -R[v]
            R[p] += R[v]

        # flip artificial arcs that came out negative
        ok = True
        for v in range(m):
            if v == root:
                continue
            a = parent_arc[v]
            if a >= n and x[a] < 0:
                # switch to the opposite-orientation artificial arc
                base = (a - n) // 2
                other = n + 2 * base + (1 - (a - n) % 2)
                status[a] = _AT_LOWER
                xa = -x[a]
                x[a] = 0.0
                status[other] = _BASIC
                x[other] = xa
                parent_arc[v] = other
            a = parent_arc[v]
            if x[a] < -tol or x[a] > cap[a] + tol:
                ok = False
        return ok

    def repair_infeasible_tree():
        """Demote bound-violating basic arcs and rebuild (terminates: each
        round demotes >= 1 arc; artificial arcs never violate)."""
        for _ in range(m + n):
            bad = False
            for v in range(m):
                if v == root:
                    continue
                a = parent_arc[v]
                if a < n and (x[a] < -tol or x[a] > cap[a] + tol):
                    status[a] = _AT_UPPER if x[a] > cap[a] + tol else _AT_LOWER
                    x[a] = cap[a] if status[a] == _AT_UPPER else 0.0
                    bad = True
            if not bad:
                return
            if rebuild_tree_from_status():
                return
        raise RuntimeError("network simplex warm-start repair did not converge")

    if not rebuild_tree_from_status():
        repair_infeasible_tree()

    def recompute_potentials():
        # preorder from root via children sets; reverse pass accumulates
        # subtree sizes for the min-side potential updates
        y[root] = 0.0
        order = [root]
        qi = 0
        while qi < len(order):
            v = order[qi]
            qi += 1
            for c in children[v]:
                a = parent_arc[c]
                y[c] = y[v] + cost[a] if heads[a] == c else y[v] - cost[a]
                order.append(c)
        sz[:] = [1] * m
        for idx in range(len(order) - 1, 0, -1):
            v = order[idx]
            sz[parent[v]] += sz[v]

    recompute_potentials()

    # ---- pivot loop --------------------------------------------------------
    it = 0
    degen_run = 0
    result_status = "OPTIMAL"
    while True:
        if it >= max_iter:
            result_status = "ITERATION_LIMIT"
            break
        if (time_limit is not None and it % 256 == 0
                and time.perf_counter() - t0 > time_limit):
            result_status = "TIME_LIMIT"
            break
        rc = cost - y[heads] + y[tails]
        lo_viol = (status == _AT_LOWER) & (rc < -tol)
        up_viol = (status == _AT_UPPER) & (rc > tol)
        viol = np.where(lo_viol, -rc, 0.0) + np.where(up_viol, rc, 0.0)
        if degen_run > 2 * m + 50:
            cand = np.nonzero(viol > 0)[0]
            if cand.size == 0:
                break
            e = int(cand[0])  # Bland's rule
        else:
            e = int(np.argmax(viol))
            if viol[e] <= 0:
                break
        it += 1
        direction = 1 if lo_viol[e] else -1

        # collect cycle via alternating stamped parent walks: mark nodes
        # with this pivot's id; the first node reached twice is the apex and
        # the first visitor's overshoot past it is trimmed (no depths kept)
        path_t, path_h = [], []
        apex = -1
        cur = [int(tails[e]), int(heads[e])]
        paths = [path_t, path_h]
        s_side = 0
        while apex < 0:
            v = cur[s_side]
            if v < 0:
                s_side ^= 1
                continue
            if stamp[v] == it:
                apex = v
                del paths[pside[v]][ppos[v]:]
                break
            stamp[v] = it
            pside[v] = s_side
            ppos[v] = len(paths[s_side])
            paths[s_side].append(v)
            cur[s_side] = parent[v]
            s_side ^= 1

        # flow deltas per unit of theta (direction=+1 pushes t->e->h)
        cyc_arcs = []
        cyc_delta = []
        for v in path_h:  # traversal h -> ... -> lca (upward on head side)
            a = parent_arc[v]
            # cycle traverses v -> parent; arc forward iff tails[a] == v
            d = 1 if tails[a] == v else -1
            cyc_arcs.append(a)
            cyc_delta.append(d * direction)
        for v in path_t:  # traversal lca -> ... -> t (downward on tail side)
            a = parent_arc[v]
            # cycle traverses parent -> v; arc forward iff heads[a] == v
            d = 1 if heads[a] == v else -1
            cyc_arcs.append(a)
            cyc_delta.append(d * direction)

        # ratio test
        theta = cap[e] if np.isfinite(cap[e]) else np.inf
        leaving = e
        leave_k = -1
        leaving_to = _AT_UPPER if direction == 1 else _AT_LOWER
        bland = degen_run > 2 * m + 50
        for k, (a, d) in enumerate(zip(cyc_arcs, cyc_delta)):
            room = (cap[a] - x[a]) if d == 1 else x[a]
            take = room < theta - 1e-15
            if bland and not take and room < theta + 1e-15 and a < leaving:
                take = True  # tie -> smallest arc index, for termination
            if take:
                theta = min(theta, room)
                leaving = a
                leave_k = k
                leaving_to = _AT_UPPER if d == 1 else _AT_LOWER
        if not np.isfinite(theta):
            result_status = "UNBOUNDED"
            break
        theta = max(theta, 0.0)
        degen_run = degen_run + 1 if theta <= tol else 0

        # apply flow change
        x[e] += direction * theta
        for a, d in zip(cyc_arcs, cyc_delta):
            x[a] += d * theta

        if _NS_DEBUG:
            # canonical incidence: +1 at heads, -1 at tails (b = net inflow)
            resid = np.zeros(m)
            np.add.at(resid, heads.astype(int), x)
            np.add.at(resid, tails.astype(int), -x)
            err = np.abs(resid - mcf.b).max()
            if err > 1e-6:
                print(f"[ns-debug] pivot {it}: conservation broken "
                      f"err={err:.6g} e={e} ({int(tails[e])}->"
                      f"{int(heads[e])}) theta={theta} leaving={leaving} "
                      f"cyc={list(zip(cyc_arcs, cyc_delta))} "
                      f"apex={apex} path_t={path_t} path_h={path_h}")
                raise AssertionError("conservation broken")

        if leaving == e:
            status[e] = leaving_to  # bound-to-bound flip
            continue

        # basis exchange: e enters, `leaving` leaves
        status[e] = _BASIC
        status[leaving] = leaving_to
        x[leaving] = cap[leaving] if leaving_to == _AT_UPPER else 0.0

        # re-root the subtree cut off by removing `leaving`:
        # find the child endpoint of `leaving`
        lt, lh = int(tails[leaving]), int(heads[leaving])
        child = lt if parent[lt] != -1 and parent_arc[lt] == leaving else lh
        # the cut subtree (old subtree of `child`) contains the entering
        # arc's endpoint on the same cycle side as the leaving arc
        # (cyc_arcs order: head-side entries first, then tail-side)
        et, eh = int(tails[e]), int(heads[e])
        join = eh if leave_k < len(path_h) else et
        rc_e = float(rc[e])
        old_par_child = int(parent[child])
        moved = int(sz[child])     # size of the cut component
        # reverse parent pointers along path child..join, then hook join,
        # keeping the children sets consistent (O(path) updates)
        path = []
        v = join
        while v != child:
            path.append(v)
            v = parent[v]
        path.append(child)
        for v in path:
            p = parent[v]
            if p != -1:
                children[p].discard(v)
        prev = et + eh - join  # the endpoint of e outside the cut
        prev_arc = e
        for v in path:
            nxt, nxt_arc = parent[v], parent_arc[v]
            parent[v] = prev
            parent_arc[v] = prev_arc
            children[prev].add(v)
            prev, prev_arc = v, nxt_arc
        # subtree sizes: recompute along the reversed path (deepest node
        # `child` first), then apply the moved-component size along the
        # complement's two cycle legs, which meet exactly at the apex
        for v in reversed(path):
            s_v = 1
            for ch in children[v]:
                s_v += sz[ch]
            sz[v] = s_v
        w = old_par_child
        while w != apex:
            sz[w] -= moved
            w = parent[w]
        w = et + eh - join
        while w != apex:
            sz[w] += moved
            w = parent[w]
        # min-side potential shift: a uniform shift of all y leaves every
        # reduced cost unchanged, so shift the smaller of the cut component
        # (join's new subtree, +delta) and its complement (-delta)
        delta = rc_e if join == eh else -rc_e
        if 2 * moved <= m:
            stack = [join]
            while stack:
                w = stack.pop()
                y[w] += delta
                stack.extend(children[w])
        else:
            stack = [root]
            while stack:
                w = stack.pop()
                y[w] -= delta
                for ch in children[w]:
                    if ch != join:
                        stack.append(ch)

    art_flow = float(np.abs(x[n:]).sum())
    if result_status == "OPTIMAL" and art_flow > max(tol * m, 1e-6):
        result_status = "INFEASIBLE"

    vbasis = np.full(n, VBASIS_AT_LOWER, dtype=np.int32)
    vbasis[status[:n] == _BASIC] = VBASIS_BASIC
    vbasis[status[:n] == _AT_UPPER] = VBASIS_AT_UPPER
    cbasis = np.full(m, -1, dtype=np.int32)
    cbasis[root] = 0
    rc = mcf.c - y[mcf.heads] + y[mcf.tails]
    runtime = datetime.timedelta(seconds=time.perf_counter() - t0)
    return NetSimplexResult(
        x=x[:n].copy(), y=y.copy(),
        obj_val=float(mcf.c @ x[:n]),
        basis=Basis(vbasis, cbasis), rcost=rc,
        iter_count=it, status=result_status, runtime=runtime)


def network_simplex_output(mcf: MinCostFlow, **kw) -> Output:
    """Wrap :func:`network_simplex` in the framework Output type."""
    res = network_simplex(mcf, **kw)
    if res.status not in ("OPTIMAL",):
        return Output(runtime=res.runtime, status=res.status,
                      iter_count=res.iter_count)
    return Output(x=res.x, y=res.y, obj_val=res.obj_val, runtime=res.runtime,
                  iter_count=res.iter_count, rcost=res.rcost, basis=res.basis,
                  status=res.status)
