"""Plain reference for the exact vertices of network LPs: judges a vertex
by linear-programming duality, in float64 NumPy and SciPy.

Every cell's answer is a vertex of ``min c'x s.t. A x = b, 0 <= x <= u``
on a directed graph (A[heads[j], j] = +1, A[tails[j], j] = -1) together
with the basis that defines it.  The reference works out, by its own
arithmetic and from the instance it generated itself:

* ``vertex_err``: the vertex's primal residuals ``|A x - b|``, its bound
  violations, how far each nonbasic arc lies from a bound, and any flow
  on arcs that have to carry nothing, over the largest |b|;
* ``obj_err``: the returned objective against c'x of the returned
  vertex, over |c'x|;
* ``rcost_err``: node potentials from the basis's forest of basic arcs
  (each component's constant set by Bellman-Ford on the nonbasic arcs
  that join components, so that they break their sign by the least),
  and with them the worst reduced cost of the wrong sign: below 0 on an
  arc at 0, above 0 on an arc at u, off 0 on a basic arc, over the
  scale the configuration states its tolerance in.
  With ``vertex_err`` small, a ``rcost_err`` within the tolerance is the
  optimality certificate that the configuration states (by LP duality).

For a transport basis that a device returns with its own float32 flows
and objective (``judge_ot_basis``) it works out, from the basis alone,
the basis's float64 vertex x64 and potentials, and from them:

* ``device_err``: how far the device's flows lie from x64, and how far
  x64 falls below 0 (a basis whose vertex is infeasible), over max |b|;
* ``device_gap``: the device's objective against c'x64, and c'x64 above
  the Lagrangian lower bound c'x64 + sum over nonbasic arcs of
  min(0, reduced cost) u (u = min(s_i, d_j)), which every feasible plan
  meets: so c'x64 lies within the gap of the optimum; over |c'x64|.

and, where the program certified the basis, ``sign_err``: the largest
bound violation of x64 and of the vertex returned (a flow below 0, or
above min(s_i, d_j), which only a negative flow elsewhere allows), in
absolute units, the unit of the certificate's stated feasibility
tolerance.  It stands apart from ``vertex_err``, which then holds the
vertex's arithmetic (residuals, nonbasic arcs off their bound) alone: a
basis the device chose in float32 can have an exact vertex a few float32
roundings of a mass below 0, which the stated tolerance accepts and
float64 arithmetic does not cause.

It also computes a basis's own vertex (tree flows) in a lower precision,
in plain torch, for the control, which puts the reference in the
program's place one precision below the configuration's.  It imports
nothing of the program under test.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csg
import torch


@dataclass
class Network:
    tails: np.ndarray
    heads: np.ndarray
    c: np.ndarray
    u: np.ndarray
    b: np.ndarray
    # a transport problem's (S, D): its bounds u are implied, not the
    # program's, so a nonbasic arc has to sit at 0
    ot_shape: tuple | None = None
    # the unit of the configuration's reduced-cost tolerance: 1 for an
    # absolute tolerance, max |c| for one on costs scaled by it
    rc_scale: float = 1.0

    @property
    def m(self) -> int:
        return self.b.size

    @property
    def n(self) -> int:
        return self.c.size


_OT_ARCS: dict = {}


def ot_network(s, d, M) -> Network:
    """Transport from supplies s to demands d at cost M as a network:
    arc i * D + j runs i -> S + j; b = [-s, d].  Each arc's bound is
    min(s_i, d_j), which every feasible plan meets, so the Lagrangian
    bound of the bounded problem bounds the transport problem too."""
    S, D = M.shape
    if (S, D) not in _OT_ARCS:
        _OT_ARCS[(S, D)] = (np.repeat(np.arange(S), D),
                            S + np.tile(np.arange(D), S))
    tails, heads = _OT_ARCS[(S, D)]
    return Network(tails, heads, np.asarray(M, np.float64).ravel(),
                   np.minimum.outer(s, d).ravel(),
                   np.concatenate([-np.asarray(s, np.float64),
                                   np.asarray(d, np.float64)]), (S, D))


@dataclass
class Forest:
    """The basic arcs as a forest hung from a virtual root ``m``."""
    comp: np.ndarray        # (m,) component of each node
    n_comp: int
    order: list            # nodes in breadth-first order, roots first
    pred: np.ndarray        # (m,) parent node (m for a component's root)
    parc: np.ndarray        # (m,) arc to the parent, -1 at a root
    down: np.ndarray        # (m,) the parent arc runs parent -> node
    depth: np.ndarray       # (m,) 1 at a root

    def levels(self) -> list:
        """Node ids by depth, from depth 1 (the roots) down."""
        by = np.argsort(self.depth, kind="stable")
        cuts = np.cumsum(np.bincount(self.depth))[:-1]
        return [lv for lv in np.split(by, cuts) if lv.size]


def basis_forest(net: Network, basic: np.ndarray) -> Forest | None:
    """The forest of the basic arcs ``basic`` (arc ids), or None where
    they hold a cycle (no basis)."""
    m = net.m
    basic = np.asarray(basic, np.int64)
    t, h = net.tails[basic], net.heads[basic]
    if np.any(t == h):
        return None
    g = sp.coo_matrix((np.ones(basic.size), (t, h)), shape=(m, m)).tocsr()
    n_comp, comp = csg.connected_components(g, directed=False)
    if basic.size != m - n_comp:
        return None
    roots = np.unique(comp, return_index=True)[1]
    rows = np.concatenate([t, np.full(n_comp, m)])
    cols = np.concatenate([h, roots])
    g = sp.coo_matrix((np.ones(rows.size), (rows, cols)),
                      shape=(m + 1, m + 1)).tocsr()
    order, pred = csg.breadth_first_order(g, m, directed=False,
                                          return_predecessors=True)
    if order.size != m + 1:
        return None
    pred = pred[:m]
    down = pred[h] == t
    if not np.all(down | (pred[t] == h)):
        return None
    order = order[1:].tolist()
    pl = pred.tolist()
    dl = [0] * (m + 1)
    for v in order:
        dl[v] = dl[pl[v]] + 1
    child = np.where(down, h, t)
    parc = np.full(m, -1, np.int64)
    parc[child] = basic
    dn = np.zeros(m, bool)
    dn[child] = down
    return Forest(comp, n_comp, order, pred, parc, dn,
                  np.asarray(dl[:m], np.int64))


def tree_flows(net: Network, forest: Forest, at_upper: np.ndarray,
               dtype) -> np.ndarray:
    """The basis's vertex in ``dtype``: nonbasic arcs at 0, or at u where
    ``at_upper``; each basic arc carries what its subtree needs, summed
    level by level up the forest in torch.  Returned as float64."""
    up = np.flatnonzero(at_upper)
    x = torch.zeros(net.n, dtype=dtype)
    upt = torch.as_tensor(up)
    x[upt] = torch.tensor(net.u[up], dtype=dtype)
    need = torch.tensor(net.b, dtype=dtype)          # net inflow still due
    need.index_add_(0, torch.as_tensor(net.heads[up]), -x[upt])
    need.index_add_(0, torch.as_tensor(net.tails[up]), x[upt])
    pred = torch.as_tensor(forest.pred)
    parc = torch.as_tensor(forest.parc)
    down = torch.as_tensor(forest.down)
    for lv in reversed(forest.levels()[1:]):
        v = torch.as_tensor(lv)
        r = need[v]
        x[parc[v]] = torch.where(down[v], r, -r)
        need.index_add_(0, pred[v], r)
    return x.double().numpy()


def _bellman_ford(n: int, src, dst, w) -> np.ndarray | None:
    """Shortest distances from a source joined to all n nodes at 0, or
    None where a negative cycle keeps them falling after n rounds."""
    C = np.zeros(n)
    for _ in range(n + 1):
        nxt = C.copy()
        np.minimum.at(nxt, dst, C[src] + w)
        if np.array_equal(nxt, C):
            return C
        C = nxt
    return None


def potentials(net: Network, forest: Forest, upper: np.ndarray) -> np.ndarray:
    """Float64 node potentials with pi[h] - pi[t] = c on every basic arc.
    Where the basis is a forest of several components, each component's
    constant is chosen so that the nonbasic arcs between components keep
    the sign their bound asks for (at 0: reduced cost >= 0; at u, where
    ``upper``: <= 0), or break it by as little as any choice can: the
    least slack under which Bellman-Ford finds constants, by bisection."""
    m = net.m
    pl, al, dl = (forest.pred.tolist(), forest.parc.tolist(),
                  forest.down.tolist())
    c = net.c
    p = [0.0] * (m + 1)
    for v in forest.order:
        a = al[v]
        if a >= 0:
            p[v] = p[pl[v]] + (float(c[a]) if dl[v] else -float(c[a]))
    pi = np.asarray(p[:m])
    if forest.n_comp == 1:
        return pi
    ct, ch = forest.comp[net.tails], forest.comp[net.heads]
    cross = np.flatnonzero(ct != ch)
    if cross.size == 0:
        return pi
    up = upper[cross]
    red = net.c[cross] - (pi[net.heads[cross]] - pi[net.tails[cross]])
    # C[ch] - C[ct] <= red at 0, C[ct] - C[ch] <= -red at u: distances
    src = np.where(up, ch[cross], ct[cross])
    dst = np.where(up, ct[cross], ch[cross])
    w = np.where(up, -red, red)
    C = _bellman_ford(forest.n_comp, src, dst, w)
    if C is None:
        lo, hi = 0.0, float(np.abs(w).max()) + 1.0
        for _ in range(40):
            mid = (lo + hi) / 2
            if _bellman_ford(forest.n_comp, src, dst, w + mid) is None:
                lo = mid
            else:
                hi = mid
        C = _bellman_ford(forest.n_comp, src, dst, w + hi)
    return pi + C[forest.comp]


def residual(net: Network, x: np.ndarray) -> np.ndarray:
    """A x - b."""
    if net.ot_shape is not None:
        X = x.reshape(net.ot_shape)
        return np.concatenate([-X.sum(1), X.sum(0)]) - net.b
    return (np.bincount(net.heads, x, net.m)
            - np.bincount(net.tails, x, net.m) - net.b)


def reduced_costs(net: Network, pi: np.ndarray) -> np.ndarray:
    """c - (pi[h] - pi[t]) for every arc."""
    if net.ot_shape is not None:
        S, D = net.ot_shape
        return ((net.c.reshape(S, D) - pi[S:][None, :])
                + pi[:S][:, None]).ravel()
    return net.c - (pi[net.heads] - pi[net.tails])


INF = {"vertex_err": float("inf"), "obj_err": float("inf"),
       "rcost_err": float("inf")}


def judge(net: Network, basic: np.ndarray, x: np.ndarray, obj: float,
          extra: np.ndarray | None = None, sign_apart: bool = False) -> dict:
    """The numbers compared for one returned vertex x, its objective
    ``obj`` and its basic arcs ``basic``: ``vertex_err``, ``obj_err`` and
    ``rcost_err`` (see the module's text); ``extra`` holds flows that have
    to be nought.  With ``sign_apart`` the bound violations are left out
    of ``vertex_err`` and returned, in absolute units, as ``sign_err``.
    All are inf where the basis is no forest."""
    x = np.asarray(x, np.float64)
    forest = basis_forest(net, basic)
    if forest is None or x.shape != (net.n,) or not np.isfinite(x).all():
        return dict(INF)
    nonbasic = np.ones(net.n, bool)
    nonbasic[basic] = False
    xn = x[nonbasic]
    if net.ot_shape is None:
        off = np.minimum(np.abs(xn), np.abs(xn - net.u[nonbasic]))
        upper = nonbasic & (x > net.u / 2)
    else:
        off = np.abs(xn)
        upper = np.zeros(net.n, bool)
    bound = max(float(np.max(-x, initial=0.0)),
                float(np.max(x - net.u, initial=0.0)))
    err = max(float(np.abs(residual(net, x)).max()),
              0.0 if sign_apart else bound,
              float(off.max(initial=0.0)),
              float(np.abs(extra).max(initial=0.0)) if extra is not None
              else 0.0)
    cx = float(net.c @ x)
    rc = reduced_costs(net, potentials(net, forest, upper))
    wrong = max(float(np.max(-rc[nonbasic & ~upper], initial=0.0)),
                float(np.max(rc[upper], initial=0.0)),
                float(np.abs(rc[basic]).max(initial=0.0)))
    out = {"vertex_err": err / (float(np.abs(net.b).max()) or 1.0),
           "obj_err": abs(float(obj) - cx) / max(abs(cx), 1e-300),
           "rcost_err": wrong / net.rc_scale}
    if sign_apart:
        out["sign_err"] = bound
    return out


def vertex_of_basis(net: Network, basic: np.ndarray, at_upper: np.ndarray,
                    dtype) -> tuple:
    """(x, c'x) of the basis's vertex, both computed in ``dtype`` and
    returned as float64; (None, nan) where the basis is no forest."""
    forest = basis_forest(net, basic)
    if forest is None:
        return None, float("nan")
    x = tree_flows(net, forest, at_upper, dtype)
    obj = torch.dot(torch.tensor(net.c, dtype=dtype),
                    torch.tensor(x, dtype=dtype))
    return x, float(obj)


OT_INF = dict(INF, device_err=float("inf"), device_gap=float("inf"),
              sign_err=float("inf"))


def judge_ot_basis(net: Network, basic: np.ndarray, obj_dev: float,
                   x_dev: np.ndarray | None = None,
                   certified: bool = False, cert_obj: float = 0.0,
                   cert_x: np.ndarray | None = None) -> dict:
    """The numbers compared for one transport answer of a device route:
    its basic arcs ``basic``, its objective ``obj_dev`` and, where kept,
    its flows ``x_dev`` (``device_err``, ``device_gap``); and, where the
    program certified it, the float64 objective ``cert_obj`` and, where
    kept, the vertex ``cert_x`` it returned (``vertex_err``, ``obj_err``,
    ``rcost_err`` as ``judge`` has them; without ``cert_x``, ``obj_err``
    against c'x64) and ``sign_err``, x64's and ``cert_x``'s largest
    bound violation.  All inf where the basis is no spanning tree."""
    forest = basis_forest(net, basic)
    if forest is None or forest.n_comp != 1:
        return dict(OT_INF)
    none = np.zeros(net.n, bool)
    x64 = tree_flows(net, forest, none, torch.float64)
    scale = float(np.abs(net.b).max()) or 1.0
    err = max(float(-x64.min()), 0.0)
    if x_dev is not None:
        xd = np.asarray(x_dev, np.float64).ravel()
        err = (max(err, float(np.abs(xd - x64).max()))
               if xd.shape == x64.shape and np.isfinite(xd).all()
               else float("inf"))
    cx = float(net.c @ x64)
    rc = reduced_costs(net, potentials(net, forest, none))
    nonbasic = np.ones(net.n, bool)
    nonbasic[basic] = False
    lag = cx + float(np.minimum(rc[nonbasic], 0.0) @ net.u[nonbasic])
    den = max(abs(cx), 1e-300)
    out = {"device_err": err / scale,
           "device_gap": max(abs(float(obj_dev) - cx), cx - lag) / den,
           "vertex_err": 0.0, "sign_err": 0.0, "obj_err": 0.0,
           "rcost_err": 0.0}
    if certified:
        neg = max(float(-x64.min()), float((x64 - net.u).max()), 0.0)
        out["sign_err"] = neg
        if cert_x is not None:
            out.update(judge(net, basic, np.ravel(cert_x), cert_obj,
                             sign_apart=True))
            out["sign_err"] = max(out["sign_err"], neg)
        else:
            out.update(
                obj_err=abs(float(cert_obj) - cx) / den,
                rcost_err=float(np.max(-rc[nonbasic], initial=0.0))
                / net.rc_scale)
    return out
