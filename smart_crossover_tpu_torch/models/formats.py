"""Problem formats.

Host copy of ``smart_crossover_tpu/models/formats.py``, unchanged (the port
may not import the JAX package).

Capability parity with the reference's formats module
(reference formats.py:11-161): ``GeneralLP``, ``StandardLP``, ``MinCostFlow``
and ``OptTransport``, with the same mathematical semantics.  The *design* is
TPU-first rather than scipy-first:

* ``MinCostFlow`` is arc-list primary (``tails``/``heads`` int arrays), which
  maps directly onto JAX segment ops for flow ranking, tree algorithms and
  network-simplex pricing; the sparse incidence matrix is derived on demand
  for host-side exact algebra.
* ``OptTransport`` keeps the dense (s, d, M) structure that batches/vmaps
  onto the MXU.
* ``GeneralLP``/``StandardLP`` carry scipy-sparse (or dense) ``A`` on the
  host control plane; device engines consume them densely or as BCOO
  (see solvers/pdhg.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import scipy.sparse as sp

Matrix = Union[sp.spmatrix, np.ndarray]

SENSE_EQ = "="
SENSE_LE = "<"


def _as_dense_1d(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float64).reshape(-1)


@dataclass
class GeneralLP:
    """General-form LP:  min c'x  s.t.  A x (sense) b,  l <= x <= u.

    Only ``=`` and ``<`` row senses are allowed (as in the reference,
    formats.py:28).
    """

    A: Matrix
    b: np.ndarray
    c: np.ndarray
    l: np.ndarray
    u: np.ndarray
    sense: np.ndarray
    name: str = "lp_instance"
    obj_offset: float = 0.0   # constant term (e.g. an MPS objective RHS)
    col_names: list | None = None   # optional variable names (MPS/LP ingest)

    def __post_init__(self) -> None:
        self.b = _as_dense_1d(self.b)
        self.c = _as_dense_1d(self.c)
        self.l = _as_dense_1d(self.l)
        self.u = _as_dense_1d(self.u)
        self.sense = np.asarray(self.sense)
        if not np.all((self.sense == SENSE_EQ) | (self.sense == SENSE_LE)):
            raise ValueError("GeneralLP only supports '=' and '<' constraint senses.")

    # --- shapes -------------------------------------------------------------
    @property
    def m(self) -> int:
        return self.b.size

    @property
    def n(self) -> int:
        return self.c.size

    @property
    def num_slacks(self) -> int:
        return int(np.sum(self.sense == SENSE_LE))

    # --- index helpers ------------------------------------------------------
    def get_free_ind(self) -> np.ndarray:
        """Indices of free variables (both bounds infinite)."""
        return np.where(np.isneginf(self.l) & np.isposinf(self.u))[0]

    def get_nonfree_ind(self) -> np.ndarray:
        """Indices of non-free variables *in the slack-augmented space*."""
        n_std = self.n + self.num_slacks
        mask = np.ones(n_std, dtype=bool)
        mask[self.get_free_ind()] = False
        return np.where(mask)[0]

    def get_free_var_matrix(self) -> sp.csr_matrix:
        return sp.csr_matrix(self.A)[:, self.get_free_ind()]

    def get_nonfree_var_matrix(self) -> sp.csr_matrix:
        return self.get_standard_A()[:, self.get_nonfree_ind()]

    # --- standard-form augmentation ----------------------------------------
    def get_standard_A(self) -> sp.csr_matrix:
        """Append one slack column per '<' row so rows all read ``A x = b``."""
        le_rows = np.where(self.sense == SENSE_LE)[0]
        slack_cols = sp.csc_matrix(
            (np.ones(le_rows.size), (le_rows, np.arange(le_rows.size))),
            shape=(self.m, le_rows.size),
        )
        return sp.hstack([sp.csr_matrix(self.A), slack_cols]).tocsr()

    def get_standard_c(self) -> np.ndarray:
        return np.concatenate([self.c, np.zeros(self.num_slacks)])

    def get_standard_x(self, x: np.ndarray) -> np.ndarray:
        """Augment ``x`` with the slack values ``b_< - A_< x``."""
        le_rows = np.where(self.sense == SENSE_LE)[0]
        Ax = sp.csr_matrix(self.A)[le_rows, :] @ x
        return np.concatenate([x, self.b[le_rows] - np.asarray(Ax).reshape(-1)])

    def get_standard_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """Bounds in the slack-augmented space (slacks are [0, inf))."""
        ns = self.num_slacks
        return (
            np.concatenate([self.l, np.zeros(ns)]),
            np.concatenate([self.u, np.full(ns, np.inf)]),
        )

    # --- slacks -------------------------------------------------------------
    def get_dual_slack(self, y: np.ndarray) -> np.ndarray:
        """Reduced costs c - A'y."""
        return self.c - np.asarray(sp.csr_matrix(self.A).T @ y).reshape(-1)

    def get_primal_slack(self, x: np.ndarray) -> np.ndarray:
        """Row slacks b - Ax."""
        return self.b - np.asarray(sp.csr_matrix(self.A) @ x).reshape(-1)

    def copy(self) -> "GeneralLP":
        A = self.A.copy()
        return GeneralLP(A, self.b.copy(), self.c.copy(), self.l.copy(),
                         self.u.copy(), self.sense.copy(), self.name,
                         self.obj_offset,
                         list(self.col_names) if self.col_names else None)


@dataclass
class StandardLP:
    """Standard-form LP:  min c'x  s.t.  A x = b,  l <= x <= u with l in {0, -inf}."""

    A: Matrix
    b: np.ndarray
    c: np.ndarray
    u: np.ndarray
    name: str = "lp_instance"
    l: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        self.b = _as_dense_1d(self.b)
        self.c = _as_dense_1d(self.c)
        self.u = _as_dense_1d(self.u)
        if self.l is None:
            self.l = np.zeros_like(self.u)
        else:
            self.l = _as_dense_1d(self.l)

    @property
    def m(self) -> int:
        return self.b.size

    @property
    def n(self) -> int:
        return self.c.size

    def to_general(self) -> GeneralLP:
        return GeneralLP(A=self.A, b=self.b, c=self.c, l=self.l, u=self.u,
                         sense=np.full(self.m, SENSE_EQ), name=self.name)


@dataclass
class MinCostFlow:
    """Min-cost-flow LP on a directed graph, arc-list primary.

    ``min c'x  s.t.  N x = b, 0 <= x <= u`` where N is the node-arc incidence
    with ``N[heads[j], j] = +1`` and ``N[tails[j], j] = -1``; ``b`` is the
    net-inflow requirement per node (``sum(b) == 0``).

    This is the same LP the reference's MinCostFlow carries as a CSR matrix
    (reference formats.py:105-121); the arc-list layout is what TPU segment
    ops and the network simplex consume directly.
    """

    tails: np.ndarray
    heads: np.ndarray
    c: np.ndarray
    u: np.ndarray
    b: np.ndarray
    name: str = "mcf_instance"

    def __post_init__(self) -> None:
        self.tails = np.asarray(self.tails, dtype=np.int64).reshape(-1)
        self.heads = np.asarray(self.heads, dtype=np.int64).reshape(-1)
        self.c = _as_dense_1d(self.c)
        self.u = _as_dense_1d(self.u)
        self.b = _as_dense_1d(self.b)
        if not np.isclose(np.sum(self.b), 0.0, atol=1e-6):
            raise ValueError("MinCostFlow requires sum(b) == 0.")

    @property
    def m(self) -> int:
        return self.b.size

    @property
    def n(self) -> int:
        return self.c.size

    # --- incidence-matrix views (host-side exact algebra) -------------------
    @property
    def A(self) -> sp.csc_matrix:
        n, m = self.n, self.m
        rows = np.concatenate([self.heads, self.tails])
        cols = np.concatenate([np.arange(n), np.arange(n)])
        data = np.concatenate([np.ones(n), -np.ones(n)])
        # Self-loops (tail == head) cancel to a zero column, matching A@x = 0
        # contribution; duplicate (row, col) entries are summed by scipy.
        return sp.csc_matrix((data, (rows, cols)), shape=(m, n))

    @classmethod
    def from_incidence(cls, A: Matrix, b, c, u, name: str = "mcf_instance") -> "MinCostFlow":
        """Build from a +/-1 node-arc incidence matrix (one +1, one -1 per column)."""
        A = sp.coo_matrix(A)
        A.sum_duplicates()
        m, n = A.shape
        keep = A.data != 0
        rows, cols, vals = A.row[keep], A.col[keep], A.data[keep]
        if not np.allclose(np.abs(vals), 1.0):
            raise ValueError("Incidence matrix entries must be +/-1.")
        pos, neg = vals > 0, vals < 0
        heads = np.full(n, -1, dtype=np.int64)
        tails = np.full(n, -1, dtype=np.int64)
        heads[cols[pos]] = rows[pos]
        tails[cols[neg]] = rows[neg]
        if (np.bincount(cols[pos], minlength=n).max(initial=0) > 1
                or np.bincount(cols[neg], minlength=n).max(initial=0) > 1
                or np.any(heads < 0) or np.any(tails < 0)):
            raise ValueError("Each column must have exactly one +1 and one -1 entry.")
        return cls(tails=tails, heads=heads, c=c, u=u, b=b, name=name)

    def to_standard_lp(self) -> StandardLP:
        return StandardLP(A=self.A, b=self.b, c=self.c, u=self.u, name=self.name)

    def copy(self) -> "MinCostFlow":
        return MinCostFlow(self.tails.copy(), self.heads.copy(), self.c.copy(),
                           self.u.copy(), self.b.copy(), self.name)


@dataclass
class OptTransport:
    """Optimal transport instance: supplies ``s``, demands ``d``, dense cost ``M``.

    Same triple as the reference's OptTransport (formats.py:125-161);
    ``to_MCF`` produces the bipartite min-cost-flow form, built directly as an
    arc list instead of Kronecker-product incidence rows.
    """

    s: np.ndarray
    d: np.ndarray
    M: np.ndarray
    name: str = "ot_instance"

    def __post_init__(self) -> None:
        self.s = _as_dense_1d(self.s)
        self.d = _as_dense_1d(self.d)
        self.M = np.asarray(self.M, dtype=np.float64)
        if self.M.shape != (self.s.size, self.d.size):
            raise ValueError("Cost matrix shape must be (len(s), len(d)).")
        if not np.isclose(np.sum(self.s), np.sum(self.d), atol=1e-6):
            raise ValueError("Total supply must equal total demand.")

    @property
    def num_suppliers(self) -> int:
        return self.s.size

    @property
    def num_demanders(self) -> int:
        return self.d.size

    @property
    def m(self) -> int:
        return self.s.size + self.d.size

    @property
    def n(self) -> int:
        return self.s.size * self.d.size

    def to_MCF(self) -> MinCostFlow:
        """Bipartite MCF: arc (i, j) runs supplier i -> demander j.

        Node order: suppliers then demanders; ``b = [-s, d]`` (suppliers push
        flow out, demanders pull it in), ``c = M.ravel()``, ``u = inf`` —
        the same LP as reference formats.py:147-161.
        """
        ns, nd = self.s.size, self.d.size
        tails = np.repeat(np.arange(ns), nd)
        heads = ns + np.tile(np.arange(nd), ns)
        b = np.concatenate([-self.s, self.d])
        return MinCostFlow(tails=tails, heads=heads, c=self.M.ravel(),
                           u=np.full(ns * nd, np.inf), b=b,
                           name=self.name + "_mcf")

    def copy(self) -> "OptTransport":
        return OptTransport(self.s.copy(), self.d.copy(), self.M.copy(), self.name)
