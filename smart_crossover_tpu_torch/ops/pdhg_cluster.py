"""The cluster PDHG kernels' layout plans and their rank decompositions.

``csrc/pdhg_cluster.cu`` runs PDHG on a dense A with one thread-block
cluster of C blocks per LP, in two kernels.  The adaptive-step kernel
serves ``solvers/pdhg_batched.py::pdhg_batched_cuda`` (replacing the TPU
kernel ``_batched_pdhg_kernel``, a fleet of equality LPs) and
``ops/pdhg_chunk.py::pdhg_chunk`` (replacing ``_pdhg_chunk_kernel``, one LP
with '<' rows and the primal weight); the Halpern kernel serves
``ops/pdhg_chunk.py::halpern_chunk`` (replacing ``_halpern_chunk_kernel``).
Rank q of a cluster owns rows ``split_rows(m, C)[q]`` of A and keeps as
many of them as fit in its shared memory for every iteration; the rest it
reads from L2 behind the same loops.  Per iteration the ranks post partial
A'y over their rows and combine them in rank order through distributed
shared memory into the same x_c, then take A x_c over their rows.  The
adaptive kernel also adds the posted scalar partials (the curvature
dy.(A x_c - A x), |dx|^2 over the rank's column slice (``column_slices``),
|dy|^2) in rank order, so every rank takes the same step decision; the
Halpern kernel has no step rule and no scalar partials.

``pdhg_cluster_plan`` picks C and the layout of the kernel whose
``Layout`` (``ADAPTIVE`` or ``HALPERN``) its caller passes;
``pdhg_batched_split``, ``pdhg_chunk_split`` and ``halpern_chunk_split``
are the rank decompositions in tensor form, for the tests.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from smart_crossover_tpu_torch import _build
from smart_crossover_tpu_torch.config import SMEM_PER_BLOCK, SMS, split_rows

_THREADS = 512           # kThreads in the CUDA source
_SCRATCH_FLOATS = 128    # kScratch: the warps', the cluster's and the ranks' sums
_CLUSTER_SIZES = tuple(range(1, 17))   # above 8: non-portable sizes

# plan of each wrapper's last launch, with the card's answer to how many of
# its clusters can be resident at once (read by chip_smoke.py)
LAST_LAUNCH: dict = {"pdhg_batched": {}, "pdhg_chunk": {}, "halpern_chunk": {}}
_MAX_ACTIVE: dict = {}
_PLANS: dict = {}


def pdhg_cluster_smem_bytes(m: int, n: int, C: int, n_res: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the CUDA
    source), float32 throughout: n_res resident rows of A, then x and x_c
    (replicated), each padded to np = n rounded up to 4; the partials of
    A'y (C column slices of cp = 4 ceil(np / 4 / C) floats, at least np);
    the row-group partials of the column pass (G x np where G =
    threads / (np / 4) > 1); the running sum of the rank's column slice
    (``column_slices``, at most ceil(np / 4 / C) quads); y, y_c, A x,
    A x_c, b, the '=' flags and the running sum of ceil(m / C) rows,
    padded to 4; the partial-sum scratch."""
    n4 = -(-n // 4)
    np_ = 4 * n4
    G = 1 if n4 >= _THREADS else _THREADS // n4
    rmax = -(-m // C)
    rp = 4 * -(-rmax // 4)
    cp = 4 * -(-n4 // C)
    floats = n_res * np_ + 2 * np_ + C * cp + (G * np_ if G > 1 else 0) \
        + cp + 7 * rp + _SCRATCH_FLOATS
    return 4 * floats


def halpern_cluster_smem_bytes(m: int, n: int, C: int, n_res: int) -> int:
    """Dynamic shared memory of one block of the Halpern kernel
    (``halpern_smem_bytes`` in the CUDA source), float32 throughout: n_res
    resident rows of A and x_t (replicated), padded to np = n rounded up to
    4; the partials of A'y (C column slices of cp = 4 ceil(np / 4 / C)
    floats); the row-group partials of the column pass (G x np where G =
    threads / (np / 4) > 1); x, xa, c, l and u of the rank's column slice
    (5 x cp); y, A x, b, the '=' flags, ya and A xa of ceil(m / C) rows,
    padded to 4."""
    n4 = -(-n // 4)
    np_ = 4 * n4
    G = 1 if n4 >= _THREADS else _THREADS // n4
    rmax = -(-m // C)
    rp = 4 * -(-rmax // 4)
    cp = 4 * -(-n4 // C)
    floats = n_res * np_ + np_ + C * cp + (G * np_ if G > 1 else 0) \
        + 5 * cp + 6 * rp
    return 4 * floats


class Layout(NamedTuple):
    """What a plan needs of one kernel of the CUDA source: its shared-memory
    byte count, the C entry points that give the same count and the card's
    resident clusters (both take B, m, n, C, n_res after the count's m),
    and the cluster size from which it combines by the scatter."""
    smem_bytes: Callable[[int, int, int, int], int]
    smem_entry: str
    clusters_entry: str
    scatter_from: int


# the adaptive kernel (K3, K5): the scatter from 8 blocks on, the all-read
# below (on an H100 the scatter won at C = 8, 12 and 16 and lost at C <= 4)
ADAPTIVE = Layout(pdhg_cluster_smem_bytes, "scx_pdhg_cluster_smem_bytes",
                  "scx_pdhg_cluster_max_clusters", 8)
# the Halpern kernel (K4): the scatter at every size
HALPERN = Layout(halpern_cluster_smem_bytes, "scx_halpern_cluster_smem_bytes",
                 "scx_halpern_cluster_max_clusters", 1)


def column_slices(n: int, C: int):
    """The ranks' column slices: rank q owns the column quads
    ``split_rows(ceil(n / 4), C)[q]`` (the kernel's c0, c1), cut at n.  It
    computes x_c for them in the scatter combine and owns their |dx|^2 and
    running sums."""
    return [(4 * lo, min(4 * hi, n)) for lo, hi in split_rows(-(-n // 4), C)]


def pdhg_cluster_plan(B: int, m: int, n: int,
                      smem_budget: int = SMEM_PER_BLOCK, sms: int = SMS, *,
                      active=None, cluster_size: int | None = None,
                      layout: Layout = ADAPTIVE) -> dict:
    """How a kernel lays out B LPs of shape (m, n): C blocks per LP.

    For each C in 1..16 (or ``cluster_size`` alone), rank q owns rows
    ``split_rows(m, C)[q]`` and keeps the first n_res of them in shared
    memory, n_res as large as ``smem_budget`` allows under the kernel's
    ``layout`` (``ADAPTIVE`` or ``HALPERN``).  ``active(C, n_res)`` is how
    many such clusters the card holds at once (the wrappers ask the card;
    without it, as in the CPU tests, the plan assumes one block per SM of
    ``sms``), so B LPs run in ceil(B / active) waves.  The plan takes the
    fewest waves, then the most of A in shared memory, then the smallest C
    (fewer ranks exchange less); the combine is the scatter from the
    layout's ``scatter_from`` on (see the CUDA source), the all-read below.
    Raises ValueError where no C fits.
    """
    if cluster_size is not None and cluster_size not in _CLUSTER_SIZES:
        raise ValueError(f"pdhg cluster kernel: no cluster layout of size "
                         f"{cluster_size}; sizes are {_CLUSTER_SIZES}")
    nbytes = layout.smem_bytes
    np_ = -(-n // 4) * 4
    best = None
    for C in ((cluster_size,) if cluster_size else _CLUSTER_SIZES):
        fixed = nbytes(m, n, C, 0)
        if fixed > smem_budget:
            continue
        rmax = -(-m // C)
        n_res = min(rmax, (smem_budget - fixed) // (4 * np_))
        n_act = active(C, n_res) if active is not None else sms // C
        if n_act < 1:
            continue
        ranges = split_rows(m, C)
        resident = sum(min(hi - lo, n_res) for lo, hi in ranges)
        waves = -(-B // n_act)
        key = (waves, -resident, C)
        if best is None or key < best[0]:
            best = (key, {
                "cluster_size": C, "row_ranges": ranges, "n_res": n_res,
                "rows_in_smem": resident, "a_in_smem": resident / m,
                "smem_bytes": nbytes(m, n, C, n_res),
                "max_active_clusters": n_act, "waves": waves,
                "scatter": C >= layout.scatter_from})
    if best is None:
        raise ValueError(
            f"pdhg cluster kernel: no cluster layout fits {m} x {n} in "
            f"{smem_budget} bytes of shared memory per block (the "
            f"vectors alone take at least "
            f"{min(nbytes(m, n, C, 0) for C in _CLUSTER_SIZES)})")
    return best[1]


def _active_clusters(lib, layout: Layout, B, m, n):
    """The card's count of resident clusters for a layout of the kernel,
    queried once per layout and cached; 0 where the card refuses the
    size."""
    query = getattr(lib, layout.clusters_entry)

    def active(C, n_res):
        key = (layout.clusters_entry, B, m, n, C, n_res)
        if key not in _MAX_ACTIVE:
            _MAX_ACTIVE[key] = max(query(B, m, n, C, n_res), 0)
        return _MAX_ACTIVE[key]
    return active


def cluster_plan_on_card(name: str, layout: Layout, A: torch.Tensor, B: int,
                         m: int, n: int, smem_budget: int, cluster_size):
    """The plan for a launch of the kernel of ``layout`` on A's card,
    checked against the source's shared-memory count, made once per shape
    and forcing and recorded in ``LAST_LAUNCH[name]``; returns the loaded
    library and the plan."""
    lib = _build.library()
    key = (name, A.device, B, m, n, smem_budget, cluster_size)
    plan = _PLANS.get(key)
    if plan is None:
        with torch.cuda.device(A.device):
            plan = pdhg_cluster_plan(
                B, m, n, smem_budget,
                active=_active_clusters(lib, layout, B, m, n),
                cluster_size=cluster_size, layout=layout)
        smem = getattr(lib, layout.smem_entry)(m, n, plan["cluster_size"],
                                               plan["n_res"])
        if smem != plan["smem_bytes"]:
            raise RuntimeError(f"{name}: the kernel lays out {smem} bytes of "
                               f"shared memory, the plan "
                               f"{plan['smem_bytes']}")
        plan = _PLANS[key] = dict(plan, shape=[B, m, n])
    LAST_LAUNCH[name] = plan
    return lib, plan


def _ranked(parts):
    """Partials added in rank order."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _cluster_iterations(A, b, c, l, u, is_eq, x, y, Ax, xs, ys, wsum, eta,
                        omega, k0, opnorm, iters: int, C: int):
    """``iters`` iterations of the kernel's arithmetic on (B, m, n) with
    per-instance scalars (B,): the rank decomposition, ranks in order."""
    B, m, n = A.shape
    rows, cols = split_rows(m, C), column_slices(n, C)
    lo, hi = 1e-10 / opnorm, 1e10 / opnorm
    eqm = is_eq.expand(B, m)
    for i in range(iters):
        tau, sigma = (eta / omega)[:, None], (eta * omega)[:, None]
        aty = _ranked([torch.einsum("bmn,bm->bn", A[:, r0:r1], y[:, r0:r1])
                      for r0, r1 in rows])
        x_c = torch.minimum(torch.maximum(x - tau * (c - aty), l), u)
        Ax_c = torch.einsum("bmn,bn->bm", A, x_c)
        y_t = y + sigma * (b - (2.0 * Ax_c - Ax))
        y_c = torch.where(eqm, y_t, torch.clamp(y_t, max=0.0))
        dx, dy = x_c - x, y_c - y
        curv = _ranked([(dy[:, r0:r1] * (Ax_c - Ax)[:, r0:r1]).sum(1)
                       for r0, r1 in rows]).abs()
        dxx = _ranked([(dx[:, c0:c1] ** 2).sum(1) for c0, c1 in cols])
        dyy = _ranked([(dy[:, r0:r1] ** 2).sum(1) for r0, r1 in rows])
        nz = omega * dxx + dyy / omega
        eta_bar = torch.where(curv > 0, nz / (2.0 * curv), hi)
        accept = eta <= eta_bar
        logk = torch.log(k0 + (i + 2.0))
        eta_next = torch.minimum((1.0 - torch.exp(-0.3 * logk)) * eta_bar,
                                 (1.0 + torch.exp(-0.6 * logk)) * eta)
        eta_next = torch.minimum(torch.maximum(eta_next, lo), hi)
        acc = accept[:, None]
        x = torch.where(acc, x_c, x)
        y = torch.where(acc, y_c, y)
        Ax = torch.where(acc, Ax_c, Ax)
        w = torch.where(accept, eta, torch.zeros_like(eta))
        xs = xs + w[:, None] * x
        ys = ys + w[:, None] * y
        wsum = wsum + w
        eta = eta_next
    return x, y, Ax, xs, ys, wsum, eta


def pdhg_batched_split(A, b, c, l, u, opnorm, iters: int, C: int):
    """K5's rank decomposition: ``pdhg_fixed_batched_plain`` from x0 =
    clip(0, l, u), y0 = 0 with A'y, the curvature and the squared norms
    taken from C ranks' partials added in rank order.  Returns (x, y,
    x_avg, y_avg)."""
    x0 = torch.minimum(torch.maximum(torch.zeros_like(c), l), u)
    y0 = torch.zeros_like(b)
    Ax0 = torch.einsum("bmn,bn->bm", A, x0)
    zero = torch.zeros_like(opnorm)
    is_eq = torch.ones(A.shape[1], dtype=torch.bool, device=A.device)
    x, y, _, xs, ys, wsum, _ = _cluster_iterations(
        A, b, c, l, u, is_eq, x0, y0, Ax0, torch.zeros_like(x0),
        torch.zeros_like(y0), zero, 0.9 / opnorm, zero + 1.0, zero, opnorm,
        iters, C)
    safe = torch.where(wsum > 0, wsum, 1.0)[:, None]
    return x, y, xs / safe, ys / safe


def pdhg_chunk_split(A, b, c, l, u, eq, x, y, Ax, xs, ys, wsum, eta, omega,
                     k, opnorm, C: int, chunk: int = 64):
    """K3's rank decomposition: ``pdhg_chunk_plain`` with the sums taken
    from C ranks' partials in rank order (and k^-p as exp(-p log k), as
    the kernel).  Returns (x, y, Ax, xs, ys, wsum, eta)."""
    is_eq = eq if eq.dtype == torch.bool else eq > 0

    def s(v):
        return torch.as_tensor(v, dtype=A.dtype, device=A.device).reshape(1)

    out = _cluster_iterations(
        A[None], b[None], c[None], l[None], u[None], is_eq[None], x[None],
        y[None], Ax[None], xs[None], ys[None], s(wsum), s(eta), s(omega),
        s(k), s(opnorm), chunk, C)
    return tuple(v[0] for v in out)


def halpern_chunk_split(A, b, c, l, u, eq, x, y, Ax, xa, ya, Axa, omega, k,
                        step, C: int, chunk: int = 64):
    """K4's rank decomposition: ``halpern_chunk_plain`` with A'y taken from
    C ranks' partials in rank order.  Returns (x, y, Ax, k + chunk)."""
    is_eq = eq if eq.dtype == torch.bool else eq > 0
    omega, step, k = (torch.as_tensor(v, dtype=A.dtype, device=A.device)
                      for v in (omega, step, k))
    tau, sigma = step / omega, step * omega
    rows = split_rows(A.shape[0], C)
    for _ in range(chunk):
        aty = _ranked([A[r0:r1].T @ y[r0:r1] for r0, r1 in rows])
        x_t = torch.minimum(torch.maximum(x - tau * (c - aty), l), u)
        Ax_t = A @ x_t
        y_t0 = y + sigma * (b - (2.0 * Ax_t - Ax))
        y_t = torch.where(is_eq, y_t0, torch.clamp(y_t0, max=0.0))
        lam = (k + 1.0) / (k + 2.0)
        x = lam * (2.0 * x_t - x) + (1.0 - lam) * xa
        y = lam * (2.0 * y_t - y) + (1.0 - lam) * ya
        Ax = lam * (2.0 * Ax_t - Ax) + (1.0 - lam) * Axa
        k = k + 1.0
    return x, y, Ax, k
