"""Batched dense interior-point method.

Port of ``smart_crossover_tpu/solvers/ipm_batched.py``: a Mehrotra
predictor-corrector for a batch of DENSE bounded LPs, ``A`` (B, m, n).  The
normal-equations matrices ``A D A'`` are one batched matmul and their
factorisations one batched Cholesky (cuBLAS / cuSOLVER on a CUDA card, as
the JAX package computes them with XLA outside any Pallas kernel).

The JAX package vmaps a ``lax.while_loop``; here the loop is Python over
the whole batch, one host read per iteration for "has every instance
stopped".  Each instance keeps the JAX loop's own condition (not done,
``it < max_iters``, ``stall < 4``, ``mu_prev > mu_exit``): once it is false
the instance's state, its iteration count included, is held by
``torch.where``, and a converged instance is held before it steps, so
``iters`` equals the JAX package's instance by instance.

An infinite bound of a one-sided column gets the JAX package's wide
internal box; a free column is left unboxed (ROADMAP 3.12).  Fixed columns
should be presolved out by the caller.  Check the returned ``converged`` mask: an instance
whose Cholesky breaks down (``cholesky_ex`` reports it; its factor is set
to NaN, as JAX's ``cho_factor`` returns) stops and reports
``converged=False``.
"""
from __future__ import annotations

import contextlib

import torch

from smart_crossover_tpu_torch.config import resolve_device, to_device


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matmuls in full IEEE precision (no TF32) whatever the
    caller's global setting, and restore that setting afterwards: the JAX
    package runs these products at ``Precision.HIGHEST``."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _mv(A, x):
    """Batched A @ x: (B, m, n) x (B, n) -> (B, m)."""
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def _dot(a, b):
    return (a * b).sum(-1)


def _max_step(v, dv, red=None):
    neg = dv < 0
    r = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf).amin(-1)
    return torch.clamp(r if red is None else red(r, "min"), max=1.0)


def ipm_dense_batched(A, b, c, l, u, tol: float = 1e-8, max_iters: int = 50,
                      mu_exit: float | None = None, *, device=None,
                      col_reduce=None):
    """Dense IPM over a batch: A (B, m, n), b (B, m), c, l, u (B, n).

    Bounds may be +/-inf (a one-sided column's infinite bound gets a wide
    box, a free column none).  ``mu_exit``
    stops an instance once its complementarity mu falls to it, even before
    the residual test passes (default 1e-7 in float32, 0 in float64: in
    float32 the residuals floor near 1e-5 while mu keeps collapsing, and the
    damped last step lands mu on ``mu_exit``, a centred hand-off point for
    ``solvers/ipm_fleet.py``).  ``device``: default A's device if A is a
    tensor, else the CUDA card (float32 there, the input's float64 on the
    CPU).

    ``col_reduce``: for A split by columns over ranks (``ipm_fleet``'s
    mesh column branch), a function (tensor, "sum" | "min") -> the tensor
    all-reduced over the ranks holding A's column blocks.  Each rank then
    passes its (B, m, n_loc) block of A and (B, n_loc) blocks of c, l, u;
    every reduction over n goes through the function (A x and A D A'
    summed, dot products and norms over n summed, the ratio tests' minima),
    so the m-space state and the loop's decisions are alike on every rank.
    None (A whole) computes exactly as without it.

    Returns a dict of tensors on the device: x, y, zl, zu, obj_val (B,),
    iters (B,) and converged (B,) bool; x, zl, zu are a rank's blocks
    under ``col_reduce``.
    """
    dev = resolve_device(device, A)
    A = to_device(A, dev)
    dtype = A.dtype
    b, c, l, u = (to_device(v, dev, dtype) for v in (b, c, l, u))
    B, m, n = A.shape
    red = col_reduce
    if red is not None:
        n = int(red(torch.tensor(n, device=dev), "sum"))

    def nsum(t):
        """A partial sum over n, completed across the column blocks."""
        return t if red is None else red(t, "sum")

    def ndot(a, b_):
        return nsum(_dot(a, b_))

    def nnorm(v):
        if red is None:
            return torch.linalg.norm(v, dim=-1)
        return torch.sqrt(red((v * v).sum(-1), "sum"))

    def nstep(v, dv):
        return _max_step(v, dv, red)
    f64 = dtype == torch.float64
    if mu_exit is None:
        mu_exit = 0.0 if f64 else 1e-7
    mu_exit = torch.tensor(mu_exit, dtype=dtype, device=dev)
    # the JAX package's wide box +/-1e6 (1 + max|b|) on an infinite bound
    # of a one-sided column; a free column stays unboxed: its slacks and
    # duals drop out (x = p, q = -x, zl = zu = 0) and it rides the normal
    # equations at d = d_free (see step).  The box on a free column stalls
    # the JAX package (ROADMAP 3.12); without free columns every where()
    # below takes its first branch and the arithmetic is the JAX package's
    free = ~torch.isfinite(l) & ~torch.isfinite(u)
    bnd = ~free
    scale = 1.0 + torch.clamp(b.abs().amax(-1), min=1.0)
    wide = (1e6 * scale)[:, None]
    l = torch.where(torch.isfinite(l) | free, l, -wide)
    u = torch.where(torch.isfinite(u) | free, u, wide)
    lv = torch.where(bnd, l, 0.0)
    uv = torch.where(bnd, u, 0.0)
    p = torch.where(bnd, 0.5 * (l + u) - l, 0.0)
    q = torch.where(bnd, u - 0.5 * (l + u), 0.0)
    zl = torch.where(bnd, 1.0 + c.abs(), 0.0)
    zu = torch.where(bnd, 1.0 + c.abs(), 0.0)
    n_bounds = torch.clamp(nsum(2 * bnd.sum(-1).to(dtype)), min=1.0)
    has_free = bool(nsum(free.sum(-1).to(dtype)).amax() > 0)
    y = torch.zeros_like(b)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    stall = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    mu_prev = torch.full((B,), torch.inf, dtype=dtype, device=dev)

    bnorm = 1.0 + torch.linalg.norm(b, dim=-1)
    cnorm = 1.0 + nnorm(c)
    reg_base = 1e-10 if f64 else 1e-6
    floor = 1e-16 if f64 else 1e-8
    AT = A.transpose(1, 2)
    eye = torch.eye(m, dtype=dtype, device=dev)

    def converged(p, q, zl, zu, y):
        x = lv + p
        pres = torch.linalg.norm(b - nsum(_mv(A, x)), dim=-1) / bnorm
        dres = nnorm(c - _mv(AT, y) - zl + zu) / cnorm
        pobj = ndot(c, x)
        dobj = _dot(b, y) + ndot(lv, zl) - ndot(uv, zu)
        relgap = (pobj - dobj).abs() / (1 + pobj.abs() + dobj.abs())
        return (pres < tol) & (dres < tol) & (relgap < tol)

    def step(p, q, zl, zu, y, mu_prev, stall):
        x = lv + p
        r_p = b - nsum(_mv(A, x))
        r_d = c - _mv(AT, y) - zl + zu
        gap = ndot(p, zl) + ndot(q, zu)
        mu = gap / n_bounds
        # at the f32 precision floor mu stops contracting; further
        # Mehrotra steps there only pollute the iterate
        stall = torch.where(mu > 0.7 * mu_prev, stall + 1, 0)

        d = 1.0 / (torch.where(bnd, zl / p, 0.0) + torch.where(bnd, zu / q, 0.0))
        if has_free:
            # a free column has no barrier term: it gets the largest
            # scaling of the instance's bounded columns, as its most basic
            # column (a primal proximal term, Saunders; the host IPM pins
            # it at its scaling cap)
            d_free = torch.where(free, 0.0, d).amax(-1, keepdim=True)
            if red is not None:
                d_free = red(d_free, "max")
            d = torch.where(free, d_free, d)
        ADA = nsum(torch.matmul(A * d[:, None, :], AT))
        diag = torch.diagonal(ADA, dim1=-2, dim2=-1)
        if has_free:
            # the free columns' scaling sits at the top of the range, and
            # a shift relative to the largest diagonal would swamp the
            # rows of small diagonal (their primal residual stops
            # contracting): shift each row relative to its own diagonal
            ADA_reg = ADA + torch.diag_embed(reg_base * (1.0 + diag))
        else:
            diag_max = diag.amax(-1)
            ADA_reg = ADA + (reg_base * (1.0 + diag_max))[:, None, None] * eye
        L, info = torch.linalg.cholesky_ex(ADA_reg)
        # a breakdown gives NaNs, as JAX's cho_factor does
        L = torch.where((info > 0)[:, None, None], torch.nan, L)

        def newton(rp, rd, rcl, rcu):
            rhs_x = (rd - torch.where(bnd, rcl / p, 0.0)
                     + torch.where(bnd, rcu / q, 0.0))
            rhs_y = rp + nsum(_mv(A, d * rhs_x))
            dy = torch.cholesky_solve(rhs_y.unsqueeze(-1), L).squeeze(-1)
            # one iterative-refinement pass: the f32 Cholesky at
            # cond(ADA) ~ 1/mu loses most of its digits mid-solve
            dy = dy + torch.cholesky_solve(
                (rhs_y - _mv(ADA, dy)).unsqueeze(-1), L).squeeze(-1)
            dx = d * (_mv(AT, dy) - rhs_x)
            dzl = torch.where(bnd, (rcl - zl * dx) / p, 0.0)
            dzu = torch.where(bnd, (rcu + zu * dx) / q, 0.0)
            return dx, dy, dzl, dzu

        def col(v):
            return v[:, None]

        # predictor
        dx_a, dy_a, dzl_a, dzu_a = newton(r_p, r_d, -p * zl, -q * zu)
        # the primal ratio tests run over the boxed columns only
        ap = torch.minimum(nstep(p, torch.where(bnd, dx_a, 0.0)),
                           nstep(q, torch.where(bnd, -dx_a, 0.0)))
        ad = torch.minimum(nstep(zl, dzl_a), nstep(zu, dzu_a))
        gap_aff = (ndot(p + col(ap) * dx_a, zl + col(ad) * dzl_a)
                   + ndot(q - col(ap) * dx_a, zu + col(ad) * dzu_a))
        sigma = torch.clamp((gap_aff / gap) ** 3, 0.0, 1.0)

        # corrector
        rcl = col(sigma * mu) - p * zl - dx_a * dzl_a
        rcu = col(sigma * mu) - q * zu + dx_a * dzu_a
        dx, dy, dzl, dzu = newton(r_p, r_d, rcl, rcu)
        ap = 0.9995 * torch.minimum(nstep(p, torch.where(bnd, dx, 0.0)),
                                    nstep(q, torch.where(bnd, -dx, 0.0)))
        ad = 0.9995 * torch.minimum(nstep(zl, dzl), nstep(zu, dzu))

        # damp the step so mu lands ON mu_exit instead of overshooting it
        # (the endgame hand-off wants a centred iterate at the target mu);
        # a no-op when mu_exit == 0
        gap_next = (ndot(p + col(ap) * dx, zl + col(ad) * dzl)
                    + ndot(q - col(ap) * dx, zu + col(ad) * dzu))
        target = 0.5 * mu_exit * n_bounds
        t = torch.where(gap_next < target,
                        torch.sqrt(target / torch.clamp(gap_next, min=1e-30)),
                        1.0)
        t = torch.clamp(t, 0.05, 1.0)
        ap = col(ap * t)
        ad = col(ad * t)
        p = torch.where(bnd, torch.clamp(p + ap * dx, min=floor), p + ap * dx)
        q = torch.where(bnd, torch.clamp(q - ap * dx, min=floor), q - ap * dx)
        y = y + ad * dy
        zl = torch.where(bnd, torch.clamp(zl + ad * dzl, min=floor), 0.0)
        zu = torch.where(bnd, torch.clamp(zu + ad * dzu, min=floor), 0.0)
        return p, q, zl, zu, y, mu, stall

    with full_f32_matmul():
        while True:
            active = ~done & (it < max_iters) & (stall < 4) \
                & (mu_prev > mu_exit)
            if not bool(active.any()):
                break
            # exit BEFORE stepping once converged: one extra Mehrotra step
            # past convergence destroys the normal-equations conditioning
            conv = converged(p, q, zl, zu, y)
            done = done | (active & conv)
            move = active & ~conv
            new = step(p, q, zl, zu, y, mu_prev, stall)
            mv = move[:, None]
            p, q, zl, zu, y = (torch.where(mv, a, o) for a, o in
                               zip(new[:5], (p, q, zl, zu, y)))
            mu_prev = torch.where(move, new[5], mu_prev)
            stall = torch.where(move, new[6], stall)
            it = it + move.long()
        done = done | converged(p, q, zl, zu, y)
    x = lv + p
    return {"x": x, "y": y, "zl": zl, "zu": zu, "obj_val": ndot(c, x),
            "iters": it, "converged": done}


def ipm_dense(A, b, c, l, u, tol: float = 1e-8, max_iters: int = 50,
              mu_exit: float | None = None, *, device=None):
    """Single-instance dense IPM: A (m, n), b (m,), c, l, u (n,); the batch
    of one of ``ipm_dense_batched``.  Returns the same keys, unbatched."""
    dev = resolve_device(device, A)
    A = to_device(A, dev)
    args = (to_device(v, dev, A.dtype)[None] for v in (A, b, c, l, u))
    out = ipm_dense_batched(*args, tol, max_iters, mu_exit, device=dev)
    return {k: v[0] for k, v in out.items()}
