"""Device-backed normal-equations solver for the f64 IPM endgame.

Port of ``smart_crossover_tpu/solvers/ne_device.py``.  The f64 endgame's
per-iteration cost is the dense normal-equations formation ``M = A D A'``
(2 m^2 n flops) plus an O(m^3) factorisation, while the solves it feeds
only need to be f64-accurate.  Two device routes:

* **f32 + CG**: form and factor the Jacobi-equilibrated M in float32 on the
  device (full-precision matmul, no TF32; batched Cholesky), keep the
  factor resident, and drive each host solve to f64 accuracy by
  preconditioned CG on the exact f64 operator (matrix-free host matvecs);
* **direct f64**: where the device computes float64 (an H100 does, and so
  does the CPU), form M in f64 on the device, factor it with the caller's
  exact shift and solve with one exact-residual refinement pass.

When a solve fails to reach its tolerance, ``solve`` returns
``(dy, False)`` and the caller takes its exact host f64 path for that
iteration, so accuracy is never traded for speed.  Unlike the JAX module,
a torch error raised inside the f64 route (form, factor or solve) is such
a failure too: it is counted in ``stats["fallbacks"]`` and recorded in
``stats["fails"]`` instead of aborting the endgame.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from smart_crossover_tpu_torch.config import resolve_device
from smart_crossover_tpu_torch.solvers.ipm_batched import full_f32_matmul


def _f64_works(device) -> bool:
    """Does ``device`` compute float64?  (The JAX package probes x64 on its
    backend; on a CUDA card and on the CPU torch computes it natively.)"""
    probe = torch.ones(4, dtype=torch.float64, device=device)
    return probe.dtype == torch.float64 and float(probe @ probe) == 4.0


class DeviceNE:
    """Resident-factor device solver for M = A diag(d) A' + reg I.

    Usage per IPM iteration::

        diag = ne.factor(d)              # device GEMM + Cholesky
        dy, ok = ne.solve(rhs, matvec)   # to f64 accuracy
        if not ok: <exact host fallback>
    """

    def __init__(self, A: np.ndarray, use_f64: bool | None = None, *,
                 device=None):
        self.device = resolve_device(device, A)
        A = np.asarray(A.detach().cpu() if isinstance(A, torch.Tensor)
                       else A)
        self.m, self.n = A.shape
        self._A_host = A      # the caller's array, for a host diagonal
        self.A_dev = torch.as_tensor(np.asarray(A, np.float32),
                                     device=self.device)
        self._L = None
        self._s = None
        # telemetry (read by benches/tests): cumulative counts + seconds
        self.stats = {"factors": 0, "solves": 0, "cg_iters": 0,
                      "fallbacks": 0, "f64_direct": 0, "factor_s": 0.0,
                      "apply_s": 0.0, "matvec_s": 0.0, "fails": []}
        self.f64 = use_f64 is not False and _f64_works(self.device)
        self._A64 = self._M64 = self._L64 = None
        self._f64_error = None
        self._diag_scale = 1.0
        if self.f64:
            self._A64 = torch.as_tensor(np.asarray(A, np.float64),
                                        device=self.device)

    def _fail(self, best_res, rel_tol, **extra) -> None:
        self.stats["fallbacks"] += 1
        self.stats["fails"].append(
            {"best_res": float(best_res), "rel_tol": float(rel_tol),
             "solve_idx": self.stats["solves"], **extra})

    def factor(self, d: np.ndarray, ridge: float = 1e-7,
               max_tries: int = 4) -> np.ndarray:
        """Form (+ factor, on the f32 route) on the device; returns
        diag(A D A') as host f64.

        ``ridge`` is relative to the equilibrated unit diagonal; it biases
        only the preconditioner (CG removes it from the solution) but
        degrades it directly, so it starts a shade above eps_f32 and
        escalates 30x when the f32 Cholesky breaks down.  On the f64 route
        the factorisation waits for ``solve``, which knows the caller's
        exact shift; a torch error in the f64 form is recorded, the diagonal
        comes from the host, and the next solves report failure.
        """
        t0 = time.perf_counter()
        try:
            if self.f64:
                d64 = torch.as_tensor(np.asarray(d, np.float64),
                                      device=self.device)
                try:
                    M = torch.matmul(self._A64 * d64[None, :], self._A64.T)
                    out = torch.diagonal(M).cpu().numpy()
                    self._M64, self._L64, self._f64_error = M, None, None
                except RuntimeError as e:
                    self._M64 = self._L64 = None
                    self._f64_error = f"form: {e}"
                    A = self._A_host
                    out = np.einsum("mn,n,mn->m", A, np.asarray(d, np.float64),
                                    A)
                self._diag_scale = 1.0 + out.mean() + out.max()
                self.stats["factors"] += 1
                return out
            d32 = torch.as_tensor(np.asarray(d, np.float32),
                                  device=self.device)
            A_ = self.A_dev
            with full_f32_matmul():
                M = torch.matmul(A_ * d32[None, :], A_.T)
            diag = torch.diagonal(M)
            s = torch.rsqrt(torch.clamp(diag, min=1e-30))
            Ms = (s[:, None] * M) * s[None, :]
            eye = torch.eye(self.m, dtype=Ms.dtype, device=self.device)
            for _ in range(max_tries):
                L, info = torch.linalg.cholesky_ex(
                    Ms + np.float32(ridge) * eye)
                ok = bool((info == 0) & torch.isfinite(
                    torch.diagonal(L)).all())
                if ok:
                    self._L, self._s = L, s
                    self.stats["factors"] += 1
                    return diag.double().cpu().numpy()
                ridge *= 30.0
            self._L = None
            raise FloatingPointError(
                "device f32 Cholesky failed at max ridge")
        finally:
            self.stats["factor_s"] += time.perf_counter() - t0

    def apply(self, r: np.ndarray) -> np.ndarray:
        """One preconditioner application through the resident factor."""
        t0 = time.perf_counter()
        r32 = torch.as_tensor(np.asarray(r, np.float32), device=self.device)
        w = torch.cholesky_solve((self._s * r32)[:, None], self._L)[:, 0]
        out = (self._s * w).double().cpu().numpy()
        self.stats["apply_s"] += time.perf_counter() - t0
        return out

    def _solve_direct64(self, rhs: np.ndarray, matvec, rel_tol: float,
                        reg) -> tuple[np.ndarray, bool]:
        """Direct f64 device factor+solve (+1 exact-IR pass).

        Factors the resident f64 M with the caller's exact ``reg`` (a
        scalar, or one shift per row); on Cholesky breakdown the shift
        escalates 30x (relative to the diagonal scale) and the post-IR
        residual check decides whether the escalated factor still solved
        the exact system.  A torch error in the factor or the solves is a
        failed solve."""
        rhs = np.asarray(rhs, dtype=np.float64)
        rhs_norm = np.linalg.norm(rhs)
        if rhs_norm == 0.0:
            return np.zeros_like(rhs), True
        self.stats["solves"] += 1
        self.stats["f64_direct"] += 1
        if self._M64 is None:
            self._fail(np.inf, rel_tol, error=self._f64_error)
            return np.zeros_like(rhs), False
        try:
            if self._L64 is None:
                t0 = time.perf_counter()
                shift = torch.as_tensor(
                    np.broadcast_to(np.asarray(reg, np.float64),
                                    (self.m,)).copy(), device=self.device)
                ok = False
                for _ in range(5):
                    L, info = torch.linalg.cholesky_ex(
                        self._M64 + torch.diag(shift))
                    ok = bool((info == 0) & torch.isfinite(
                        torch.diagonal(L)).all())
                    if ok:
                        break
                    shift = torch.clamp(shift * 30.0,
                                        min=1e-14 * self._diag_scale)
                self.stats["factor_s"] += time.perf_counter() - t0
                if not ok:
                    self._fail(np.inf, rel_tol, f64_factor_breakdown=True)
                    return np.zeros_like(rhs), False
                self._L64 = L

            def solve64(r):
                t0 = time.perf_counter()
                rt = torch.as_tensor(r, device=self.device)[:, None]
                out = torch.cholesky_solve(rt, self._L64)[:, 0].cpu().numpy()
                self.stats["apply_s"] += time.perf_counter() - t0
                return out

            dy = solve64(rhs)
            t_mv = time.perf_counter()
            r = rhs - matvec(dy)
            self.stats["matvec_s"] += time.perf_counter() - t_mv
            dy = dy + solve64(r)
        except RuntimeError as e:
            self._fail(np.inf, rel_tol, error=f"direct f64: {e}")
            return np.zeros_like(rhs), False
        t_mv = time.perf_counter()
        res = float(np.linalg.norm(rhs - matvec(dy))) / rhs_norm
        self.stats["matvec_s"] += time.perf_counter() - t_mv
        ok = res <= rel_tol
        if not ok:
            self._fail(res, rel_tol)
        return dy, ok

    def solve(self, rhs: np.ndarray, matvec, rel_tol: float = 1e-11,
              max_iters: int = 30,
              reg=None) -> tuple[np.ndarray, bool]:
        """Solve the exact f64 system M dy = rhs: preconditioned CG through
        the resident f32 factor, or, on the f64 route (``self.f64``), a
        direct f64 device factor+solve (``reg`` supplies the exact shift the
        caller folded into ``matvec``, a scalar or one per row; without it
        the factor runs unshifted and the residual check decides).

        ``matvec(v)`` must be the EXACT f64 operator.  Returns
        ``(dy, converged)``; on stagnation the best iterate so far comes
        back with ``converged=False`` so the caller can fall back to the
        exact f64 host path.
        """
        if self.f64:
            return self._solve_direct64(rhs, matvec, rel_tol,
                                        0.0 if reg is None else reg)
        rhs = np.asarray(rhs, dtype=np.float64)
        rhs_norm = np.linalg.norm(rhs)
        if rhs_norm == 0.0:
            return np.zeros_like(rhs), True
        self.stats["solves"] += 1
        dy = np.zeros_like(rhs)
        r = rhs.copy()
        z = self.apply(r)
        p_dir = z
        rz = float(r @ z)
        best_dy, best_res = dy, 1.0
        stall = 0
        for _ in range(max_iters):
            self.stats["cg_iters"] += 1
            t_mv = time.perf_counter()
            q = matvec(p_dir)
            self.stats["matvec_s"] += time.perf_counter() - t_mv
            pq = float(p_dir @ q)
            if pq <= 0.0 or not np.isfinite(pq):   # lost SPD in fp
                break
            alpha = rz / pq
            dy = dy + alpha * p_dir
            r = r - alpha * q
            rn = float(np.linalg.norm(r)) / rhs_norm
            if rn < best_res:
                best_dy, best_res, stall = dy, rn, 0
            else:
                stall += 1
                if stall >= 3:
                    break
            if rn <= rel_tol:
                return dy, True
            z = self.apply(r)
            rz_new = float(r @ z)
            p_dir = z + (rz_new / rz) * p_dir
            rz = rz_new
        ok = best_res <= rel_tol
        if not ok:
            self._fail(best_res, rel_tol)
        return best_dy, ok
