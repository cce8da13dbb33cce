"""The port's IPM device stages against the JAX package's, on the CPU in
float64 (x64 on): the batched dense IPM, the device normal-equations
solver, the fleet barrier with its host endgame, the single-large-LP
barrier with its device endgame, the NE offload hook, and the IPM warm
engines of the fleet crossover, each also against HiGHS."""
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from smart_crossover_tpu.parallel.batched_lp import (
    batched_lp_crossover as j_crossover,
)
from smart_crossover_tpu.solvers import ipm_fleet as jfleet
from smart_crossover_tpu.solvers import ne_device as jne
from smart_crossover_tpu.solvers.ipm_batched import (
    ipm_dense as j_ipm_dense,
    ipm_dense_batched as j_ipm_batched,
)
from smart_crossover_tpu_torch import batched_lp_crossover
from smart_crossover_tpu_torch.interop import from_reference
from smart_crossover_tpu_torch.solvers import ipm_batched as tib
from smart_crossover_tpu_torch.solvers import ipm_fleet as tfleet
from smart_crossover_tpu_torch.solvers import ne_device as tne
from smart_crossover_tpu_torch.solvers import ne_offload

#: iterates of the two packages' float64 IPMs agree to summation order
TOL = 1e-8
KEYS = ("x", "y", "zl", "zu", "obj_val")


def make_lp(rng, m=6, n=16):
    """As tests/test_ipm_batched.py::make_lp."""
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    c = rng.standard_normal(n)
    return A, b, c, np.zeros(n), np.ones(n)


def make_fleet(rng, B, m, n):
    """As tests/test_ipm_fleet.py::make_fleet."""
    As = rng.standard_normal((B, m, n))
    xs = rng.uniform(0.2, 0.8, (B, n))
    bs = np.einsum("bmn,bn->bm", As, xs)
    cs = rng.standard_normal((B, n))
    return As, bs, cs, np.zeros((B, n)), np.ones((B, n))


def assert_same_ipm(got, want, tol=TOL):
    np.testing.assert_array_equal(got["iters"].numpy(),
                                  np.asarray(want["iters"]))
    np.testing.assert_array_equal(got["converged"].numpy(),
                                  np.asarray(want["converged"]))
    for k in KEYS:
        assert got[k].dtype == torch.float64
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("bounds", ["box", "one_sided"])
def test_ipm_dense_matches_jax(rng, bounds):
    """tests/test_ipm_batched.py's two single-instance LPs."""
    if bounds == "box":
        A, b, c, l, u = make_lp(rng)
        tol = 1e-9
    else:
        m, n = 5, 12
        A = rng.standard_normal((m, n))
        b = A @ rng.uniform(0.2, 0.8, n)
        c = A.T @ rng.standard_normal(m) + np.abs(rng.standard_normal(n)) \
            + 0.1
        l, u = np.zeros(n), np.full(n, np.inf)
        tol = 1e-8
    want = j_ipm_dense(A, b, c, l, u, tol=tol, max_iters=60)
    got = tib.ipm_dense(A, b, c, l, u, tol=tol, max_iters=60, device="cpu")
    assert_same_ipm(got, want)
    assert bool(got["converged"])
    ref = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(l, np.where(
        np.isinf(u), None, u))), method="highs")
    assert float(got["obj_val"]) == pytest.approx(ref.fun, abs=1e-6)


@pytest.mark.parametrize("mu_exit", [None, 1e-4])
def test_ipm_dense_batched_matches_jax(rng, mu_exit):
    """tests/test_ipm_batched.py's fleet (5 x 6 x 16): the same per-instance
    iteration counts and convergence flags, iterates within 1e-8; with
    mu_exit = 1e-4 (the fleet's hand-off) the instances stop at mu_exit,
    most of them unconverged."""
    B, m, n = 5, 6, 16
    As = np.stack([make_lp(rng, m, n)[0] for _ in range(B)])
    bs = np.einsum("bmn,bn->bm", As, rng.uniform(0.2, 0.8, (B, n)))
    cs = rng.standard_normal((B, n))
    ls, us = np.zeros((B, n)), np.ones((B, n))
    want = j_ipm_batched(As, bs, cs, ls, us, tol=1e-9, max_iters=60,
                         mu_exit=mu_exit)
    got = tib.ipm_dense_batched(As, bs, cs, ls, us, tol=1e-9, max_iters=60,
                                mu_exit=mu_exit, device="cpu")
    assert_same_ipm(got, want)
    if mu_exit is None:
        assert bool(got["converged"].all())
        for i in range(B):
            ref = linprog(cs[i], A_eq=As[i], b_eq=bs[i], bounds=(0, 1),
                          method="highs")
            assert float(got["obj_val"][i]) == pytest.approx(ref.fun,
                                                             abs=1e-6)
    else:
        assert int(got["converged"].sum()) < B


def test_cholesky_breakdown_matches_jax(rng):
    """An instance with l > u makes D negative, so A D A' is indefinite
    and the first Cholesky breaks down: JAX's cho_factor gives NaNs, the
    port sets the factor NaN on cholesky_ex's info.  The instance stops
    after one iteration, unconverged, with NaN iterates; its neighbours
    in the batch run on unharmed."""
    B, m, n = 3, 6, 16
    As, bs, cs, ls, us = make_fleet(rng, B, m, n)
    us[1] = -1.0
    want = j_ipm_batched(As, bs, cs, ls, us, tol=1e-9, max_iters=60)
    got = tib.ipm_dense_batched(As, bs, cs, ls, us, tol=1e-9, max_iters=60,
                                device="cpu")
    assert got["iters"].tolist() == np.asarray(want["iters"]).tolist()
    assert got["converged"].tolist() == [True, False, True]
    assert int(got["iters"][1]) == 1
    for k in KEYS:
        g, w = got[k].numpy(), np.asarray(want[k])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g[[0, 2]], w[[0, 2]], rtol=0, atol=TOL)
    assert np.isnan(got["x"][1].numpy()).all()


def test_full_f32_matmul_inside_and_restored(rng, monkeypatch):
    """The IPM runs its products without TF32 whatever the caller's
    setting, and gives the setting back."""
    seen = []
    chol = torch.linalg.cholesky_ex

    def spy(M, *a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return chol(M, *a, **k)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", spy)
    prev = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        A, b, c, l, u = make_fleet(rng, 2, 4, 10)
        tib.ipm_dense_batched(A, b, c, l, u, max_iters=3, device="cpu")
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(prev)


def test_ipm_dense_device_defaults_to_card():
    A = np.eye(2)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tib.ipm_dense_batched(A[None], np.ones((1, 2)), np.ones((1, 2)),
                              np.zeros((1, 2)), np.ones((1, 2)))


# ---- DeviceNE

def _ne_case(rng, m=40, n=120):
    A = rng.standard_normal((m, n))
    d = 10.0 ** rng.uniform(-6, 6, n)
    return A, d


def _counts(stats):
    return {k: v for k, v in stats.items() if not k.endswith("_s")}


@pytest.mark.parametrize("use_f64", [False, None])
def test_device_ne_matches_jax(rng, use_f64):
    """tests/test_ipm_fleet.py's ill-scaled system (d over 12 orders):
    the f32 factor + CG route (use_f64=False) and the direct f64 route
    (the default: the probe passes on the CPU in both packages) give the
    JAX DeviceNE's diagonal, solution and counts."""
    A, d = _ne_case(rng)
    j = jne.DeviceNE(A, use_f64=use_f64)
    t = tne.DeviceNE(A, use_f64=use_f64, device="cpu")
    assert t.f64 == j.f64 == (use_f64 is None)
    dj, dt = j.factor(d), t.factor(d)
    # f32 route: two float32 products in different summation orders
    np.testing.assert_allclose(dt, dj, rtol=1e-12 if t.f64 else 1e-6)
    reg = 1e-14 * (1.0 + dj.mean() + dj.max())
    M = (A * d) @ A.T + reg * np.eye(A.shape[0])
    rhs = rng.standard_normal(A.shape[0])
    yj, okj = j.solve(rhs, lambda v: M @ v, rel_tol=1e-10, reg=reg)
    yt, okt = t.solve(rhs, lambda v: M @ v, rel_tol=1e-10, reg=reg)
    assert okj and okt
    assert np.linalg.norm(rhs - M @ yt) <= 1e-10 * np.linalg.norm(rhs)
    np.testing.assert_allclose(yt, yj, rtol=0,
                               atol=1e-9 * np.abs(yj).max())
    assert _counts(t.stats) == _counts(j.stats)


def test_device_ne_f64_solve_error_is_a_fallback(rng, monkeypatch):
    """ROADMAP 3.2, repaired in the port: a torch error inside the f64
    route is a failed solve, counted, not an abort."""
    A, d = _ne_case(rng)
    t = tne.DeviceNE(A, device="cpu")
    diag = t.factor(d)
    reg = 1e-14 * (1.0 + diag.mean() + diag.max())

    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(torch, "cholesky_solve", boom)
    rhs = rng.standard_normal(A.shape[0])
    dy, ok = t.solve(rhs, lambda v: v, reg=reg)
    assert not ok and not dy.any()
    assert t.stats["fallbacks"] == 1
    assert "device fault" in t.stats["fails"][0]["error"]


def test_device_ne_f64_form_error_is_a_fallback(rng, monkeypatch):
    """A torch error in the f64 form: the diagonal comes from the host and
    every solve at that d reports failure."""
    A, d = _ne_case(rng)
    t = tne.DeviceNE(A, device="cpu")

    def boom(*a, **k):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(torch, "matmul", boom)
    diag = t.factor(d)
    monkeypatch.undo()
    np.testing.assert_allclose(diag, np.einsum("mn,n,mn->m", A, d, A),
                               rtol=1e-12)
    dy, ok = t.solve(rng.standard_normal(A.shape[0]), lambda v: v)
    assert not ok and t.stats["fallbacks"] == 1
    assert "out of memory" in t.stats["fails"][0]["error"]


# ---- fleet barrier

def test_ipm_fleet_matches_jax_and_highs(rng):
    """tests/test_ipm_fleet.py's fleet (6 x 8 x 20): the same device and
    endgame iterations per instance, all OPTIMAL, vertices within 1e-8 of
    the JAX package's and objectives of HiGHS's."""
    B, m, n = 6, 8, 20
    As, bs, cs, ls, us = make_fleet(rng, B, m, n)
    want = jfleet.ipm_fleet(As, bs, cs, ls, us, tol=1e-8)
    got = tfleet.ipm_fleet(As, bs, cs, ls, us, tol=1e-8, device="cpu")
    assert got.status == want.status == ["OPTIMAL"] * B
    np.testing.assert_array_equal(got.device_iters, want.device_iters)
    np.testing.assert_array_equal(got.refine_iters, want.refine_iters)
    np.testing.assert_array_equal(got.device_converged,
                                  want.device_converged)
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.y, want.y, rtol=0, atol=TOL)
    for i in range(B):
        ref = linprog(cs[i], A_eq=As[i], b_eq=bs[i], bounds=(0, 1),
                      method="highs")
        assert got.obj[i] == pytest.approx(ref.fun, abs=1e-7)
        assert np.abs(As[i] @ got.x[i] - bs[i]).max() < 1e-8


def test_ipm_fleet_device_only_matches_jax(rng):
    As, bs, cs, ls, us = make_fleet(rng, 3, 6, 16)
    kw = dict(refine=False, device_tol=1e-9, max_device_iters=60)
    want = jfleet.ipm_fleet(As, bs, cs, ls, us, **kw)
    got = tfleet.ipm_fleet(As, bs, cs, ls, us, device="cpu", **kw)
    assert got.status == ["DEVICE_ONLY"] * 3 and got.device_converged.all()
    np.testing.assert_array_equal(got.device_iters, want.device_iters)
    np.testing.assert_allclose(got.obj, want.obj, rtol=0, atol=TOL)


def test_ipm_fleet_refuses_a_mesh(rng):
    """``mesh=`` no longer raises: on a one-rank CPU mesh ipm_fleet and
    ipm_big give the unsharded calls' results (the multi-rank meshes are
    held to JAX in tests/test_torch_sharded.py)."""
    import torch.distributed as dist

    from smart_crossover_tpu_torch.parallel import make_mesh

    As, bs, cs, ls, us = make_fleet(rng, 2, 3, 6)
    started = not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    try:
        got = tfleet.ipm_fleet(As, bs, cs, ls, us, mesh=mesh)
        big = tfleet.ipm_big(As[0], bs[0], cs[0], ls[0], us[0], mesh=mesh)
    finally:
        if started:
            dist.destroy_process_group()
    want = tfleet.ipm_fleet(As, bs, cs, ls, us, device="cpu")
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.device_iters, want.device_iters)
    assert got.status == want.status
    want = tfleet.ipm_big(As[0], bs[0], cs[0], ls[0], us[0], device="cpu")
    np.testing.assert_array_equal(big.x, want.x)
    assert big.status == want.status


def test_endgame_from_jax_device_iterate(rng):
    """The JAX package's device iterate (x, y, zl, zu at the fleet's
    mu_exit) handed through ``interop.from_reference`` to the port's host
    endgame gives the JAX endgame's result."""
    As, bs, cs, ls, us = make_fleet(rng, 4, 8, 20)
    dev = j_ipm_batched(As, bs, cs, ls, us, tol=1e-5, max_iters=60,
                        mu_exit=1e-4)
    st = from_reference(**{k: np.asarray(dev[k]) for k in
                           ("x", "y", "zl", "zu")})
    args = (As, bs, cs, ls, us)
    want = jfleet.ipm_endgame_batched(*args, *(np.asarray(dev[k]) for k in
                                               ("x", "y", "zl", "zu")))
    got = tfleet.ipm_endgame_batched(*args, *(st[k].numpy() for k in
                                              ("x", "y", "zl", "zu")))
    assert got[4].all() and want[4].all()
    np.testing.assert_array_equal(got[5], want[5])
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def test_ipm_big_matches_jax(rng):
    """tests/test_ipm_fleet.py's single large LP (60 x 150), exact host
    endgame (the device endgame's auto rule needs a card)."""
    m, n = 60, 150
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    c = rng.standard_normal(n)
    args = (A, b, c, np.zeros(n), np.ones(n))
    want = jfleet.ipm_big(*args, tol=1e-8)
    got = tfleet.ipm_big(*args, tol=1e-8, device="cpu")
    assert tfleet.last_ne_stats is None
    assert got.status == want.status == "OPTIMAL"
    assert (got.device_iters, got.endgame_iters) == \
        (want.device_iters, want.endgame_iters)
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=TOL)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, 1), method="highs")
    assert got.obj_val == pytest.approx(ref.fun, abs=1e-7)


@pytest.mark.parametrize("use_f64", [None, False])
def test_ipm_big_device_endgame_matches_jax(rng, monkeypatch, use_f64):
    """SCX_DEVICE_ENDGAME=1 (80 x 220): the device normal equations carry
    every endgame solve (the exact host path's ``_bmm`` is never called, as
    tests/test_ipm_fleet.py:74-98 checks), on the default f64 route and on
    the f32 + CG route, with the JAX package's iterations and counts."""
    monkeypatch.setenv("SCX_DEVICE_ENDGAME", "1")

    def no_exact(*a, **k):
        raise AssertionError("exact host NE path reached")

    monkeypatch.setattr(tfleet, "_bmm", no_exact)
    monkeypatch.setattr(jfleet, "_bmm", no_exact)
    if use_f64 is False:
        j_cls, t_cls = jne.DeviceNE, tne.DeviceNE
        monkeypatch.setattr(jne, "DeviceNE",
                            lambda A: j_cls(A, use_f64=False))
        monkeypatch.setattr(tne, "DeviceNE",
                            lambda A, **kw: t_cls(A, use_f64=False, **kw))
    m, n = 80, 220
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    c = rng.standard_normal(n)
    args = (A, b, c, np.zeros(n), np.ones(n))
    want = jfleet.ipm_big(*args, tol=1e-8)
    j_stats = jfleet.last_ne_stats
    got = tfleet.ipm_big(*args, tol=1e-8, device="cpu")
    t_stats = tfleet.last_ne_stats
    assert got.status == want.status == "OPTIMAL"
    assert (got.device_iters, got.endgame_iters) == \
        (want.device_iters, want.endgame_iters)
    assert t_stats["factors"] > 0 and t_stats["fallbacks"] == 0
    assert (t_stats["f64_direct"] > 0) == (use_f64 is None)
    if use_f64 is False:
        # CG on two float32 factors summed in different orders: the
        # iteration counts may differ by a few
        assert abs(t_stats.pop("cg_iters") - j_stats.pop("cg_iters")) <= 3
    assert _counts(t_stats) == _counts(j_stats)
    np.testing.assert_allclose(got.x, want.x, rtol=0,
                               atol=TOL if use_f64 is None else 1e-7)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, 1), method="highs")
    assert got.obj_val == pytest.approx(ref.fun, abs=1e-7)
    assert np.abs(A @ got.x - b).max() < 1e-8


def test_ipm_big_device_fault_takes_exact_path(rng, monkeypatch):
    """With every f64 device solve raising, the endgame counts each as a
    fallback, solves on the host, and still reaches OPTIMAL."""
    monkeypatch.setenv("SCX_DEVICE_ENDGAME", "1")
    real = torch.cholesky_solve

    def boom(*a, **k):
        raise RuntimeError("device fault")

    m, n = 60, 150
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    c = rng.standard_normal(n)
    args = (A, b, c, np.zeros(n), np.ones(n))

    class FaultyNE(tne.DeviceNE):
        def _solve_direct64(self, *a, **k):
            torch.cholesky_solve = boom
            try:
                return super()._solve_direct64(*a, **k)
            finally:
                torch.cholesky_solve = real

    monkeypatch.setattr(tne, "DeviceNE", FaultyNE)
    got = tfleet.ipm_big(*args, tol=1e-8, device="cpu")
    stats = tfleet.last_ne_stats
    assert got.status == "OPTIMAL"
    assert stats["fallbacks"] == stats["f64_direct"] > 0
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, 1), method="highs")
    assert got.obj_val == pytest.approx(ref.fun, abs=1e-7)



def test_endgame_corrector_miss_keeps_device_direction():
    """ROADMAP 3.13: on the f64 route, a centrality corrector whose device
    solve misses its tolerance keeps its direction instead of forming
    A D A' on the host.  As on a card: the float32 device stage (ipm_big's
    arguments) on a staircase LP with free columns and infinite upper
    bounds, then the f64 endgame with a DeviceNE on the CPU, whose every
    solve after an iteration's predictor and corrector (the Gondzio
    correctors) is made to miss with its direction off by 1% of its norm.
    Each miss counts as a fallback, no iteration forms A D A' on the host,
    and the endgame still converges with a host f64 certificate on the
    true bounds within 1e-8 and HiGHS's objective to 1e-7."""
    from smart_crossover_tpu_torch.bench_ipm_stair import (
        certificate_ok,
        highs,
        lp_certificate,
    )
    from smart_crossover_tpu_torch.data.lp_gen import staircase_lp

    noise = np.random.default_rng(1)
    missed = []

    class MissingNE(tne.DeviceNE):
        def factor(self, *a, **k):
            self.since_factor = 0
            return super().factor(*a, **k)

        def solve(self, rhs, matvec, rel_tol=1e-11, **k):
            self.since_factor += 1
            if self.since_factor <= 2:
                return super().solve(rhs, matvec, rel_tol, **k)
            dy, _ = super().solve(rhs, matvec, 0.0, **k)
            missed.append(self.stats["fails"][-1]["best_res"])
            e = noise.standard_normal(dy.shape)
            return dy + 1e-2 * np.linalg.norm(dy) * e / np.linalg.norm(e), \
                False

    lp = staircase_lp(periods=4, rows_per_period=40, vars_per_period=120,
                      seed=1)
    A_sp = lp.get_standard_A()
    A, b, c = A_sp.toarray(), lp.b, lp.get_standard_c()
    l, u = lp.get_standard_bounds()
    assert (~np.isfinite(l) & ~np.isfinite(u)).any() and np.isinf(u).any()

    def f32(v):
        return torch.as_tensor(np.asarray(v)[None], dtype=torch.float32)

    out = tib.ipm_dense_batched(f32(A), f32(b), f32(c), f32(l), f32(u),
                                tol=1e-5, max_iters=60, mu_exit=1e-4,
                                device="cpu")
    dev = {k: out[k].double().numpy() for k in ("x", "y", "zl", "zu")}
    ne = MissingNE(A, device="cpu")
    assert ne.f64
    x, y, _, _, conv, _ = tfleet.ipm_endgame_batched(
        A[None], b[None], c[None], l[None], u[None], dev["x"], dev["y"],
        dev["zl"], dev["zu"], tol=1e-8, max_iters=30, ne_device=ne)
    assert missed and np.isfinite(missed).all()
    assert ne.stats["fallbacks"] == len(missed)
    assert tfleet.last_host_forms == 0
    assert bool(conv[0])
    cert = lp_certificate(A_sp, b, c, l, u, x[0], y[0])
    assert certificate_ok(cert), cert
    ref = highs(A_sp, b, c, l, u)["obj"]
    assert abs(c @ x[0] - ref) <= 1e-7 * (1 + abs(ref))

# ---- NE offload

def test_maybe_device_ne_none_when_off(rng, monkeypatch):
    """None without a card, without SCX_NE_OFFLOAD=1, or outside the size
    band; with all three, a device error raises (no silent host run)."""
    import scipy.sparse as sp

    A = sp.random(1200, 2000, density=0.01, random_state=0, format="csr")
    monkeypatch.setenv("SCX_NE_OFFLOAD", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ne_offload.maybe_device_ne(A) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("SCX_NE_OFFLOAD")
    assert ne_offload.maybe_device_ne(A) is None
    monkeypatch.setenv("SCX_NE_OFFLOAD", "1")
    for shape in ((1000, 2000), (5000, 2000), (4000, 140_000)):
        small = sp.csr_matrix(shape)
        assert ne_offload.maybe_device_ne(small) is None

    def fault(*a, **k):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(ne_offload, "resolve_device", fault)
    with pytest.raises(RuntimeError, match="out of memory"):
        ne_offload.maybe_device_ne(A)


def test_ne_offload_hook_in_ipm(monkeypatch):
    """The host IPM forms its normal equations through the offload while
    mu > 1e-6 (here a CPU DeviceNE stands in for the card's), and ends at
    the host IPM's solution; the product is float64."""
    from smart_crossover_tpu_torch.data import random_sparse_lp
    from smart_crossover_tpu_torch.solvers.ipm import ipm_general_lp

    lp = random_sparse_lp(m=60, n=240, seed=2)
    plain = ipm_general_lp(lp)
    made = []

    def on_cpu(A):
        made.append(ne_offload.DeviceNE(A, device="cpu"))
        return made[-1]

    monkeypatch.setattr(ne_offload, "maybe_device_ne", on_cpu)
    off = ipm_general_lp(lp)
    assert made and made[0].forms > 0
    assert off.status == plain.status == "OPTIMAL"
    assert off.obj_val == pytest.approx(plain.obj_val, rel=0, abs=1e-8)
    assert made[0]._A.dtype == torch.float64
    A = made[0]._A.numpy()
    d = np.linspace(0.1, 2.0, A.shape[1])
    np.testing.assert_allclose(made[0].form(d), (A * d) @ A.T, rtol=1e-12,
                               atol=1e-12)


def test_ne_offload_float64_reaches_host_optimum(monkeypatch):
    """ROADMAP 3.10: at m = 1030 (inside the offload's size band) the JAX
    package's float32 product stalls the host IPM far from the optimum
    (STALLED at 14 iterations on the CPU); the port's float64 product
    reaches the host IPM's optimum."""
    from smart_crossover_tpu_torch.data import random_sparse_lp
    from smart_crossover_tpu_torch.solvers.ipm import ipm_solve

    lp = random_sparse_lp(m=1030, n=4120, seed=2)
    args = (lp.get_standard_A(), lp.b, lp.get_standard_c(),
            *lp.get_standard_bounds())
    host = ipm_solve(*args, tol=1e-8)
    made = []

    def on_cpu(A):
        made.append(ne_offload.DeviceNE(A, device="cpu"))
        return made[-1]

    monkeypatch.setattr(ne_offload, "maybe_device_ne", on_cpu)
    off = ipm_solve(*args, tol=1e-8)
    assert made[0].forms > 0
    assert off.status == host.status == "OPTIMAL"
    assert off.obj_val == pytest.approx(host.obj_val, rel=1e-10, abs=1e-8)


def test_ne_offload_float32_product_stalls(monkeypatch):
    """ROADMAP 3.10 kept reproducible: the same LP with the offload's
    product patched to the JAX package's float32 GEMM stalls the host IPM
    short of the optimum, the reason the port forms M in float64."""
    from smart_crossover_tpu_torch.data import random_sparse_lp
    from smart_crossover_tpu_torch.solvers.ipm import ipm_solve

    lp = random_sparse_lp(m=1030, n=4120, seed=2)
    args = (lp.get_standard_A(), lp.b, lp.get_standard_c(),
            *lp.get_standard_bounds())
    made = []

    def form32(self, d):
        A32 = self._A.float()
        d32 = torch.as_tensor(np.asarray(d, np.float32))
        self.forms += 1
        return torch.matmul(A32 * d32[None, :], A32.T).double().numpy()

    def on_cpu(A):
        made.append(ne_offload.DeviceNE(A, device="cpu"))
        return made[-1]

    monkeypatch.setattr(ne_offload.DeviceNE, "form", form32)
    monkeypatch.setattr(ne_offload, "maybe_device_ne", on_cpu)
    off = ipm_solve(*args, tol=1e-8)
    assert made[0].forms > 0
    assert off.status == "STALLED"


# ---- the fleet crossover's IPM warm engines

@pytest.mark.parametrize("engine", ["ipm", "ipm_refined"])
def test_batched_lp_crossover_ipm_matches_jax_and_highs(rng, engine):
    """warm_engine 'ipm' and 'ipm_refined' at 4 x 10 x 40: the JAX
    package's warm starts (1e-8) and vertices, every instance optimal and
    equal to HiGHS to 1e-8."""
    B, m, n = 4, 10, 40
    A, b, c, l, u = make_fleet(rng, B, m, n)
    want = j_crossover(A, b, c, l, u, warm_engine=engine)
    got = batched_lp_crossover(A, b, c, l, u, warm_engine=engine,
                               device="cpu")
    assert got["optimal"].all() and np.asarray(want["optimal"]).all()
    np.testing.assert_array_equal(got["ipm_converged"],
                                  np.asarray(want["ipm_converged"]))
    np.testing.assert_allclose(got["x_bar"], want["x_bar"], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=TOL)
    np.testing.assert_array_equal(got["pivots"], want["pivots"])
    for i in range(B):
        ref = linprog(c[i], A_eq=A[i], b_eq=b[i], bounds=(0, 1),
                      method="highs")
        assert got["obj"][i] == pytest.approx(ref.fun, abs=1e-8)


def test_batched_lp_crossover_jax_positional_order(rng):
    """The JAX signature: (A, b, c, l, u, tol, max_ipm_iters, warm_engine,
    pdhg_iters), default engine 'ipm'."""
    A, b, c, l, u = make_fleet(rng, 2, 6, 20)
    default = batched_lp_crossover(A, b, c, l, u, device="cpu")
    positional = batched_lp_crossover(A, b, c, l, u, 1e-8, 60, "ipm", 10,
                                      device="cpu")
    want = j_crossover(A, b, c, l, u, 1e-8, 60, "ipm", 10)
    for out in (default, positional):
        np.testing.assert_allclose(out["x_bar"], want["x_bar"], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(out["obj"], want["obj"], rtol=0,
                                   atol=TOL)
    with pytest.raises(ValueError, match="warm_engine"):
        batched_lp_crossover(A, b, c, l, u, warm_engine="ipx", device="cpu")
