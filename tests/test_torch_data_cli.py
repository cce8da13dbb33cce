"""The port's instance files, loader and CLI.

Files the port writes (.mps, .lp, .min) must read back to the same arrays
in both packages' readers; the port's loader refuses a pickle of a JAX
package class (its import would load jax) and reads the dict payload;
``python -m smart_crossover_tpu_torch`` solves an .mps file to HiGHS's
objective, and its unported routes exit non-zero naming their ROADMAP
item.
"""
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.optimize import linprog

from smart_crossover_tpu.data import dimacs as J_dimacs
from smart_crossover_tpu.data import lp_format as J_lpf
from smart_crossover_tpu.data import mps as J_mps
from smart_crossover_tpu.data.lp_gen import random_sparse_lp as j_random_lp
from smart_crossover_tpu.data.mcf_gen import transshipment_mcf
from smart_crossover_tpu.models import GeneralLP as J_GeneralLP
from smart_crossover_tpu.models import OptTransport as J_OT
from smart_crossover_tpu_torch import data as P_data
from smart_crossover_tpu_torch import interop
from smart_crossover_tpu_torch.models import GeneralLP, MinCostFlow

REPO = Path(__file__).resolve().parents[1]


def same_lp(a, b):
    assert a.m == b.m and a.n == b.n
    np.testing.assert_array_equal(sp.csr_matrix(a.A).toarray(),
                                  sp.csr_matrix(b.A).toarray())
    for f in ("b", "c", "l", "u", "sense"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.obj_offset == b.obj_offset


def mixed_lp():
    """An LP with '=' and '<' rows, a free, a one-sided and boxed columns
    and an objective offset."""
    lp = P_data.random_sparse_lp(m=12, n=30, seed=4)
    lp.l[0], lp.u[0] = -np.inf, np.inf
    lp.l[1] = -2.5
    lp.obj_offset = 1.25
    return lp


def test_random_sparse_lp_matches_jax():
    a, b = j_random_lp(m=30, n=90, seed=8), P_data.random_sparse_lp(
        m=30, n=90, seed=8)
    same_lp(a, b)


@pytest.mark.parametrize("fmt", ["mps", "lp"])
def test_lp_file_roundtrip(tmp_path, fmt):
    lp = mixed_lp()
    path = tmp_path / f"x.{fmt}"
    write = P_data.write_mps if fmt == "mps" else P_data.write_lp
    write(lp, path)
    read_j = J_mps.read_mps if fmt == "mps" else J_lpf.read_lp
    read_p = P_data.read_mps if fmt == "mps" else P_data.read_lp
    a, b = read_j(path), read_p(path)
    same_lp(a, b)
    np.testing.assert_allclose(sp.csr_matrix(b.A).toarray(),
                               sp.csr_matrix(lp.A).toarray(), rtol=1e-15)
    loaded = P_data.load_instance(path)
    assert isinstance(loaded, GeneralLP)
    same_lp(loaded, b)


def test_min_file_roundtrip(tmp_path):
    mcf = interop.instance_from_reference(transshipment_mcf(m=25, seed=3))
    path = tmp_path / "x.min"
    P_data.write_dimacs_min(mcf, path)
    a, b = J_dimacs.read_dimacs_min(path), P_data.read_dimacs_min(path)
    for f in ("tails", "heads", "c", "u", "b"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(getattr(b, f), getattr(mcf, f))
    assert isinstance(P_data.load_instance(path), MinCostFlow)


def test_load_instance_refuses_jax_pickles(tmp_path):
    rng = np.random.default_rng(0)
    ot = J_OT(s=np.ones(3), d=np.ones(3), M=rng.uniform(0, 1, (3, 3)))
    path = tmp_path / "jax.ot"
    path.write_bytes(pickle.dumps(ot))
    with pytest.raises(pickle.UnpicklingError,
                       match="dict payload.*instance_from_reference"):
        P_data.load_instance(path)
    # the dict payload both packages read
    path.write_bytes(pickle.dumps({"s": ot.s, "d": ot.d, "M": ot.M}))
    got = P_data.load_instance(path)
    assert type(got).__module__.startswith("smart_crossover_tpu_torch.")
    np.testing.assert_array_equal(got.M, ot.M)
    # and the port's own pickles
    P_data.save_instance(got, tmp_path / "port.ot")
    np.testing.assert_array_equal(
        P_data.load_instance(tmp_path / "port.ot").M, ot.M)


def test_instance_from_reference_general_lp():
    lp_j = J_GeneralLP(A=sp.csr_matrix(np.array([[1.0, 2.0], [0.0, 1.0]])),
                       b=np.array([3.0, 1.0]), c=np.array([1.0, -1.0]),
                       l=np.array([0.0, -np.inf]), u=np.array([4.0, np.inf]),
                       sense=np.array(["=", "<"]), name="two",
                       obj_offset=0.5, col_names=["x", "y"])
    lp_p = interop.instance_from_reference(lp_j)
    assert isinstance(lp_p, GeneralLP) and sp.issparse(lp_p.A)
    assert lp_p.A is not lp_j.A
    same_lp(lp_j, lp_p)
    assert lp_p.name == "two" and lp_p.col_names == ["x", "y"]


# ------------------------------------------------------------------- CLI
def cli(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "smart_crossover_tpu_torch", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout)


def highs_fun(lp):
    A = sp.csr_matrix(lp.A)
    eq = lp.sense == "="
    res = linprog(lp.c, A_eq=A[eq], b_eq=lp.b[eq], A_ub=A[~eq],
                  b_ub=lp.b[~eq],
                  bounds=[(lo if np.isfinite(lo) else None,
                           up if np.isfinite(up) else None)
                          for lo, up in zip(lp.l, lp.u)], method="highs")
    assert res.status == 0
    return res.fun + lp.obj_offset


def test_cli_solve_barrier_perturb(tmp_path):
    path = tmp_path / "f.mps"
    P_data.write_mps(P_data.random_sparse_lp(m=30, n=100, seed=3), path)
    r = cli("solve", str(path), "--method", "barrier_perturb",
            "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "status=OPTIMAL" in r.stdout
    obj = float(re.search(r"obj_val=(\S+),", r.stdout).group(1))
    ref = highs_fun(P_data.read_mps(path))
    assert obj == pytest.approx(ref, rel=1e-8)


def test_cli_crossover_ot_and_unported_routes(tmp_path):
    rng = np.random.default_rng(1)
    s = rng.uniform(0.5, 2, 6)
    d = rng.uniform(0.5, 2, 7)
    d *= s.sum() / d.sum()
    P_data.save_instance({"s": s, "d": d, "M": rng.uniform(0, 5, (6, 7))},
                         tmp_path / "f.ot")
    r = cli("crossover", str(tmp_path / "f.ot"), "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "status=OPTIMAL" in r.stdout
    # the MCF crossover: the sparse first-order warm start, then CNET_MCF
    mcf = transshipment_mcf(m=20, seed=0)
    P_data.write_dimacs_min(interop.instance_from_reference(mcf),
                            tmp_path / "f.min")
    r = cli("crossover", str(tmp_path / "f.min"), "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "status=OPTIMAL" in r.stdout
    obj = float(re.search(r"obj_val=(\S+),", r.stdout).group(1))
    ref = linprog(mcf.c, A_eq=mcf.A, b_eq=mcf.b,
                  bounds=np.stack([np.zeros(mcf.n), mcf.u], 1),
                  method="highs").fun
    assert obj == pytest.approx(ref, rel=1e-8)
    r = cli("bench")
    assert r.returncode != 0 and "1.0e" in r.stderr
    assert r.stdout == ""
