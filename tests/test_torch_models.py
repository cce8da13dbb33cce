"""The port's host copies of the problem formats, result types, timer,
settings and MCF generators against the JAX package's originals (CPU):
equal arrays, bit for bit."""
import dataclasses

import numpy as np
import pytest

from smart_crossover_tpu.data import mcf_gen as j_gen
from smart_crossover_tpu.models import Basis as JBasis
from smart_crossover_tpu.models import MinCostFlow as JMinCostFlow
from smart_crossover_tpu.models import OptTransport as JOptTransport
from smart_crossover_tpu.solvers.settings import SolverSettings as JSettings
from smart_crossover_tpu_torch import (
    Basis,
    MinCostFlow,
    OptTransport,
    Output,
    SolverSettings,
)
from smart_crossover_tpu_torch.data import mcf_gen
from smart_crossover_tpu_torch.interop import instance_from_reference
from smart_crossover_tpu_torch.models.output import VBASIS_AT_UPPER
from smart_crossover_tpu_torch.utils.timer import Timer


def _same_mcf(a, b):
    for f in ("tails", "heads", "c", "u", "b"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.name == b.name
    A, jA = a.A, b.A
    assert A.shape == jA.shape
    assert (A != jA).nnz == 0


def _ot(seed, ns, nd):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, ns)
    d = rng.uniform(0.5, 2.0, nd)
    d *= s.sum() / d.sum()
    return s, d, rng.uniform(0.0, 5.0, (ns, nd))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("regular", [False, True])
def test_goto_like_mcf_matches_jax(seed, regular):
    kw = dict(width=8, height=6, extra_arc_factor=3, seed=seed,
              regular=regular)
    _same_mcf(mcf_gen.goto_like_mcf(**kw), j_gen.goto_like_mcf(**kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transshipment_mcf_matches_jax(seed):
    kw = dict(m=40, arcs_per_node=5, num_terminals=8, seed=seed)
    _same_mcf(mcf_gen.transshipment_mcf(**kw), j_gen.transshipment_mcf(**kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ot_to_mcf_matches_jax(seed):
    s, d, M = _ot(seed, 7, 9)
    ot, jot = OptTransport(s, d, M), JOptTransport(s, d, M)
    assert (ot.m, ot.n) == (jot.m, jot.n) == (16, 63)
    _same_mcf(ot.to_MCF(), jot.to_MCF())
    _same_mcf(ot.to_MCF().copy(), jot.to_MCF().copy())


def test_formats_validate_as_jax():
    s, d, M = _ot(3, 4, 5)
    for cls in (OptTransport, JOptTransport):
        with pytest.raises(ValueError, match="Total supply"):
            cls(s, d * 2, M)
        with pytest.raises(ValueError, match="shape"):
            cls(s, d, M[:, :4])
    for cls in (MinCostFlow, JMinCostFlow):
        with pytest.raises(ValueError, match="sum"):
            cls(tails=[0], heads=[1], c=[1.0], u=[1.0], b=[1.0, 1.0])


def test_from_incidence_matches_jax():
    mcf = mcf_gen.transshipment_mcf(m=30, seed=5)
    _same_mcf(MinCostFlow.from_incidence(mcf.A, mcf.b, mcf.c, mcf.u),
              JMinCostFlow.from_incidence(mcf.A, mcf.b, mcf.c, mcf.u))


def test_basis_output_settings_timer():
    b = Basis([0, -1, -2], [0.0, -1.0])
    jb = JBasis([0, -1, -2], [0.0, -1.0])
    np.testing.assert_array_equal(b.vbasis, jb.vbasis)
    assert b.vbasis.dtype == jb.vbasis.dtype == np.int32
    assert b.num_basic == jb.num_basic == 2
    assert b.vbasis[2] == VBASIS_AT_UPPER
    assert "status=OPTIMAL" in str(Output(status="OPTIMAL", obj_val=1.0))
    assert dataclasses.asdict(SolverSettings()) == \
        dataclasses.asdict(JSettings())
    t = Timer()
    with t:
        pass
    t.accumulate(1.5)
    assert 1.5 <= t.seconds < 2.0


def test_instance_from_reference():
    """The JAX package's instances carried across by their fields."""
    s, d, M = _ot(4, 3, 4)
    jot = JOptTransport(s, d, M, name="x")
    ot = instance_from_reference(jot)
    assert isinstance(ot, OptTransport) and ot.name == "x"
    np.testing.assert_array_equal(ot.M, jot.M)
    mcf = instance_from_reference(jot.to_MCF())
    assert isinstance(mcf, MinCostFlow)
    _same_mcf(mcf, jot.to_MCF())
    basis = instance_from_reference(JBasis([0, -1], [-1, 0]))
    assert isinstance(basis, Basis)
    np.testing.assert_array_equal(basis.cbasis, [-1, 0])
    with pytest.raises(TypeError, match="not an OptTransport"):
        instance_from_reference(object())
