"""The benchmark's frozen generators equal the port's at small sizes,
and the DOTmark-style generator keeps to its class's rules."""
import numpy as np
import pytest

from benchmark.gen import digits, dotmark
from benchmark.gen.goto import goto_like
from benchmark.gen.seeds import item_seeds


@pytest.mark.parametrize("num,side,seed", [(4, 28, 42), (6, 28, 2**40 + 3),
                                           (2, 10, 7)])
def test_digit_pairs_equal_the_ports(num, side, seed):
    from smart_crossover_tpu_torch.data import ot_gen

    imgs = digits.synthetic_digits(2 * num, side, seed)
    np.testing.assert_array_equal(
        imgs, ot_gen.synthetic_digits(2 * num, side, seed))
    for i, (s, d, M) in enumerate(digits.pairs(num, seed, side)):
        ot = ot_gen.images_to_ot(imgs[2 * i], imgs[2 * i + 1])
        np.testing.assert_array_equal(s, ot.s)
        np.testing.assert_array_equal(d, ot.d)
        np.testing.assert_array_equal(M, ot.M)
        assert M.shape == (np.count_nonzero(imgs[2 * i]),
                           np.count_nonzero(imgs[2 * i + 1]))


def test_dotmark_white_noise_and_cost():
    s, d = dotmark.white_noise(3, 4, seed=2**31 + 1)
    assert s.shape == d.shape == (3, 16) and (s > 0).all() and (d > 0).all()
    np.testing.assert_allclose(s.sum(1), 1.0, rtol=1e-15)
    np.testing.assert_allclose(d.sum(1), 1.0, rtol=1e-15)
    a, b = dotmark.white_noise(3, 4, seed=2**31 + 1)
    assert np.array_equal(a, s) and np.array_equal(b, d)
    M = dotmark.cost(4)
    assert M.shape == (16, 16) and M[0, 15] == 18 and M[5, 6] == 1
    np.testing.assert_array_equal(M, M.T)


@pytest.mark.parametrize("w,h,regular,seed", [(12, 10, True, 3),
                                              (12, 10, False, 3),
                                              (18, 18, True, 2**40 + 1)])
def test_goto_like_equals_the_ports(w, h, regular, seed):
    from smart_crossover_tpu_torch.data.mcf_gen import goto_like_mcf

    a = goto_like(w, h, extra_arc_factor=4, seed=seed, regular=regular)
    b = goto_like_mcf(w, h, extra_arc_factor=4, seed=seed, regular=regular)
    for k in ("tails", "heads", "c", "u", "b"):
        np.testing.assert_array_equal(a[k], getattr(b, k))


def test_item_seeds_take_any_whole_number():
    assert item_seeds(5, 3) == item_seeds(5, 3)
    assert item_seeds(5, 3) != item_seeds(6, 3)
    for seed in (-1, 0, 2**31 + 7, 2**70):
        s = item_seeds(seed, 4)
        assert len(set(s)) == 4 and all(0 <= v < 2**64 for v in s)
