"""Transport batches on a pixel grid for the tests of the exact OT route,
built with numpy from a seed (no JAX): DOTmark-like white noise, every
mass positive, and the port's stand-in digits with their blank pixels
kept as zero masses."""
import numpy as np

from smart_crossover_tpu_torch.data.ot_gen import (
    grid_l1_cost,
    synthetic_digits,
)


def dotmark(B, side, seed):
    """DOTmark-like pairs: white-noise images of side x side pixels, mass 1
    each, squared Euclidean cost on the grid."""
    rng = np.random.default_rng(seed)
    n = side * side
    s = rng.uniform(0.0, 1.0, (B, n))
    d = rng.uniform(0.0, 1.0, (B, n))
    r, c = np.divmod(np.arange(n), side)
    C = ((r[:, None] - r[None, :]) ** 2 + (c[:, None] - c[None, :]) ** 2)
    M = np.broadcast_to(C.astype(np.float64), (B, n, n)).copy()
    return s / s.sum(1, keepdims=True), d / d.sum(1, keepdims=True), M


def digit_grid(B, side, seed, blobs):
    """B pairs of the port's stand-in digits on the whole side x side
    grid, blank pixels kept as zero masses, mass 1 an image, the L1 grid
    cost."""
    imgs = synthetic_digits(2 * B, side, seed, blobs).reshape(2 * B, -1)
    imgs = imgs / imgs.sum(1, keepdims=True)
    idx = np.arange(side * side)
    C = grid_l1_cost((side, side), idx, (side, side), idx)
    return imgs[0::2], imgs[1::2], np.broadcast_to(C, (B,) + C.shape).copy()
