"""Frozen copy of the port's MNIST-pair OT construction
(``smart_crossover_tpu_torch/data/ot_gen.py``: ``synthetic_digits``,
``grid_l1_cost``, ``images_to_ot``), which follows the reference's
``scripts/mnist2ot.py``: two 28 x 28 images, their zero pixels dropped,
each image's mass normalised to ``amplify``, and the L1 distance between
pixel positions as the ground cost.

The repository holds no MNIST file, so the images are the port's
stand-in: a few thresholded gaussian blobs each, drawn from the seed.
``tests/test_bm_gen.py`` holds this copy equal to the port's."""
from __future__ import annotations

import numpy as np


def synthetic_digits(num: int, side: int = 28, seed: int = 42,
                     blobs: int = 4) -> np.ndarray:
    """(num, side, side) nonnegative images, zero outside their strokes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float64)
    imgs = np.zeros((num, side, side))
    for i in range(num):
        for _ in range(blobs):
            cy, cx = rng.uniform(4, side - 4, 2)
            sig = rng.uniform(1.0, 3.0)
            amp = rng.uniform(0.5, 1.5)
            imgs[i] += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                    / (2 * sig ** 2))
        imgs[i][imgs[i] < 0.25] = 0.0
    return imgs


def grid_l1_cost(shape_a, idx_a, shape_b, idx_b) -> np.ndarray:
    ra, ca = np.unravel_index(idx_a, shape_a)
    rb, cb = np.unravel_index(idx_b, shape_b)
    return (np.abs(ra[:, None] - rb[None, :])
            + np.abs(ca[:, None] - cb[None, :])).astype(np.float64)


def images_to_ot(img_a: np.ndarray, img_b: np.ndarray,
                 amplify: int = 1) -> tuple:
    """(s, d, M) of the transport from ``img_a``'s nonzero pixels to
    ``img_b``'s, in float64."""
    a = np.asarray(img_a, dtype=np.float64)
    b = np.asarray(img_b, dtype=np.float64)
    ia, ib = np.flatnonzero(a), np.flatnonzero(b)
    s, d = a.ravel()[ia], b.ravel()[ib]
    s = s / s.sum() * amplify
    d = d / d.sum() * amplify
    return s, d, grid_l1_cost(a.shape, ia, b.shape, ib)


def pairs(num_pairs: int, seed: int, side: int = 28, blobs: int = 4,
          amplify: int = 1) -> list:
    """``num_pairs`` instances (s, d, M) from 2 num_pairs images drawn
    from ``seed``, image 2i paired with 2i + 1, as the reference pairs
    them."""
    imgs = synthetic_digits(2 * num_pairs, side, seed, blobs)
    return [images_to_ot(imgs[2 * i], imgs[2 * i + 1], amplify)
            for i in range(num_pairs)]
