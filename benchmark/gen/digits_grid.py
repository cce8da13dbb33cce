"""MNIST-style pairs on the full 28 x 28 grid: the paper's MNIST-pair
transport (arXiv:2102.09420, reference ``scripts/mnist2ot.py``) with every
pixel kept as a point, blank ones as points of mass 0, so that every
instance of a batch has the same shape (S = D = side^2), as the reference
repo's ``bench.py`` row ``ot_16x784x784`` batches them.

The images are the port's MNIST stand-in (``gen/digits.py``, a frozen
copy of ``data/ot_gen.py::synthetic_digits``), each normalised to mass
``amplify``; the ground cost is the L1 distance between pixel positions
(``gen/digits.py::grid_l1_cost`` over all pixels).  Where both images of a
pair have no blank pixel this is ``images_to_ot``'s instance;
``tests/test_bm_mnist784.py`` holds the two equal on the pixels they
share."""
from __future__ import annotations

import numpy as np

from benchmark.gen.digits import grid_l1_cost, synthetic_digits


def grid_cost(side: int) -> np.ndarray:
    """(side^2, side^2) L1 distances between all pixel positions, integers
    0 to 2 (side - 1), float64."""
    idx = np.arange(side * side)
    return grid_l1_cost((side, side), idx, (side, side), idx)


def grid_pairs(num_pairs: int, seed: int, side: int = 28, blobs: int = 4,
               amplify: int = 1) -> tuple:
    """(s (num_pairs, side^2), d (num_pairs, side^2)) in float64: image 2i
    (supplies) paired with image 2i + 1 (demands) of 2 num_pairs images
    drawn from ``seed``, every pixel kept, each image's mass
    ``amplify``."""
    imgs = synthetic_digits(2 * num_pairs, side, seed, blobs)
    flat = imgs.reshape(2 * num_pairs, side * side)
    flat = flat / flat.sum(1, keepdims=True) * amplify
    return flat[0::2].copy(), flat[1::2].copy()
