"""DOTmark-style transport between two images on one square grid
(Schrieber, Schuhmacher and Gottschlich, "DOTmark - A Benchmark for
Discrete Optimal Transport", arXiv:1610.03368): every pixel is a point
of mass, so S = D = side^2; each image is normalised to total mass 1;
the ground cost is the squared Euclidean distance between pixel
positions.  The WhiteNoise class draws every pixel's value i.i.d.
uniform; the class's files are not in the repository, so the values are
drawn from the seed."""
from __future__ import annotations

import numpy as np


def cost(side: int) -> np.ndarray:
    """(side^2, side^2) squared Euclidean distances on the grid."""
    r, c = np.divmod(np.arange(side * side), side)
    return ((r[:, None] - r[None, :]) ** 2
            + (c[:, None] - c[None, :]) ** 2).astype(np.float64)


def white_noise(n: int, side: int, seed: int) -> tuple:
    """(s (n, side^2), d (n, side^2)): n pairs of WhiteNoise images, each
    normalised to mass 1, float64."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.0, 1.0, (n, side * side))
    d = rng.uniform(0.0, 1.0, (n, side * side))
    return s / s.sum(1, keepdims=True), d / d.sum(1, keepdims=True)
