"""Optimal-transport instance generation.

Capability parity with the reference's MNIST-pair generator
(reference scripts/mnist2ot.py:12-88): normalise two images to equal unit
mass (optionally k-times amplified), drop zero pixels, use the L1 grid
distance as ground cost, and pair images i/i+1 into instances.  Since the
environment has no dataset downloads, `synthetic_digits` produces
deterministic MNIST-like 28x28 blobs; `images_to_ot` accepts real MNIST
arrays unchanged when available.

Host copy of ``smart_crossover_tpu/data/ot_gen.py``.  One difference:
``load_mnist_images`` searches only the given path, ``$SCX_MNIST_PATH``
and ``./data/mnist``, never the home directory.
"""
from __future__ import annotations

import numpy as np

from smart_crossover_tpu_torch.models import OptTransport


def grid_l1_cost(shape_a, idx_a, shape_b, idx_b) -> np.ndarray:
    """L1 ground cost between retained pixel positions of two grids
    (the reference's cost, mnist2ot.py:30-40)."""
    ra, ca = np.unravel_index(idx_a, shape_a)
    rb, cb = np.unravel_index(idx_b, shape_b)
    return (np.abs(ra[:, None] - rb[None, :])
            + np.abs(ca[:, None] - cb[None, :])).astype(np.float64)


def images_to_ot(img_a: np.ndarray, img_b: np.ndarray,
                 amplify: int = 1, name: str = "ot_pair") -> OptTransport:
    """Build an OT instance from two nonnegative images (zero pixels
    dropped, masses normalised to `amplify`)."""
    a = np.asarray(img_a, dtype=np.float64)
    b = np.asarray(img_b, dtype=np.float64)
    ia = np.flatnonzero(a)
    ib = np.flatnonzero(b)
    s = a.ravel()[ia]
    d = b.ravel()[ib]
    s = s / s.sum() * amplify
    d = d / d.sum() * amplify
    M = grid_l1_cost(a.shape, ia, b.shape, ib)
    return OptTransport(s=s, d=d, M=M, name=name)


def synthetic_digits(num: int = 20, side: int = 28, seed: int = 42,
                     blobs: int = 4) -> np.ndarray:
    """Deterministic MNIST-like images: a few gaussian blobs per image."""
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
        # sparsify like thresholded MNIST strokes
        imgs[i][imgs[i] < 0.25] = 0.0
    return imgs


def _read_idx_images(path) -> np.ndarray | None:
    """Parse an IDX3 image file (the raw MNIST distribution format)."""
    import gzip
    import struct
    from pathlib import Path

    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as fh:
        head = fh.read(16)
        if len(head) < 16:
            return None
        magic, num, rows, cols = struct.unpack(">IIII", head)
        if magic != 2051:
            return None
        buf = fh.read(num * rows * cols)
        return np.frombuffer(buf, dtype=np.uint8).reshape(
            num, rows, cols).astype(np.float64)


def load_mnist_images(path: str | None = None) -> np.ndarray | None:
    """Load REAL MNIST pixels from a local copy, or None if absent.

    Search order: explicit `path` arg, $SCX_MNIST_PATH, then ./data/mnist
    (mnist.npz or the raw IDX files).  The environment has no network access, so unlike the
    reference (mnist2ot.py:12-20, keras download) this never fetches —
    callers fall back to `synthetic_digits` when this returns None."""
    import os
    from pathlib import Path

    candidates = []
    if path:
        candidates.append(Path(path))
    env = os.environ.get("SCX_MNIST_PATH")
    if env:
        candidates.append(Path(env))
    candidates += [
        Path("data") / "mnist" / "mnist.npz",
        Path("data") / "mnist" / "train-images-idx3-ubyte",
        Path("data") / "mnist" / "train-images-idx3-ubyte.gz",
    ]
    for cand in candidates:
        if not cand.exists():
            continue
        if cand.is_dir():
            for sub in ("train-images-idx3-ubyte", "mnist.npz",
                        "train-images-idx3-ubyte.gz"):
                if (cand / sub).exists():
                    cand = cand / sub
                    break
            else:
                continue
        if cand.name.endswith(".npz"):
            with np.load(cand) as z:
                key = "x_train" if "x_train" in z else list(z.keys())[0]
                return np.asarray(z[key], dtype=np.float64)
        imgs = _read_idx_images(cand)
        if imgs is not None:
            return imgs
    return None


def mnist_ot_suite(num_pairs: int = 10, amplify: int = 1,
                   seed: int = 42,
                   mnist_path: str | None = None) -> list[OptTransport]:
    """The reference's real-MNIST suite (mnist2ot.py:71-84): pick
    2*num_pairs images at random (seed 42), pair i with i+1.  Falls back
    to `mnist_like_ot_suite` (synthetic blobs) when no local MNIST copy
    exists; instance names record which source was used."""
    imgs = load_mnist_images(mnist_path)
    if imgs is None:
        return mnist_like_ot_suite(num_pairs=num_pairs, amplify=amplify,
                                   seed=seed)
    rng = np.random.RandomState(seed)  # reference uses np.random.seed(42)
    pick = rng.choice(imgs.shape[0], size=2 * num_pairs, replace=False)
    sel = imgs[pick]
    return [images_to_ot(sel[2 * i], sel[2 * i + 1], amplify=amplify,
                         name=f"mnist_pair{i}")
            for i in range(num_pairs)]


def mnist_like_ot_suite(num_pairs: int = 10, side: int = 28,
                        amplify: int = 1, seed: int = 42) -> list[OptTransport]:
    """The reference's experiment suite shape: `num_pairs` instances from
    2*num_pairs images, pairing i with i+1 (mnist2ot.py:71-84)."""
    imgs = synthetic_digits(2 * num_pairs, side=side, seed=seed)
    return [images_to_ot(imgs[2 * i], imgs[2 * i + 1], amplify=amplify,
                         name=f"ot_{side}x{side}_pair{i}")
            for i in range(num_pairs)]


def random_ot_batch(batch: int, ns: int, nd: int, seed: int = 0,
                    dtype=np.float32):
    """Dense random batch for throughput benchmarking (padded, batchable)."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, (batch, ns)).astype(dtype)
    d = rng.uniform(0.5, 2.0, (batch, nd)).astype(dtype)
    d *= (s.sum(axis=1) / d.sum(axis=1))[:, None]
    M = rng.uniform(0.0, 5.0, (batch, ns, nd)).astype(dtype)
    return s, d, M
