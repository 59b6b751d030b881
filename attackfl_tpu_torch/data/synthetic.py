"""Datasets: the port's own numpy copy of ``attackfl_tpu/data/synthetic.py``.

Synthetic generators with the JAX package's shapes, label semantics and
seeding: the arrays are byte-equal to the JAX package's at the same seed
(a parity test checks it), so both packages train on the same data.  When
the reference's on-disk datasets exist, they are read instead: its
gzip-pickled ICU and HAR datasets, and CIFAR-10 in the
``cifar-10-batches-py`` layout.  Shapes:

  ICU:     vitals (N, 7) float32, labs (N, 16) float32, label (N,) float32 in {0, 1}
  HAR:     x (N, 561) float32, label (N,) int32 in 0..5
  CIFAR10: x (N, 32, 32, 3) float32 in [-1, 1] (NHWC), label (N,) int32 in 0..9
"""

from __future__ import annotations

import gzip
import os
import pickle
from typing import Any

import numpy as np

Batch = dict[str, np.ndarray]


def _icu(rng: np.random.Generator, n: int) -> Batch:
    """Synthetic ICU cohort: labels follow a sparse linear risk score of
    vitals+labs through a logistic link (~25% positives)."""
    vitals = rng.normal(0.0, 1.0, size=(n, 7)).astype(np.float32)
    labs = rng.normal(0.0, 1.0, size=(n, 16)).astype(np.float32)
    w_rng = np.random.default_rng(7)
    wv = w_rng.normal(0, 1, size=(7,))
    wl = w_rng.normal(0, 1, size=(16,))
    score = vitals @ wv + labs @ wl
    prob = 1.0 / (1.0 + np.exp(-(score - 1.0)))
    label = (rng.uniform(size=n) < prob).astype(np.float32)
    # the reference's missing-measurement value, sprinkled into vitals
    mask = rng.uniform(size=vitals.shape) < 0.05
    vitals = np.where(mask, np.float32(-2.0), vitals)
    return {"vitals": vitals, "labs": labs, "label": label}


def _har(rng: np.random.Generator, n: int) -> Batch:
    """Synthetic HAR: 6 activity classes, each a smooth template over 561
    pseudo-features, plus noise."""
    t = np.linspace(0.0, 6.0 * np.pi, 561)
    templates = np.stack(
        [np.sin((k + 1) * 0.5 * t + k) * (1.0 + 0.1 * k) for k in range(6)]
    ).astype(np.float32)
    label = rng.integers(0, 6, size=n)
    x = templates[label] + rng.normal(0, 0.5, size=(n, 561)).astype(np.float32)
    return {"x": x.astype(np.float32), "label": label.astype(np.int32)}


def _cifar10(rng: np.random.Generator, n: int) -> Batch:
    """Synthetic CIFAR-10 stand-in: class-conditional coloured blobs."""
    label = rng.integers(0, 10, size=n)
    base = np.random.default_rng(11).uniform(-0.6, 0.6, size=(10, 1, 1, 3)).astype(np.float32)
    x = base[label] + rng.normal(0, 0.3, size=(n, 32, 32, 3)).astype(np.float32)
    return {"x": np.clip(x, -1, 1).astype(np.float32), "label": label.astype(np.int32)}


_GENERATORS = {"ICU": _icu, "HAR": _har, "CIFAR10": _cifar10}
# the reference's on-disk datasets, read in preference to synthetic data
# (reference src/RpcClient.py:155-164, src/Validation.py:32-44)
_REFERENCE_PATHS = {("ICU", "train"): "train_dataset.pkl.gz",
                    ("ICU", "test"): "data/test_dataset.pkl.gz",
                    ("HAR", "train"): "data/icu_har_train_ds.pkl.gz",
                    ("HAR", "test"): "data/icu_har_test_ds.pkl.gz"}
CIFAR_ROOT = "data"


def make_dataset(data_name: str, n: int, seed: int = 0) -> Batch:
    if data_name not in _GENERATORS:
        raise ValueError(f"Data name '{data_name}' is not valid.")
    return _GENERATORS[data_name](np.random.default_rng(seed), n)


def load_reference_pickle(path: str) -> Batch:
    """A reference gzip-pickled dataset as arrays: a sequence of
    ``(vitals, labs, label)`` (ICU) or ``(x, label)`` (HAR; an x of shape
    (1, 561) loses its channel axis)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with gzip.open(path, "rb") as fh:
        ds: Any = pickle.load(fh)
    first = ds[0]
    if isinstance(first, (tuple, list)) and len(first) in (2, 3):
        cols = list(zip(*(ds[i] for i in range(len(ds)))))
        stack = lambda col: np.stack([np.asarray(v) for v in col]).astype(np.float32)  # noqa: E731
        if len(first) == 3:
            return {"vitals": stack(cols[0]), "labs": stack(cols[1]),
                    "label": np.asarray(cols[2], dtype=np.float32)}
        x = stack(cols[0])
        if x.ndim == 3 and x.shape[1] == 1:
            x = x[:, 0, :]
        return {"x": x, "label": np.asarray(cols[1], dtype=np.int32)}
    raise ValueError(f"Unrecognized reference dataset format in {path}")


def load_cifar10_batches(root: str, split: str) -> Batch:
    """CIFAR-10 from ``<root>/cifar-10-batches-py``: data_batch_1..5 for
    train, test_batch for test, each a pickled dict of ``data`` (N, 3072)
    uint8 CHW rows and ``labels``.  Pixels are normalized as the
    reference's transform does, /255 then (x - 0.5) / 0.5, and returned
    NHWC."""
    batch_dir = os.path.join(root, "cifar-10-batches-py")
    names = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
             else ["test_batch"])
    xs, ys = [], []
    for name in names:
        with open(os.path.join(batch_dir, name), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(np.asarray(d[b"data"], dtype=np.uint8))
        ys.append(np.asarray(d[b"labels"], dtype=np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    x = (x.astype(np.float32) / 255.0 - 0.5) / 0.5
    return {"x": x, "label": np.concatenate(ys)}


def get_dataset(data_name: str, split: str, size: int, seed: int) -> Batch:
    """The reference's on-disk dataset where it exists (paths relative to
    the working directory, as the reference reads them), else a synthetic
    split with the JAX package's seeding (train and test are disjoint:
    test adds 10,000 to the seed)."""
    path = _REFERENCE_PATHS.get((data_name, split))
    if path and os.path.exists(path):
        return load_reference_pickle(path)
    if data_name == "CIFAR10" and os.path.exists(os.path.join(CIFAR_ROOT, "cifar-10-batches-py")):
        return load_cifar10_batches(CIFAR_ROOT, split)
    return make_dataset(data_name, size,
                        seed=seed + (0 if split == "train" else 10_000))
