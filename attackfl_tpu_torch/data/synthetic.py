"""Synthetic datasets: the port's own numpy copy of
``attackfl_tpu/data/synthetic.py`` (ICU only).

The arrays are byte-equal to the JAX package's at the same seed (a parity
test checks it), so both packages train on the same data.  Shapes:
vitals (N, 7) float32, labs (N, 16) float32, label (N,) float32 in {0, 1}.
"""

from __future__ import annotations

import os

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


_GENERATORS = {"ICU": _icu}
# reference on-disk datasets, which the JAX package reads in preference
# to synthetic data
_REFERENCE_PATHS = {("ICU", "train"): "train_dataset.pkl.gz",
                    ("ICU", "test"): "data/test_dataset.pkl.gz"}


def make_dataset(data_name: str, n: int, seed: int = 0) -> Batch:
    if data_name not in _GENERATORS:
        raise NotImplementedError(
            f"dataset {data_name!r} is not ported yet (ROADMAP.md queue 1, "
            "item 11: other models and data paths)")
    return _GENERATORS[data_name](np.random.default_rng(seed), n)


def get_dataset(data_name: str, split: str, size: int, seed: int) -> Batch:
    """Synthetic split with the JAX package's seeding (train and test are
    disjoint: test adds 10,000 to the seed)."""
    path = _REFERENCE_PATHS.get((data_name, split))
    if path and os.path.exists(path):
        raise NotImplementedError(
            f"{path} exists: loading the reference's pickled datasets is not "
            "ported yet (ROADMAP.md queue 1, item 11)")
    return make_dataset(data_name, size,
                        seed=seed + (0 if split == "train" else 10_000))
