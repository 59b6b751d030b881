"""Hyper mode's embedding detector in the port (``ops/stats.dbscan_labels``,
``ops/defenses.cosine_drift_anomaly``, ``dbscan_outlier_clients`` and
``HyperDetector``) against the JAX package's numpy code on the same
inputs: decisions identical, values within 1e-12.  The inputs are seeded
embeddings of 12 clients, two of which drift away from round 3 on."""

import numpy as np
import pytest

from attackfl_tpu.ops import defenses as jdefenses
from attackfl_tpu.ops import stats as jstats
from attackfl_tpu_torch.ops import defenses, stats

C, E = 12, 8


def _rounds(n_rounds: int = 6, seed: int = 0) -> list[np.ndarray]:
    """Per round a (C, E) embedding table: each client's own direction
    plus small steps, clients 10 and 11 jumping from round 3 on."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((C, E))
    out = []
    for r in range(n_rounds):
        emb = base + 0.004 * rng.standard_normal((C, E)) * r
        if r >= 3:
            emb[10:] = emb[10:] - 3.0 * base[10:] + 0.5 * rng.standard_normal((2, E))
        out.append(emb.astype(np.float32))
    return out


@pytest.mark.parametrize("eps,min_samples", [(0.3, 3), (1.0, 2), (0.05, 4), (3.0, 5)])
def test_dbscan_labels_match_jax(eps, min_samples):
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(0.0, 0.2, (10, 3)), rng.normal(3.0, 0.2, (6, 3)),
                        rng.normal(-4.0, 2.0, (4, 3))])
    ours = stats.dbscan_labels(x, eps, min_samples)
    assert np.array_equal(ours, jstats.dbscan_labels(x, eps, min_samples))
    assert ours.dtype == np.int64


@pytest.mark.parametrize("k", [0.5, 2.0])
def test_cosine_drift_anomaly_matches_jax(k):
    rng = np.random.default_rng(2)
    hist = rng.standard_normal((5, E)) * 0.01 + rng.standard_normal(E)
    for cur in (hist[-1] + 0.001, -hist[-1], rng.standard_normal(E)):
        assert (defenses.cosine_drift_anomaly(hist, cur, k)
                == jdefenses.cosine_drift_anomaly(hist, cur, k))
    assert defenses.cosine_drift_anomaly(np.empty((0, E)), hist[0]) is False
    assert defenses.cosine_drift_anomaly(hist, -hist[-1], k) is True


def test_dbscan_outlier_clients_matches_jax():
    emb = _rounds()
    selected = list(range(C))
    for before, after in zip(emb, emb[1:]):
        ours = defenses.dbscan_outlier_clients(before, after, selected, 3, 0.05, 3)
        assert ours == jdefenses.dbscan_outlier_clients(before, after, selected, 3, 0.05, 3)
    # the pca projection under it, value for value
    delta = (emb[4] - emb[3]).astype(np.float64)
    assert np.abs(stats.pca_fit_transform(delta, 3)
                  - jstats.pca_fit_transform(delta, 3)).max() <= 1e-12


def test_hyper_detector_observe_sequence_matches_jax(tmp_path):
    """Six rounds of ``observe`` (start_round 3, history of 4), client 5
    removed after round 4 as the engine does: the same removals each
    round, the same history, and the same ``all_embeddings.npy``."""
    kw = dict(cosine_search=4, n_components=3, eps=0.05, min_samples=3, start_round=3)
    ours = defenses.HyperDetector(C, save_path=str(tmp_path / "port.npy"), **kw)
    ref = jdefenses.HyperDetector(C, save_path=str(tmp_path / "jax.npy"), **kw)
    selected = list(range(C))
    seen = []
    for r, emb in enumerate(_rounds(), 1):
        rows = emb[selected]
        removed = ours.observe(r, selected, rows)
        assert removed == ref.observe(r, selected, rows)
        seen.append(removed)
        for a, b in zip(ours.history, ref.history):
            assert len(a) == len(b)
            assert all(np.abs(x - y).max() <= 1e-12 for x, y in zip(a, b))
        saved = np.load(tmp_path / "port.npy", allow_pickle=True)
        expected = np.load(tmp_path / "jax.npy", allow_pickle=True)
        assert saved.shape == expected.shape and saved.dtype == expected.dtype
        if r == 4:
            selected = [c for c in selected if c != 5]
    assert any(seen[3:]), "the drifting clients were never removed"
    assert not any(seen[:2])
