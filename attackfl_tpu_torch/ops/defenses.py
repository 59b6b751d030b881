"""Host-side filtering defenses (the port's copy of
``attackfl_tpu/ops/defenses.py``): the GMM gradient filter, FLTracer and
hyper mode's embedding anomaly detector.

The filters run in numpy on the flat client matrix copied off the card
once a round, as in the JAX engine (``attackfl_tpu/training/engine.py:1576-1604``);
the detector on the (C, 8) client embeddings (engine.py:1722-1735).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from attackfl_tpu_torch.ops.stats import (
    GaussianMixture, dbscan_labels, mahalanobis, median_abs_deviation, pca_fit_transform,
)


# ---------------------------------------------------------------------------
# GMM-based gradient filtering
# ---------------------------------------------------------------------------

def gmm_filter(
    client_vectors: np.ndarray,
    attacker_mask: np.ndarray,
    n_components: int = 2,
    md_sigma: float = 3.0,
    max_dim: int = 16,
    seed: int = 0,
) -> np.ndarray:
    """Return a benign-client boolean mask.

    Reference semantics (server.py:352-372 + src/Utils.py:257-323): fit a
    2-component full-covariance GMM on all flat client updates (using the
    *ground-truth* attacker labels to calibrate a Mahalanobis threshold
    from the benign population) and keep clients within the threshold.

    Divergences (documented fixes — the reference recipe is inoperative as
    written):
    * The reference fits a PxP covariance on a handful of P≈10⁴⁺-dim
      vectors — singular and O(P²) memory.  We first project to
      ``min(n_clients-1, max_dim)`` PCA dims.
    * The reference thresholds each client's distance to its OWN argmax
      component (Utils.py:311-323) — attackers clustered into their own
      component always sit near that component's mean and always pass; and
      its threshold (3·std of benign distances to hardcoded component 0,
      server.py:361) depends on arbitrary component ordering.  We measure
      every client against the benign-majority component and use
      mean + md_sigma·std of the benign distances as the cutoff, which
      makes the filter actually reject poisoned updates.
    """
    x = np.asarray(client_vectors, dtype=np.float64)
    attacker_mask = np.asarray(attacker_mask, dtype=bool)
    n = x.shape[0]
    k = max(1, min(n - 1, max_dim))
    z = pca_fit_transform(x, k)

    gmm = GaussianMixture(n_components=n_components, seed=seed).fit(z)
    hard = gmm.predict_proba(z).argmax(axis=1)

    benign_idx = np.flatnonzero(~attacker_mask)
    counts = np.bincount(hard[benign_idx], minlength=n_components)
    benign_comp = int(np.argmax(counts))
    mean_b = gmm.means_[benign_comp]
    cov_b = gmm.covariances_[benign_comp]

    benign_md = np.array([mahalanobis(z[i], mean_b, cov_b) for i in benign_idx])
    threshold = float(np.mean(benign_md)) + md_sigma * float(np.std(benign_md))

    md = np.array([mahalanobis(z[i], mean_b, cov_b) for i in range(n)])
    return md <= threshold


# ---------------------------------------------------------------------------
# FLTracer
# ---------------------------------------------------------------------------

def fltracer_anomalies(weight_matrix: np.ndarray, threshold: float = 2.5) -> np.ndarray:
    """PCA(1) + MAD robust z-score anomaly indices
    (reference: fltracer_detect_anomalies, src/Utils.py:363-369)."""
    z = pca_fit_transform(np.asarray(weight_matrix, dtype=np.float64), 1)[:, 0]
    mad = median_abs_deviation(z)
    med = np.median(z)
    scores = np.abs(z - med) / (1.4826 * mad + 1e-6)
    return np.flatnonzero(scores > threshold)


# ---------------------------------------------------------------------------
# Hypernetwork embedding anomaly detection
# ---------------------------------------------------------------------------

def cosine_drift_anomaly(history: np.ndarray, current: np.ndarray, k: float = 2.0) -> bool:
    """Phase-1 detector (reference: cosine, src/Utils.py:391-416).

    ``history`` (H, E) holds a client's past embeddings, ``current`` (E,)
    the new one.  The client is anomalous when its cosine similarity to the
    mean normalized history direction falls below μ − k·σ of the history's
    own similarities.
    """
    history = np.asarray(history, dtype=np.float64)
    current = np.asarray(current, dtype=np.float64).reshape(-1)
    if history.shape[0] == 0:
        return False
    hist_norm = history / np.linalg.norm(history, axis=1, keepdims=True)
    mean_dir = hist_norm.mean(axis=0)
    cur_unit = current / np.linalg.norm(current)
    cos_cur = float(cur_unit @ mean_dir / (np.linalg.norm(cur_unit) * np.linalg.norm(mean_dir)))
    cos_hist = (history @ mean_dir) / (
        np.linalg.norm(history, axis=1) * np.linalg.norm(mean_dir)
    )
    mu, sigma = float(np.mean(cos_hist)), max(float(np.std(cos_hist)), 1e-6)
    return cos_cur < mu - k * sigma


def dbscan_outlier_clients(
    emb_before: np.ndarray,
    emb_after: np.ndarray,
    selected_clients: list[int],
    n_components: int = 3,
    eps: float = 0.008,
    min_samples: int = 3,
) -> list[int]:
    """Phase-2 detector (reference: DBSCAN_phase2, src/Utils.py:419-436):
    PCA + DBSCAN on per-client embedding deltas between consecutive rounds;
    outliers are DBSCAN noise points (label −1)."""
    delta = np.asarray(emb_after, dtype=np.float64) - np.asarray(emb_before, dtype=np.float64)
    delta = delta.reshape(delta.shape[0], -1)
    z = pca_fit_transform(delta, n_components)
    labels = dbscan_labels(z, eps=eps, min_samples=min_samples)
    return [selected_clients[i] for i in np.flatnonzero(labels == -1)]


class HyperDetector:
    """Stateful embedding-history tracker driving both phases
    (reference: server.py:132-134,496-536).

    Keeps a deque of the last ``cosine_search`` embeddings per client,
    persists them to ``all_embeddings.npy`` each round (server.py:519-522),
    and from ``start_round`` on returns the set of clients flagged by BOTH
    the cosine drift and the DBSCAN phase (intersection, server.py:531).
    """

    def __init__(self, total_clients: int, cosine_search: int = 10,
                 n_components: int = 3, eps: float = 0.008, min_samples: int = 3,
                 start_round: int = 18, save_path: str | None = "all_embeddings.npy"):
        self.history = [deque(maxlen=cosine_search) for _ in range(total_clients)]
        self.n_components = n_components
        self.eps = eps
        self.min_samples = min_samples
        self.start_round = start_round
        self.save_path = save_path

    def observe(self, round_number: int, selected_clients: list[int],
                embeddings: np.ndarray) -> list[int]:
        """Record this round's embeddings (rows follow ``selected_clients``)
        and return the client indices to remove (may be empty)."""
        cosine_flagged: list[int] = []
        active = round_number >= self.start_round

        for row, client in enumerate(selected_clients):
            cur = np.asarray(embeddings[row], dtype=np.float64).reshape(-1)
            hist = (np.array(self.history[client]) if self.history[client]
                    else np.empty((0, cur.shape[0])))
            if active and cosine_drift_anomaly(hist, cur):
                cosine_flagged.append(client)
            self.history[client].append(cur)

        if self.save_path:
            np.save(self.save_path,
                    np.array([list(dq) for dq in self.history], dtype=object),
                    allow_pickle=True)

        if not active:
            return []
        # need at least two rounds of history for the delta phase
        if any(len(self.history[c]) < 2 for c in selected_clients):
            return []
        before = np.stack([self.history[c][-2] for c in selected_clients])
        after = np.stack([self.history[c][-1] for c in selected_clients])
        db_flagged = dbscan_outlier_clients(
            before, after, selected_clients,
            n_components=self.n_components, eps=self.eps, min_samples=self.min_samples,
        )
        return sorted(set(cosine_flagged) & set(db_flagged))
