"""Host-side filtering defenses (the port's copy of
``attackfl_tpu/ops/defenses.py``): the GMM gradient filter and FLTracer.

They run in numpy on the flat client matrix copied off the card once a
round, as in the JAX engine (``attackfl_tpu/training/engine.py:1576-1604``).
The hyper detector (``cosine_drift_anomaly``, ``dbscan_outlier_clients``,
``HyperDetector``) comes with hyper mode (ROADMAP.md queue 1, item 12).
"""

from __future__ import annotations

import numpy as np

from attackfl_tpu_torch.ops.stats import (
    GaussianMixture, mahalanobis, median_abs_deviation, pca_fit_transform,
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
