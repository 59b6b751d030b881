"""Statistical primitives of the host-side defenses (the port's copy of
``attackfl_tpu/ops/stats.py``): PCA, median absolute deviation, a
full-covariance Gaussian mixture and the Mahalanobis distance, in numpy.

The problems are tiny (clients x a few dims, once per round) and run on
the host, as in the JAX engine; numpy keeps the port free of scikit-learn
and scipy, which the card's machine does not promise.  ``dbscan_labels``
is the hyper detector's (``ops/defenses.HyperDetector``).
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------

def pca_fit_transform(x: np.ndarray, n_components: int) -> np.ndarray:
    """Project rows of ``x`` (N, D) onto their top principal components.

    Matches sklearn.decomposition.PCA.fit_transform up to component sign:
    center, SVD, project.
    """
    x = np.asarray(x, dtype=np.float64)
    mean = x.mean(axis=0)
    xc = x - mean
    # SVD of the centered data: xc = U S Vt; scores = U S
    u, s, _vt = np.linalg.svd(xc, full_matrices=False)
    k = min(n_components, s.shape[0])
    scores = u[:, :k] * s[:k]
    if k < n_components:  # degenerate rank: pad with zeros
        scores = np.concatenate(
            [scores, np.zeros((x.shape[0], n_components - k))], axis=1
        )
    return scores


# ---------------------------------------------------------------------------
# MAD
# ---------------------------------------------------------------------------

def median_abs_deviation(x: np.ndarray) -> float:
    """scipy.stats.median_abs_deviation with default (unscaled) behavior."""
    x = np.asarray(x, dtype=np.float64)
    return float(np.median(np.abs(x - np.median(x))))


# ---------------------------------------------------------------------------
# Gaussian mixture (EM, full covariance)
# ---------------------------------------------------------------------------

class GaussianMixture:
    """Minimal full-covariance GMM with the sklearn attributes the defense
    layer needs: ``means_``, ``covariances_``, ``predict_proba``.

    Init: means seeded from k distinct random data points, points hard-
    assigned to the nearest mean (one k-means-like step), then EM.
    ``reg_covar`` keeps covariances invertible exactly like sklearn's
    regularization (needed because the reference fits P-dim covariances on
    a handful of client vectors).
    """

    def __init__(self, n_components: int = 2, n_iter: int = 50,
                 reg_covar: float = 1e-6, seed: int = 0):
        self.n_components = n_components
        self.n_iter = n_iter
        self.reg_covar = reg_covar
        self.seed = seed
        self.means_: np.ndarray | None = None
        self.covariances_: np.ndarray | None = None
        self.weights_: np.ndarray | None = None

    def fit(self, x: np.ndarray) -> "GaussianMixture":
        x = np.asarray(x, dtype=np.float64)
        n, d = x.shape
        rng = np.random.default_rng(self.seed)
        # seed means from distinct data points, hard-assign to nearest
        seeds = rng.choice(n, size=min(self.n_components, n), replace=False)
        centers = x[seeds]
        if centers.shape[0] < self.n_components:  # fewer points than comps
            centers = np.concatenate(
                [centers, centers[: self.n_components - centers.shape[0]] + 1e-3]
            )
        dists = np.linalg.norm(x[:, None, :] - centers[None, :, :], axis=-1)
        assign = dists.argmin(axis=1)
        for k in range(self.n_components):
            if not np.any(assign == k):
                assign[rng.integers(n)] = k
        resp = np.eye(self.n_components)[assign]

        for _ in range(self.n_iter):
            # M step
            nk = resp.sum(axis=0) + 1e-10
            self.weights_ = nk / n
            self.means_ = (resp.T @ x) / nk[:, None]
            covs = []
            for k in range(self.n_components):
                diff = x - self.means_[k]
                cov = (resp[:, k : k + 1] * diff).T @ diff / nk[k]
                cov[np.diag_indices(d)] += self.reg_covar
                covs.append(cov)
            self.covariances_ = np.stack(covs)
            # E step
            log_resp = self._log_prob(x) + np.log(self.weights_ + 1e-300)
            log_resp -= log_resp.max(axis=1, keepdims=True)
            resp = np.exp(log_resp)
            resp /= resp.sum(axis=1, keepdims=True)
        return self

    def _log_prob(self, x: np.ndarray) -> np.ndarray:
        n, d = x.shape
        out = np.empty((n, self.n_components))
        for k in range(self.n_components):
            diff = x - self.means_[k]
            cov = self.covariances_[k]
            sign, logdet = np.linalg.slogdet(cov)
            if sign <= 0:
                cov = cov + np.eye(d) * self.reg_covar * 10
                sign, logdet = np.linalg.slogdet(cov)
            solve = np.linalg.solve(cov, diff.T).T
            maha = np.sum(diff * solve, axis=1)
            out[:, k] = -0.5 * (d * np.log(2 * np.pi) + logdet + maha)
        return out

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        log_p = self._log_prob(x) + np.log(self.weights_ + 1e-300)
        log_p -= log_p.max(axis=1, keepdims=True)
        p = np.exp(log_p)
        return p / p.sum(axis=1, keepdims=True)


def mahalanobis(x: np.ndarray, mean: np.ndarray, cov: np.ndarray) -> float:
    """Mahalanobis distance of one vector to a Gaussian (reference:
    calculate_md, src/Utils.py:304-309).  Uses solve instead of explicit
    inverse, with diagonal regularization for singular covariances."""
    diff = np.asarray(x, dtype=np.float64) - mean
    d = diff.shape[0]
    try:
        solve = np.linalg.solve(cov, diff)
    except np.linalg.LinAlgError:
        solve = np.linalg.solve(cov + np.eye(d) * 1e-6, diff)
    return float(np.sqrt(max(diff @ solve, 0.0)))


# ---------------------------------------------------------------------------
# DBSCAN
# ---------------------------------------------------------------------------

def dbscan_labels(x: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN cluster labels; noise = -1.  Semantics match
    sklearn.cluster.DBSCAN (euclidean, min_samples includes the point
    itself).  O(N²) neighbor search — N is the client count."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    dist = np.linalg.norm(x[:, None, :] - x[None, :, :], axis=-1)
    neighbors = [np.flatnonzero(dist[i] <= eps) for i in range(n)]
    core = np.array([len(nb) >= min_samples for nb in neighbors])

    labels = np.full(n, -1, dtype=np.int64)
    cluster = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        # BFS over density-reachable points
        labels[i] = cluster
        frontier = list(neighbors[i])
        while frontier:
            j = frontier.pop()
            if labels[j] == -1:
                labels[j] = cluster
                if core[j]:
                    frontier.extend(k for k in neighbors[j] if labels[k] == -1)
        cluster += 1
    return labels
