"""1-D K-means for queue-count selection and cutoffs (paper §4.2).

The scheduler clusters the recent WRS distribution for K = 1..K_max and
picks K by WCSS. Read literally, "minimal WCSS" always selects K_max
(WCSS is monotone non-increasing in K); we implement the standard elbow
reading: the smallest K whose marginal WCSS improvement falls below
``min_gain`` (default 20 %). With heterogeneous workloads this lands on
3–4 queues, matching the paper's examples; with homogeneous load it
collapses to 1 queue — exactly the adaptivity §4.2 argues for.

Cutoffs are midpoints between consecutive sorted centroids.
"""
from __future__ import annotations

import numpy as np


def kmeans_1d(values: np.ndarray, k: int, n_iter: int = 50,
              seed: int = 0) -> tuple[np.ndarray, float]:
    """Lloyd's algorithm specialised for 1-D. Returns (centroids, wcss)."""
    v = np.asarray(values, dtype=np.float64).ravel()
    if len(v) == 0:
        return np.zeros(k), 0.0
    if k >= len(np.unique(v)):
        c = np.unique(v)
        pad = np.full(max(0, k - len(c)), c[-1])
        c = np.concatenate([c, pad])[:k]
    else:
        # Quantile init: deterministic and robust for 1-D.
        qs = (np.arange(k) + 0.5) / k
        c = np.quantile(v, qs)
    for _ in range(n_iter):
        d = np.abs(v[:, None] - c[None, :])
        assign = d.argmin(axis=1)
        new_c = c.copy()
        for j in range(k):
            sel = v[assign == j]
            if len(sel):
                new_c[j] = sel.mean()
        if np.allclose(new_c, c):
            c = new_c
            break
        c = new_c
    d = np.abs(v[:, None] - c[None, :])
    wcss = float((d.min(axis=1) ** 2).sum())
    return np.sort(c), wcss


def choose_queues(values: np.ndarray, k_max: int = 4,
                  min_gain: float = 0.2, cv_min: float = 0.05,
                  seed: int = 0) -> tuple[int, np.ndarray, np.ndarray]:
    """Pick the queue count and cutoffs from a WRS sample.

    Returns (k, centroids, cutoffs). ``cutoffs`` has length k-1 and is the
    midpoints between consecutive centroids; queue i takes requests with
    cutoffs[i-1] <= WRS < cutoffs[i].

    ``cv_min`` guards the homogeneous case: K-means WCSS drops sharply
    with K even on unimodal noise, so the elbow alone never returns K=1;
    when the coefficient of variation of the sample is below ``cv_min``
    the requests are effectively the same size and one queue suffices
    (the paper's "too many queues → fragmentation" argument).
    """
    v = np.asarray(values, dtype=np.float64).ravel()
    if len(v) < 2 or np.ptp(v) < 1e-12:
        return 1, np.array([v.mean() if len(v) else 0.0]), np.array([])
    mean = abs(v.mean())
    if mean > 1e-12 and v.std() / mean < cv_min:
        return 1, np.array([v.mean()]), np.array([])
    results = {}
    for k in range(1, k_max + 1):
        results[k] = kmeans_1d(v, k, seed=seed)
    best_k = 1
    prev_wcss = results[1][1]
    for k in range(2, k_max + 1):
        wcss = results[k][1]
        if prev_wcss <= 1e-12:
            break
        gain = (prev_wcss - wcss) / prev_wcss
        if gain < min_gain:
            break
        best_k = k
        prev_wcss = wcss
    centroids = results[best_k][0]
    cutoffs = (centroids[:-1] + centroids[1:]) / 2.0
    return best_k, centroids, cutoffs


def queue_index(wrs: float, cutoffs: np.ndarray) -> int:
    """Queue for a WRS value: 0 = smallest requests (highest priority)."""
    return int(np.searchsorted(cutoffs, wrs, side="right"))
