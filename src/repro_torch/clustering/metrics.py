"""Clustering metrics: rand index (paper's Table II metric) and helpers."""
from __future__ import annotations

import numpy as np


def rand_index(labels_true: np.ndarray, labels_pred: np.ndarray) -> float:
    """Unadjusted Rand index between two labelings (paper follows [2]).

    RI = (#agreeing pairs) / (#pairs); computed from the contingency table
    in O(n_classes * n_clusters) without materializing pairs.
    """
    a = np.asarray(labels_true).ravel()
    b = np.asarray(labels_pred).ravel()
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    n = a.size
    if n < 2:
        return 1.0
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    cont = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(cont, (ai, bi), 1)
    sum_comb_c = (cont * (cont - 1) // 2).sum()
    sum_comb_a = (cont.sum(1) * (cont.sum(1) - 1) // 2).sum()
    sum_comb_b = (cont.sum(0) * (cont.sum(0) - 1) // 2).sum()
    total = n * (n - 1) // 2
    # pairs agreeing: both-same + both-different
    both_same = sum_comb_c
    both_diff = total - sum_comb_a - sum_comb_b + sum_comb_c
    return float((both_same + both_diff) / total)


def normalized_rand(ri: float, ri_kmeans: float) -> float:
    """Table II normalizes rand indices to k-means."""
    return ri / max(ri_kmeans, 1e-12)
