"""Clustering for the paper's Table II: the Rand index, the k-means
normalization baseline and the DTCR-like deep baseline."""
from repro_torch.clustering import dtcr, kmeans, metrics  # noqa: F401
