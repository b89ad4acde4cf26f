"""Pairwise distances (counterpart of fsvlm_tpu.engine.distance; parity:
dassl/metrics/distance.py)."""

import torch


def compute_distance_matrix(x, y, metric="euclidean"):
    """x: (m, d), y: (n, d) -> (m, n) distances."""
    if metric == "euclidean":
        return euclidean_squared_distance(x, y) ** 0.5
    if metric == "euclidean_squared":
        return euclidean_squared_distance(x, y)
    if metric == "cosine":
        return cosine_distance(x, y)
    raise ValueError(f"Unknown distance metric: {metric}")


def euclidean_squared_distance(x, y):
    """||x_i - y_j||^2 by the expanded quadratic form, clamped at 0."""
    d = (x ** 2).sum(1, keepdim=True) + (y ** 2).sum(1)[None, :] - 2.0 * x @ y.T
    return torch.clamp(d, min=0.0)


def cosine_distance(x, y):
    """1 - cosine similarity."""
    xn = x / torch.linalg.norm(x, dim=1, keepdim=True)
    yn = y / torch.linalg.norm(y, dim=1, keepdim=True)
    return 1.0 - xn @ yn.T
