"""T2M evaluation metrics: R-precision, matching score, FID, diversity,
multimodality. Host numpy/scipy (small matrices; no device work).

The port's own copy of motionstyle/eval/metrics.py, with the same functions
and numbers (parity: data_loaders/humanml/utils/metrics.py:1-146).
"""
from __future__ import annotations

import inspect

import numpy as np
from scipy import linalg

# scipy 1.18 dropped sqrtm's `disp` (and its error estimate); older scipy
# warns about it
_SQRTM_DISP = "disp" in inspect.signature(linalg.sqrtm).parameters


def _sqrtm(a: np.ndarray) -> np.ndarray:
    """scipy's principal matrix square root on any scipy version."""
    return linalg.sqrtm(a, disp=False)[0] if _SQRTM_DISP else linalg.sqrtm(a)


def euclidean_distance_matrix(matrix1: np.ndarray, matrix2: np.ndarray) -> np.ndarray:
    """Pairwise euclidean distances (N1, D) x (N2, D) -> (N1, N2)."""
    assert matrix1.shape[1] == matrix2.shape[1]
    d1 = -2 * matrix1 @ matrix2.T
    d2 = np.sum(np.square(matrix1), axis=1, keepdims=True)
    d3 = np.sum(np.square(matrix2), axis=1)
    return np.sqrt(np.maximum(d1 + d2 + d3, 0.0))


def calculate_top_k(sorted_idx: np.ndarray, top_k: int) -> np.ndarray:
    """Cumulative 'ground-truth index within the first k columns' flags."""
    size = sorted_idx.shape[0]
    gt = np.arange(size)[:, None]
    bool_mat = sorted_idx == gt
    correct = np.zeros(size, dtype=bool)
    cols = []
    for i in range(top_k):
        correct = correct | bool_mat[:, i]
        cols.append(correct[:, None].copy())
    return np.concatenate(cols, axis=1)


def calculate_r_precision(embedding1, embedding2, top_k: int, sum_all: bool = False):
    dist = euclidean_distance_matrix(embedding1, embedding2)
    top_k_mat = calculate_top_k(np.argsort(dist, axis=1), top_k)
    return top_k_mat.sum(axis=0) if sum_all else top_k_mat


def calculate_matching_score(embedding1, embedding2, sum_all: bool = False):
    assert embedding1.shape == embedding2.shape and embedding1.ndim == 2
    dist = linalg.norm(embedding1 - embedding2, axis=1)
    return dist.sum(axis=0) if sum_all else dist


def calculate_activation_statistics(activations: np.ndarray):
    return np.mean(activations, axis=0), np.cov(activations, rowvar=False)


def calculate_diversity(activation: np.ndarray, diversity_times: int, rng=None) -> float:
    assert activation.ndim == 2 and activation.shape[0] > diversity_times
    rng = rng or np.random
    n = activation.shape[0]
    first = rng.choice(n, diversity_times, replace=False)
    second = rng.choice(n, diversity_times, replace=False)
    return float(linalg.norm(activation[first] - activation[second], axis=1).mean())


def calculate_multimodality(activation: np.ndarray, multimodality_times: int, rng=None) -> float:
    assert activation.ndim == 3 and activation.shape[1] > multimodality_times
    rng = rng or np.random
    per = activation.shape[1]
    first = rng.choice(per, multimodality_times, replace=False)
    second = rng.choice(per, multimodality_times, replace=False)
    return float(linalg.norm(activation[:, first] - activation[:, second], axis=2).mean())


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between Gaussians (Dougal Sutherland's stable formulation)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))
