"""FID and Inception Score math on features (port of the numpy part of
qdiffusion_tpu/metrics/fid.py:26-79).

The metrics take features from any fixed feature map: FID compares two
sets only when one extractor scores both. No torch is needed. The
Inception extractor (its weights are external) and `fid_between_dirs`
(it reads images with PIL) are not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Array = np.ndarray


def compute_statistics(features: Array) -> Tuple[Array, Array]:
    """(N, D) features -> (mean, covariance), float64."""
    features = np.asarray(features, np.float64)
    return features.mean(axis=0), np.cov(features, rowvar=False)


def frechet_distance(mu1: Array, sigma1: Array, mu2: Array, sigma2: Array,
                     eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians (the standard FID formula).
    A singular product gets eps on both diagonals and a second square
    root; the root's imaginary part (round-off) is dropped. Works with
    SciPy's sqrtm with and without its `disp` argument."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    try:
        covmean, _ = linalg.sqrtm(sigma1.dot(sigma2), disp=False)
    except TypeError:  # SciPy releases without sqrtm's `disp`
        covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(feats1: Array, feats2: Array) -> float:
    mu1, s1 = compute_statistics(feats1)
    mu2, s2 = compute_statistics(feats2)
    return frechet_distance(mu1, s1, mu2, s2)


def inception_score_from_logits(logits: Array,
                                splits: int = 10) -> Tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))) over `splits` chunks: (mean, std)."""
    logits = np.asarray(logits, np.float64)
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    scores = []
    for chunk in np.array_split(probs, splits):
        marginal = chunk.mean(axis=0, keepdims=True)
        kl = (chunk * (np.log(chunk + 1e-16)
                       - np.log(marginal + 1e-16))).sum(1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))
