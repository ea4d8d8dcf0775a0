"""FID, the Fréchet Inception Distance (counterpart of
bem_tpu/metrics/fid.py; reference basicsr/metrics/fid.py).

The Fréchet distance between two Gaussians is self-contained (scipy's
``sqrtm``); the InceptionV3 feature extractor needs pretrained weights,
which no machine of this project can download, so it raises as
bem_tpu's does. As in bem_tpu, importing this module registers
``calculate_fid`` as a ``val.metrics`` type; the metrics package does not
import it.
"""

from __future__ import annotations

import os

import numpy as np
from scipy import linalg

from . import METRICS


def calculate_fid_from_stats(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between N(mu1, sigma1) and N(mu2, sigma2)
    (fid.py calculate_fid): |mu1 - mu2|^2 + tr(s1 + s2 - 2 sqrt(s1 s2)),
    the product's square root taken again with ``eps`` on the diagonals
    where it is not finite."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean, _ = linalg.sqrtm(sigma1.dot(sigma2), disp=False)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def extract_inception_features(images: np.ndarray) -> np.ndarray:
    """(N, H, W, 3) [0,1] -> (N, 2048) pool3 features: needs InceptionV3
    weights, so it raises (with ``BEM_INCEPTION_WEIGHTS`` unset or missing,
    as bem_tpu; with it set, because the extractor is not wired)."""
    path = os.environ.get("BEM_INCEPTION_WEIGHTS")
    if not path or not os.path.exists(path):
        raise RuntimeError(
            "FID needs InceptionV3 weights: set BEM_INCEPTION_WEIGHTS to a "
            "converted .npz (zero-egress environments cannot download them).")
    raise NotImplementedError(
        "InceptionV3 feature extractor wiring lands with the converted "
        "weights; use calculate_fid_from_stats with precomputed features.")


def calculate_fid(feats1: np.ndarray, feats2: np.ndarray, **kwargs) -> float:
    """FID of two feature sets (N, D): their means and covariances."""
    mu1, sigma1 = np.mean(feats1, axis=0), np.cov(feats1, rowvar=False)
    mu2, sigma2 = np.mean(feats2, axis=0), np.cov(feats2, rowvar=False)
    return calculate_fid_from_stats(mu1, sigma1, mu2, sigma2)


METRICS["calculate_fid"] = calculate_fid
