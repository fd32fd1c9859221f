"""Least-squares transform estimation from point correspondences.

Counterpart of ``biahub_tpu/transforms/fitting.py`` (numpy, float64):
euclidean and similarity fits by the Umeyama algorithm, affine by plain
homogeneous least squares. Point arrays are (N, D) in ZYX order.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fit_affine", "fit_euclidean", "fit_similarity", "fit_transform"]


def _homogeneous(points: np.ndarray) -> np.ndarray:
    return np.hstack([points, np.ones((points.shape[0], 1))])


def fit_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Full affine: dst ≈ A @ src + t. Returns (D+1)x(D+1) homogeneous matrix."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    d = src.shape[1]
    coeffs, *_ = np.linalg.lstsq(_homogeneous(src), dst, rcond=None)
    out = np.eye(d + 1)
    out[:d, :d] = coeffs[:d].T
    out[:d, d] = coeffs[d]
    return out


def _umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool) -> np.ndarray:
    """Umeyama (1991) closed-form rigid/similarity fit."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    n, d = src.shape
    mu_src = src.mean(axis=0)
    mu_dst = dst.mean(axis=0)
    src_c = src - mu_src
    dst_c = dst - mu_dst

    cov = dst_c.T @ src_c / n
    u, s, vt = np.linalg.svd(cov)
    sign = np.ones(d)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sign[-1] = -1.0
    rot = u @ np.diag(sign) @ vt

    if with_scale:
        var_src = (src_c**2).sum() / n
        scale = (s * sign).sum() / var_src if var_src > 0 else 1.0
    else:
        scale = 1.0

    out = np.eye(d + 1)
    out[:d, :d] = scale * rot
    out[:d, d] = mu_dst - scale * rot @ mu_src
    return out


def fit_euclidean(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Rigid (rotation + translation) fit."""
    return _umeyama(src, dst, with_scale=False)


def fit_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Similarity (isotropic scale + rotation + translation) fit."""
    return _umeyama(src, dst, with_scale=True)


def fit_transform(
    src: np.ndarray, dst: np.ndarray, transform_type: str = "euclidean"
) -> np.ndarray:
    """Fit the named transform type; returns a homogeneous matrix."""
    if transform_type == "affine":
        return fit_affine(src, dst)
    if transform_type == "euclidean":
        return fit_euclidean(src, dst)
    if transform_type == "similarity":
        return fit_similarity(src, dst)
    raise ValueError(f"Unknown transform type: {transform_type}")
