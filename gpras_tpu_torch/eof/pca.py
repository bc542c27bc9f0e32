"""PCA/EOF decomposition on the port's device.

Port of ``gpras_tpu/eof/pca.py``. For cells >> samples the (S, S) sample Gram
``x x^T`` is eigendecomposed and the spatial EOFs come back through one
(C, S) @ (S, k) matmul (Gram trick); otherwise the (F, F) covariance is
(covariance trick). Sign convention as sklearn's ``svd_flip``: each
component's largest-|loading| entry is made positive.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def pca_fit(x: Tensor, n_components: int | None = None) -> tuple[Tensor, Tensor]:
    """PCA of pre-centered ``x`` (samples, features), computed where ``x`` lies.

    Returns (components (k, features), explained_variance (k,)) with
    ``explained_variance = eigenvalue / (n_samples - 1)``."""
    s, f = x.shape
    k = min(s, f) if n_components is None else min(n_components, min(s, f))
    if s <= f:
        evals, evecs = torch.linalg.eigh(x @ x.T)  # ascending
        evals = evals.flip(0)[:k]
        u = evecs.flip(1)[:, :k]  # (S, k)
        sigma = torch.sqrt(torch.clamp_min(evals, 1e-30))
        comps = (x.T @ (u / sigma[None, :])).T  # (k, F)
        # the centered input's ~0 eigenvalue would amplify noise into a
        # garbage component: zero such rows (their explained variance is ~0)
        rank_ok = evals > 1e-12 * torch.clamp_min(evals[0], 1e-30)
        comps = torch.where(rank_ok[:, None], comps, 0.0)
    else:
        evals, evecs = torch.linalg.eigh(x.T @ x)
        evals = evals.flip(0)[:k]
        comps = evecs.flip(1)[:, :k].T  # (k, F)
    explained = torch.clamp_min(evals, 0.0) / (s - 1)
    idx = torch.argmax(torch.abs(comps), dim=1)
    signs = torch.sign(comps[torch.arange(comps.shape[0], device=comps.device), idx])
    signs = torch.where(signs == 0, 1.0, signs)
    return comps * signs[:, None], explained


def pca_fit_reference(x, n_components: int | None = None):
    """Pure-numpy mirror of :func:`pca_fit` (same trick, rank guard and sign
    convention): the host reference the device path is tested against."""
    x = np.asarray(x)
    s, f = x.shape
    k = min(s, f) if n_components is None else min(n_components, min(s, f))
    if s <= f:
        evals, evecs = np.linalg.eigh(x @ x.T)
        evals = evals[::-1][:k]
        u = evecs[:, ::-1][:, :k]
        sigma = np.sqrt(np.maximum(evals, 1e-30))
        comps = (x.T @ (u / sigma[None, :])).T
        rank_ok = evals > 1e-12 * max(float(evals[0]) if k else 0.0, 1e-30)
        comps = np.where(rank_ok[:, None], comps, 0.0)
    else:
        evals, evecs = np.linalg.eigh(x.T @ x)
        evals = evals[::-1][:k]
        comps = evecs[:, ::-1][:, :k].T
    explained = np.maximum(evals, 0.0) / (s - 1)
    idx = np.argmax(np.abs(comps), axis=1)
    signs = np.sign(comps[np.arange(comps.shape[0]), idx])
    signs = np.where(signs == 0, 1.0, signs)
    return comps * signs[:, None], explained
