"""k-means (k-means++ seeding + Lloyd iterations) and the grid inducing init.

Port of ``gpras_tpu/ops/kmeans.py``, the reference's inducing-point
initializers (gpras/gpr.py:310-320): ``kmeans`` stands in for sklearn's
KMeans(random_state=0); ``grid`` is a per-feature linspace between the
feature min and max, stacked as columns (M points along the bounding box's
diagonal, not a mesh, as the reference builds it).

The assignment step is one matmul (pairwise squared distances in matmul
form) and the update step a one-hot matmul (a fixed-order sum, where
``index_add_`` would add with atomics on the card). Lloyd's loop reads one
flag per iteration (did any label change). The seeding's uniforms come from
a ``torch.Generator``, drawn on the CPU, so the seeds are the same on every
device.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _pairwise_sqdist(x: Tensor, c: Tensor) -> Tensor:
    x2 = torch.sum(x * x, dim=1)[:, None]
    c2 = torch.sum(c * c, dim=1)[None, :]
    return torch.clamp_min(x2 + c2 - 2.0 * (x @ c.T), 0.0)


def _kmeans_pp_init(gen: torch.Generator, x: Tensor, k: int) -> Tensor:
    """k-means++ seeding: the first center uniform over the points, each next
    one drawn with probability proportional to its squared distance to the
    nearest center so far (inverse CDF of one uniform per center; the
    centers' indices stay on the device)."""
    n = x.shape[0]
    u = torch.rand((k,), generator=gen, dtype=torch.float64).to(device=x.device)
    first = torch.clamp_max((u[:1] * n).long(), n - 1)
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x.index_select(0, first)[0]
    d2 = _pairwise_sqdist(x, centers[:1])[:, 0]
    for i in range(1, k):
        cdf = torch.cumsum(d2.to(torch.float64), dim=0)
        idx = torch.clamp_max(torch.searchsorted(cdf, u[i:i + 1] * cdf[-1:], right=True), n - 1)
        c = x.index_select(0, idx)
        centers[i] = c[0]
        d2 = torch.minimum(d2, _pairwise_sqdist(x, c)[:, 0])
    return centers


def kmeans(x: Tensor, k: int, max_iter: int = 300, seed: int = 0,
           init: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Lloyd's algorithm; returns (centers (k, D), assignments (N,)).

    Starts from ``init`` when given, else from k-means++ seeds drawn from a
    generator seeded ``seed`` (the reference fixes random_state=0,
    gpras/gpr.py:313). Stops when no label changes or after ``max_iter``
    updates. Empty clusters keep their previous center."""
    centers = init if init is not None else _kmeans_pp_init(
        torch.Generator().manual_seed(seed), x, k)
    centers = centers.to(dtype=x.dtype, device=x.device)

    def assign(c: Tensor) -> Tensor:
        return torch.argmin(_pairwise_sqdist(x, c), dim=1)

    labels = assign(centers)
    for _ in range(max_iter):
        one_hot = torch.nn.functional.one_hot(labels, k).to(x.dtype)  # (N, k)
        counts = torch.sum(one_hot, dim=0)
        new = (one_hot.T @ x) / torch.clamp_min(counts, 1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, new, centers)
        new_labels = assign(centers)
        changed = bool(torch.any(new_labels != labels))
        labels = new_labels
        if not changed:
            break
    return centers, labels


def grid_inducing(x: Tensor, n_inducing: int) -> Tensor:
    """Per-feature linspace from min to max, stacked as columns (M, D): the
    reference's "grid" initializer (gpras/gpr.py:316-320)."""
    lo = torch.min(x, dim=0).values
    hi = torch.max(x, dim=0).values
    t = torch.linspace(0.0, 1.0, n_inducing, dtype=x.dtype, device=x.device)[:, None]
    return lo[None, :] + t * (hi - lo)[None, :]


def kmeans_inducing(x: Tensor, n_inducing: int, seed: int = 0) -> Tensor:
    """Inducing locations = k-means cluster centers (reference gpras/gpr.py:312-315)."""
    centers, _ = kmeans(x, n_inducing, seed=seed)
    return centers
