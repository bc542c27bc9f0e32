"""Data-parallel SVGP minibatch training over a mesh axis.

Port of ``gpras_tpu/parallel/psvgp.py``. The SVGP bound (``gp/svgp.py``)
decomposes over data points, so a global minibatch is split over the ranks
of one axis and the O(M^2 + M D) parameters are held whole on every rank.
Each rank differentiates its rows' part of the data term, scaled by
n_total / B for the global batch B; one all-reduce sums those gradients
(and the loss), where the reference's SPMD partitioner inserts the ``psum``;
the KL and the log prior are computed on every rank. With ``natgrad`` (as
``gp/svgp``'s trainers take it) the natural-gradient step's batch sums
A A^T and A y are all-reduced first, so every rank takes the same step. The
Adam update is ``gp/svgp``'s (optax's, eps 1e-8); the reference's
``optimizer`` argument (any optax transformation) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from gpras_tpu_torch.fit.optimizers import _adam_update, value_and_grad
from gpras_tpu_torch.gp import svgp
from gpras_tpu_torch.gp.priors import log_prior
from gpras_tpu_torch.parallel.mesh import _index, _psum_all, _size

Tensor = torch.Tensor
Params = dict[str, Tensor]


def shard_batch(mesh: DeviceMesh, xb, yb, axis: str = "dp"):
    """This rank's rows of a global batch (``xb``, ``yb``, whole on every
    rank): the global batch size must divide by the axis size."""
    ndev = _size(mesh, axis)
    if xb.shape[0] % ndev:
        raise ValueError(
            f"global batch {xb.shape[0]} not divisible by mesh axis "
            f"{axis!r} size {ndev}")
    rows = xb.shape[0] // ndev
    r0 = _index(mesh, axis) * rows
    return xb[r0:r0 + rows], yb[r0:r0 + rows]


def make_dp_minibatch_step(mesh: DeviceMesh, kernel: str, n_total: int,
                           learning_rate: float = 0.01, axis: str = "dp",
                           natgrad: float | None = None):
    """(init, step) for one data-parallel SVGP step:
    ``step(params, opt_state, x_batch, y_batch) -> (params, opt_state, loss)``
    with this rank's rows of the global batch (:func:`shard_batch`) and the
    parameters whole; the loss is the global batch's
    ``gp/svgp.training_loss``, the same on every rank. ``natgrad`` (e.g.
    0.5) adds ``gp/svgp``'s natural-gradient step on q before the Adam step
    on everything else, as its trainers do."""
    d = _size(mesh, axis)

    def init(params: Params):
        return svgp._adam_init(params)

    def step(params: Params, opt_state, xb: Tensor, yb: Tensor):
        y2 = yb[:, None] if yb.ndim == 1 else yb
        scale = svgp._data_scale(n_total, y2.shape[0] * d, y2.dtype)
        p = {k: v.detach() for k, v in params.items()}
        if natgrad is not None:
            with torch.no_grad():
                aat, ay = _psum_all(list(svgp._natgrad_stats(kernel, p, xb, y2)), mesh, axis)
                p = svgp._natgrad_update(p, aat, ay, scale, natgrad)
        names = list(p)
        data, g_data = value_and_grad(
            lambda q: -(scale * svgp._expected_loglik(kernel, q, xb, y2)), p)
        data, *g_sum = _psum_all([data] + [g_data[k] for k in names], mesh, axis)
        rest, g_rest = value_and_grad(lambda q: svgp.kl_to_prior(q) - log_prior(q), p)
        loss = data + rest
        grads = {k: g + g_rest[k] for k, g in zip(names, g_sum)}
        if natgrad is not None:
            grads = {k: (torch.zeros_like(v) if k in svgp.Q_LEAVES else v)
                     for k, v in grads.items()}
        updates, opt_state = _adam_update(grads, opt_state, learning_rate,
                                          svgp.ADAM_B1, svgp.ADAM_B2, svgp.ADAM_EPS)
        return {k: v + updates[k] for k, v in p.items()}, opt_state, loss

    return init, step


def dp_minibatch_fit(mesh: DeviceMesh, kernel: str, params: Params, x: np.ndarray,
                     y: np.ndarray, *, batch_size: int, epochs: int,
                     learning_rate: float = 0.01, axis: str = "dp", seed: int = 0,
                     natgrad: float | None = None):
    """Data-parallel SVGP fit over whole host arrays: each epoch permutes
    the N points on the host (``numpy.random.default_rng(seed)``, the same
    on every rank, as the reference), walks the global batches, and applies
    :func:`make_dp_minibatch_step` to this rank's rows of each. Returns
    ``(params, epoch_mean_losses)``, the losses as a numpy array."""
    n = x.shape[0]
    nb = n // batch_size
    if nb == 0:
        raise ValueError(f"batch_size {batch_size} exceeds dataset size {n}")
    init, step = make_dp_minibatch_step(mesh, kernel, n_total=n,
                                        learning_rate=learning_rate, axis=axis,
                                        natgrad=natgrad)
    ref = params["log_variance"]
    opt_state = init(params)
    rng = np.random.default_rng(seed)
    hist = []
    for _ in range(epochs):
        perm = rng.permutation(n)[: nb * batch_size]
        losses = []
        for i in range(nb):
            sl = perm[i * batch_size:(i + 1) * batch_size]
            xb, yb = shard_batch(mesh, x[sl], y[sl], axis)
            params, opt_state, loss = step(
                params, opt_state, torch.as_tensor(xb, dtype=ref.dtype, device=ref.device),
                torch.as_tensor(yb, dtype=ref.dtype, device=ref.device))
            losses.append(loss)
        hist.append(float(torch.mean(torch.stack(losses))))
    return params, np.asarray(hist)
