"""Distributed exact-GP NLML over a mesh, with factor-reusing backward passes.

Port of ``gpras_tpu/parallel/pexact.py``. The forward composes the sharded
Gram (``pgram``), the distributed Cholesky and its solves (``pcholesky`` on
row strips, ``pcholesky2d`` on (i, j) tiles) into the exact GP marginal
likelihood. The reference's ``jax.custom_vjp`` objectives become
``torch.autograd.Function``s whose backward issues its collectives itself:

    dNLML/dK = 0.5 (K^-1 - alpha alpha^T)

``make_dist_nlml`` rebuilds K^-1 in column batches by distributed solves
against identity columns with the forward's factor;
``make_dist_nlml_stochastic`` replaces K^-1 by the Hutchinson estimate
(1/m) W Z^T, W = K^-1 Z, from one distributed solve of the (N, m) probes.
Each column batch's cotangent is contracted against this rank's part of the
Gram (its rows, or its (i, j) tile) by autograd through ``ops/kernels.gram``
on this rank alone; the sum over ranks is one ``all_reduce`` of the
accumulated gradient at the end (over "i", and over "j" too on the 2-D
layout), where shard_map's pullback toward the replicated parameters
inserts it in the reference. The noise and jitter diagonal's part comes from
the cotangent's diagonal, which every rank holds whole, and is added after
that reduction.

Calling convention: ``params``, ``x`` (N, D), ``y`` (N,) and the probes are
whole on every rank; the factor stays sharded (this rank's strip or tile).
Randomness is an input: the Hutchinson objective takes its (N, m) probes
``z`` where the reference takes a PRNG key.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh

from gpras_tpu_torch.fit.optimizers import _adam_update, value_and_grad
from gpras_tpu_torch.gp.svgp import _adam_init
from gpras_tpu_torch.ops import linalg
from gpras_tpu_torch.parallel.mesh import _index, _psum_all, _shape, _size
from gpras_tpu_torch.parallel.pcholesky import (
    dist_cho_solve,
    dist_cholesky_local,
    dist_logdet_from_chol,
)
from gpras_tpu_torch.parallel.pcholesky2d import (
    dist_cho_solve_2d,
    dist_cholesky_2d_local,
    dist_logdet_from_chol_2d,
)
from gpras_tpu_torch.parallel.pgram import _gram_vjp, pgram_2d, pgram_rows

Tensor = torch.Tensor

#: optax.adam's defaults, the reference's distributed step
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def resolve_layout(mesh: DeviceMesh, layout: str = "auto") -> str:
    """``"auto"`` -> ``"2d"`` on a true 2-D mesh (axes "i" and "j", both
    larger than one), else ``"1d"``."""
    if layout != "auto":
        return layout
    shape = _shape(mesh)
    if shape.get("i", 1) > 1 and shape.get("j", 1) > 1:
        return "2d"
    return "1d"


def _noise_plus_jitter(params: dict[str, Tensor], dtype: torch.dtype) -> Tensor:
    return torch.exp(params["log_noise_variance"]) + \
        linalg.default_jitter(dtype) * torch.exp(params["log_variance"])


@torch.no_grad()
def dist_nlml_forward(mesh: DeviceMesh, kernel: str, params: dict[str, Tensor],
                      x: Tensor, y: Tensor, b: int = 128, layout: str = "auto"):
    """(nlml, (l, alpha)): the NLML on every rank, this rank's part of the
    factor (its row strip on ``"1d"``, its (i, j) tile on ``"2d"``) and
    alpha = K^-1 y whole on every rank. ``y`` must be one output column
    (N,): for several modes, call it once per mode. No autograd (the
    objectives of ``make_dist_nlml*`` differentiate it)."""
    if y.ndim != 1:
        raise ValueError(f"dist_nlml expects y of shape (N,), got {tuple(y.shape)}; "
                         "map over output modes instead")
    layout = resolve_layout(mesh, layout)
    n = x.shape[0]
    noise = _noise_plus_jitter(params, x.dtype)
    if layout == "2d":
        from gpras_tpu_torch.parallel.pcholesky2d import _check_divisible_2d

        _check_divisible_2d(n, _size(mesh, "i"), _size(mesh, "j"), b)
        l = dist_cholesky_2d_local(mesh, pgram_2d(mesh, kernel, params, x, noise=noise), b)
        alpha = dist_cho_solve_2d(mesh, l, y, b=b)
        logdet = dist_logdet_from_chol_2d(mesh, l)
    elif layout == "1d":
        from gpras_tpu_torch.parallel.pcholesky import _check_divisible

        _check_divisible(n, _size(mesh, "i"), b)
        l = dist_cholesky_local(mesh, pgram_rows(mesh, kernel, params, x, noise=noise), b)
        alpha = dist_cho_solve(mesh, l, y, b=b)
        logdet = dist_logdet_from_chol(mesh, l)
    else:
        raise ValueError(f"unknown layout {layout!r}; expected '1d' or '2d'")
    nlml = 0.5 * torch.dot(y, alpha) + 0.5 * logdet + 0.5 * n * math.log(2.0 * math.pi)
    return nlml, (l, alpha)


def _column_batch(n: int, col_batch: int, dj: int) -> int:
    """The largest c <= col_batch dividing N and a multiple of the "j" axis."""
    c = min(col_batch, n)
    while c >= dj and (n % c != 0 or c % dj != 0):
        c -= 1
    if c < dj or n % c != 0 or c % dj != 0:
        raise ValueError(
            f"no column batch <= {col_batch} divides N={n} and is a "
            f"multiple of the mesh 'j' axis ({dj}); raise col_batch")
    return c


def _finish_grads(grads: dict[str, Tensor], params: dict[str, Tensor], diag_sum: Tensor,
                  dtype: torch.dtype) -> dict[str, Tensor]:
    """Add the noise and jitter diagonal: sum_i Kbar_ii d(noise + jitter)."""
    grads["log_noise_variance"] = grads["log_noise_variance"] + \
        diag_sum * torch.exp(params["log_noise_variance"])
    grads["log_variance"] = grads["log_variance"] + \
        diag_sum * linalg.default_jitter(dtype) * torch.exp(params["log_variance"])
    return grads


class _DistNLML(torch.autograd.Function):
    """The distributed NLML over ``values`` (named ``names``). ``probes`` is
    None for the exact backward (K^-1 by distributed solves against identity
    columns), else the (N, m) Hutchinson probes."""

    @staticmethod
    def forward(ctx, mesh, kernel, b, col_batch, layout, names, x, y, probes, *values):
        params = dict(zip(names, values))
        out, (l, alpha) = dist_nlml_forward(mesh, kernel, params, x, y, b=b, layout=layout)
        ctx.mesh, ctx.kernel, ctx.b, ctx.col_batch, ctx.layout, ctx.names = \
            mesh, kernel, b, col_batch, layout, names
        ctx.stochastic = probes is not None
        ctx.save_for_backward(x, l, alpha, *(() if probes is None else (probes,)), *values)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, layout = ctx.mesh, ctx.layout
        saved = ctx.saved_tensors
        x, l, alpha = saved[:3]
        z = saved[3] if ctx.stochastic else None
        values = saved[4:] if ctx.stochastic else saved[3:]
        params = dict(zip(ctx.names, values))
        g = g.to(x.dtype)
        n = x.shape[0]
        dj = _size(mesh, "j") if layout == "2d" else 1
        c = _column_batch(n, ctx.col_batch, dj)
        if layout == "2d":
            solve = lambda rhs: dist_cho_solve_2d(mesh, l, rhs, b=ctx.b)
        else:
            solve = lambda rhs: dist_cho_solve(mesh, l, rhs, b=ctx.b)
        # this rank's part of each column batch: its rows and, on "2d", its
        # share (c/dj) of the batch's columns
        nr = n // _size(mesh, "i")
        rows = slice(_index(mesh, "i") * nr, (_index(mesh, "i") + 1) * nr)
        cw = c // dj
        cj = _index(mesh, "j") * cw if layout == "2d" else 0
        acc = {k: torch.zeros_like(v) for k, v in params.items()}
        diag_sum = torch.zeros((), dtype=x.dtype, device=x.device)
        if z is not None:
            w = solve(z)  # one distributed (N, m) solve: K^-1 Z
            inv_m = 1.0 / z.shape[1]
        with torch.no_grad():
            for c0 in range(0, n, c):
                cols = slice(c0, c0 + c)
                if z is None:
                    eye_cols = torch.zeros((n, c), dtype=x.dtype, device=x.device)
                    eye_cols[cols].fill_diagonal_(1.0)
                    kinv_cols = solve(eye_cols)  # (N, c) = K^-1 cols
                else:
                    kinv_cols = inv_m * (w @ z[cols].mT)  # rank-m estimate, no solve
                kbar_cols = 0.5 * g * (kinv_cols - alpha[:, None] * alpha[cols][None, :])
                diag_sum += torch.sum(kbar_cols[cols].diagonal())
                part = _gram_vjp(ctx.kernel, params, x[rows], x[c0 + cj:c0 + cj + cw],
                                 kbar_cols[rows, cj:cj + cw])
                for k in acc:
                    acc[k] += part[k]
        # the sum over the ranks the Gram is sharded on, once
        summed = _psum_all(list(acc.values()), mesh, ("i", "j") if layout == "2d" else "i")
        grads = _finish_grads(dict(zip(acc, summed)), params, diag_sum, x.dtype)
        y_grad = g * alpha if ctx.needs_input_grad[7] else None
        return (None,) * 7 + (y_grad, None) + tuple(grads[k] for k in ctx.names)


def _objective(mesh, kernel, b, col_batch, layout, params, x, y, probes):
    names = tuple(params)
    return _DistNLML.apply(mesh, kernel, b, col_batch, layout, names, x, y, probes,
                           *(params[k] for k in names))


def make_dist_nlml(mesh: DeviceMesh, kernel: str, b: int = 128, col_batch: int = 256,
                   layout: str = "auto"):
    """Returns ``nlml(params, x, y)``, differentiable with respect to the
    parameters and y, with the factor-reusing exact backward. ``x`` (N, D)
    and ``y`` (N,) whole on every rank; the value and the gradients come out
    the same on every rank. ``layout="2d"`` runs the forward on the (i, j)
    tiles, the backward's solves in that layout, and the contraction tiled:
    rank (a, b) contracts its (N/di, c/dj) cotangent tile against
    gram(x_rows_a, x_cols_b)."""
    layout = resolve_layout(mesh, layout)

    def nlml(params: dict[str, Tensor], x: Tensor, y: Tensor) -> Tensor:
        return _objective(mesh, kernel, b, col_batch, layout, params, x, y, None)

    return nlml


def make_dist_nlml_stochastic(mesh: DeviceMesh, kernel: str, b: int = 128,
                              col_batch: int = 256, layout: str = "auto", probes: int = 16):
    """Returns ``nlml(params, x, y, z)``: the distributed NLML with the
    Hutchinson stochastic-trace backward. ``z`` is the (N, ``probes``)
    probe matrix, whole on every rank (the reference draws Rademacher
    probes from a key inside). One distributed solve W = K^-1 Z, then the
    rank-(m + 1) cotangent 0.5 g [(1/m) W Z^T - alpha alpha^T] is contracted
    column batch by column batch, as in :func:`make_dist_nlml`. The value is
    exact; the gradient is unbiased over the probes."""
    layout = resolve_layout(mesh, layout)

    def nlml(params: dict[str, Tensor], x: Tensor, y: Tensor, z: Tensor) -> Tensor:
        if z.shape[1] != probes:
            raise ValueError(f"made for {probes} probes, got {z.shape[1]}")
        return _objective(mesh, kernel, b, col_batch, layout, params, x, y, z)

    return nlml


def make_dist_fit_step(mesh: DeviceMesh, kernel: str, b: int = 128,
                       learning_rate: float = 0.01, layout: str = "auto",
                       backward: str = "exact", probes: int = 16):
    """(init, step) for one Adam step (optax's update, eps 1e-8) on the
    distributed NLML: ``step(params, opt_state, x, y)`` ->
    ``(params, opt_state, loss)``. ``backward="hutchinson"`` takes the
    stochastic-trace backward: ``step(params, opt_state, x, y, z)`` with this
    step's (N, ``probes``) probes (the reference's step draws them from a key
    it takes and returns). Every rank holds the same parameters throughout."""
    if backward == "hutchinson":
        nlml = make_dist_nlml_stochastic(mesh, kernel, b=b, layout=layout, probes=probes)
    elif backward == "exact":
        base = make_dist_nlml(mesh, kernel, b=b, layout=layout)
        nlml = lambda p, x, y, *rest: base(p, x, y)
    else:
        raise ValueError(f"unknown backward {backward!r}; expected 'exact' or 'hutchinson'")

    def init(params: dict[str, Tensor]) -> Any:
        return _adam_init(params)

    def step(params: dict[str, Tensor], opt_state, x: Tensor, y: Tensor, *probes_in: Tensor):
        loss, grads = value_and_grad(lambda p: nlml(p, x, y, *probes_in), params)
        updates, opt_state = _adam_update(grads, opt_state, learning_rate,
                                          ADAM_B1, ADAM_B2, ADAM_EPS)
        return {k: v + updates[k] for k, v in params.items()}, opt_state, loss

    return init, step
