"""Hybrid data x model parallel training over a 3-axis ("dp", "i", "j") mesh.

Port of ``gpras_tpu/parallel/hybrid.py``. The surrogate is a stack of
independent per-EOF-mode GPs over one input matrix, so the mode axis needs
no communication inside a step: axis "dp" splits the modes, and within each
"dp" slice the (N, N) Gram of every local mode is tiled over ("i", "j") and
factored by the 2-D engine's per-rank bodies (``pcholesky2d``), whose
collectives run over "i" and "j" only. Gradients use the Hutchinson
rank-(m + 1) cotangent: one (N, 1 + m) distributed solve gives alpha and
W = K^-1 Z, and Kbar = 0.5 [(1/m) W Z^T - alpha alpha^T] is contracted
against this rank's Gram tile by autograd through ``ops/kernels.gram``, its
sum over the (i, j) plane one all-reduce per axis.

Calling convention: the mode axis is this rank's share of the modes (the
reference's ``P("dp")``): ``params_b`` (P/ddp, ...), ``y_modes``
(N, P/ddp) and the probes (P/ddp, N, m); ``x`` (N, D) is whole on every
rank. Randomness is an input: each mode's probes come in, where the
reference folds a key with the global mode index.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh

from gpras_tpu_torch.fit.optimizers import _adam_update
from gpras_tpu_torch.gp.svgp import _adam_init
from gpras_tpu_torch.ops import kernels as K
from gpras_tpu_torch.ops import linalg
from gpras_tpu_torch.parallel.mesh import _index, _psum_all, _shape, _size
from gpras_tpu_torch.parallel.pcholesky2d import (
    dist_cholesky_2d_local,
    dist_solve_lower_2d_local,
    dist_solve_upper_2d_local,
)
from gpras_tpu_torch.parallel.pexact import ADAM_B1, ADAM_B2, ADAM_EPS
from gpras_tpu_torch.parallel.pgram import _gram_vjp

Tensor = torch.Tensor

AXES = ("dp", "i", "j")


def check_hybrid_shapes(mesh: DeviceMesh, n: int, p_modes: int, b: int,
                        axes: tuple[str, str, str] = AXES) -> None:
    """Raise ValueError unless ``mesh`` has the three axes, the ``p_modes``
    modes divide over "dp", and b divides both local extents of N."""
    adp, ai, aj = axes
    shape = _shape(mesh)
    for a in axes:
        if a not in shape:
            raise ValueError(f"hybrid step needs mesh axis {a!r}; "
                             f"mesh has {tuple(shape)}")
    ddp, di, dj = shape[adp], shape[ai], shape[aj]
    if p_modes % ddp != 0:
        raise ValueError(f"P={p_modes} modes must divide mesh axis "
                         f"{adp!r}={ddp}")
    if n % di != 0 or n % dj != 0:
        raise ValueError(f"N={n} must divide by mesh axes ({di}, {dj})")
    if (n // di) % b != 0 or (n // dj) % b != 0:
        raise ValueError(
            f"block size {b} must divide both local extents "
            f"({n // di} rows, {n // dj} cols)")


def _one_mode(mesh: DeviceMesh, kernel: str, p: dict[str, Tensor], x: Tensor, y_col: Tensor,
              z: Tensor, b: int, axes: tuple[str, str]) -> tuple[Tensor, dict[str, Tensor]]:
    """One mode's NLML and Hutchinson gradient on this rank's (i, j) tile."""
    ai, aj = axes
    n = x.shape[0]
    nr, nc = n // _size(mesh, ai), n // _size(mesh, aj)
    r0, c0 = _index(mesh, ai) * nr, _index(mesh, aj) * nc
    x_rows, x_cols = x[r0:r0 + nr], x[c0:c0 + nc]
    jit = linalg.default_jitter(x.dtype)
    with torch.no_grad():
        noise = torch.exp(p["log_noise_variance"]) + jit * torch.exp(p["log_variance"])
        k_tile = K.gram(kernel, p, x_rows, x_cols)
        k_tile.diagonal(offset=r0 - c0).add_(noise)
        l_loc = dist_cholesky_2d_local(mesh, k_tile, b, axes)
        # one (N, 1 + m) distributed solve: alpha = K^-1 y, W = K^-1 Z
        rhs = torch.cat([y_col[:, None], z], dim=1)
        sol = dist_solve_upper_2d_local(mesh, l_loc, dist_solve_lower_2d_local(
            mesh, l_loc, rhs, b, axes), b, axes)
        alpha, w = sol[:, 0], sol[:, 1:]
        # the rank-(m + 1) cotangent, this rank's tile of it
        kbar = 0.5 * ((w[r0:r0 + nr] @ z[c0:c0 + nc].mT) / z.shape[1]
                      - alpha[r0:r0 + nr, None] * alpha[None, c0:c0 + nc])
        diag = torch.sum(kbar.diagonal(offset=r0 - c0))
        logs = torch.sum(torch.log(l_loc.diagonal(offset=r0 - c0)))
    local = _gram_vjp(kernel, p, x_rows, x_cols, kbar)
    *summed, diag_sum, logs = _psum_all(list(local.values()) + [diag, logs], mesh, axes)
    grads = dict(zip(local, summed))
    logdet = 2.0 * logs
    grads["log_noise_variance"] = grads["log_noise_variance"] + \
        diag_sum * torch.exp(p["log_noise_variance"])
    grads["log_variance"] = grads["log_variance"] + \
        diag_sum * jit * torch.exp(p["log_variance"])
    loss = 0.5 * torch.dot(y_col, alpha) + 0.5 * logdet + 0.5 * n * math.log(2.0 * math.pi)
    return loss, grads


def make_hybrid_nlml_and_grads(mesh: DeviceMesh, kernel: str, b: int = 128,
                               probes: int = 16, axes: tuple[str, str, str] = AXES):
    """Returns ``fn(params_b, x, y_modes, z) -> (losses, grads)`` for this
    rank's modes: ``params_b`` with a leading local-mode axis, ``x`` (N, D)
    whole, ``y_modes`` (N, P/ddp), ``z`` (P/ddp, N, ``probes``) each local
    mode's probes. ``losses`` (P/ddp,) are the NLML values (no prior, as
    ``pexact.make_dist_nlml``); ``grads`` has ``params_b``'s layout and
    holds the unbiased Hutchinson gradients. Every rank of a "dp" slice
    returns the same values."""
    adp, ai, aj = axes

    def nlml_and_grads(params_b: dict[str, Tensor], x: Tensor, y_modes: Tensor, z: Tensor):
        n, pm = y_modes.shape
        check_hybrid_shapes(mesh, n, pm * _shape(mesh).get(adp, 1), b, axes)
        if tuple(z.shape) != (pm, n, probes):
            raise ValueError(f"probes of shape {tuple(z.shape)}, expected {(pm, n, probes)}")
        losses, grads = [], []
        for i in range(pm):
            loss, gr = _one_mode(mesh, kernel, {k: v[i] for k, v in params_b.items()}, x,
                                 y_modes[:, i], z[i], b, (ai, aj))
            losses.append(loss)
            grads.append(gr)
        return torch.stack(losses), {k: torch.stack([g[k] for g in grads]) for k in params_b}

    return nlml_and_grads


def make_hybrid_fit_step(mesh: DeviceMesh, kernel: str, b: int = 128,
                         probes: int = 16, learning_rate: float = 0.01,
                         axes: tuple[str, str, str] = AXES):
    """One Adam step (optax's update, eps 1e-8) fitting this rank's modes at
    once on the hybrid layout: ``step(params_b, opt_state, x, y_modes, z) ->
    (params_b, opt_state, losses)``, with this step's probes ``z`` (the
    reference's step draws them from a key it takes and returns). The
    update is elementwise, so it needs no communication."""
    nlml_and_grads = make_hybrid_nlml_and_grads(mesh, kernel, b=b, probes=probes, axes=axes)

    def init(params_b: dict[str, Tensor]) -> Any:
        return _adam_init(params_b)

    def step(params_b: dict[str, Tensor], opt_state, x: Tensor, y_modes: Tensor, z: Tensor):
        losses, grads = nlml_and_grads(params_b, x, y_modes, z)
        updates, opt_state = _adam_update(grads, opt_state, learning_rate,
                                          ADAM_B1, ADAM_B2, ADAM_EPS)
        return {k: v + updates[k] for k, v in params_b.items()}, opt_state, losses

    return init, step
