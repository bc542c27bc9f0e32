"""Cold exact-GP fits from the standard initialization.

Port of ``gpras_tpu/gp/coldfit.py``. The reference's only training loop is
fixed-lr Adam with a plateau rule (gpras/gpr.py:44-214), which needs
hundreds of full-N steps to converge from a cold start. This module
packages the cold protocol as one library call: L-BFGS with a strong-Wolfe
linesearch (``fit/optimizers``), over the engine the problem size calls
for:

- N < ``CG_THRESHOLD``: the Hutchinson stochastic-trace loss
  (``gp/exact_stochastic``), whose value is exact (the log-determinant comes
  from a Cholesky factor of the (N, N) Gram) and whose gradient's trace
  term is estimated from 16 probes.
- N >= ``CG_THRESHOLD``: the matrix-free CG + SLQ loss (``gp/exact_cg``;
  the Gram matrix never exists), run with a rank-128 pivoted-Cholesky
  preconditioner, a 256-iteration budget and a solver-validity residual
  gate. A shallow, unpreconditioned CG budget is not safe under a
  linesearch: L-BFGS finds hyperparameter regions where the truncated SLQ
  log-determinant is biased far below the physically possible NLML and
  walks into them. With the deep preconditioned budget the true-noise
  region solves inside the 0.1 gate, while the biased regions' residuals
  exceed it and become rejected trials.
- The CG engine evaluates through ``exact_cg.make_cg_step_chunked`` by
  default (``host_linesearch``): its mbcg iterations run in segments, and
  an evaluation stops once every column has converged to ``cg_stop_tol``
  (the early exit) or once the gate's verdict is decided (the gate abort).
  ``host_linesearch=False`` evaluates the same preconditioned, gated
  objective in one piece (``exact_cg.make_cg_training_loss``, every
  iteration of the budget, tolerance 1e-6).

Every path runs the one host L-BFGS core (``lbfgs_fit_hostls``): the JAX
package's device-side linesearch and its chunking are not ported (ROADMAP.md
deviations). The probes are fixed, so the objective is a deterministic
function of the parameters: Hutchinson randomizes only the gradient
estimator, and SLQ's quadrature is deterministic given its probes, so the
linesearch sees a deterministic objective and the trajectory reproduces.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from gpras_tpu_torch.fit.optimizers import (_apply_floors, lbfgs_fit_chunked,
                                            lbfgs_fit_hostls)
from gpras_tpu_torch.gp import exact, exact_cg, exact_stochastic

Tensor = torch.Tensor

#: At or above this N the matrix-free CG engine takes over from the
#: Hutchinson engine, whose (N, N) Gram and factor it never stores.
CG_THRESHOLD = 65536


def _draws(key, n: int, probes: int, precond_rank: int, dtype: torch.dtype, device):
    """The fixed probes: ``key`` itself when it is the draws, else drawn from
    ``key`` (a ``torch.Generator``; default: seeded 0)."""
    if key is not None and not isinstance(key, torch.Generator):
        return key
    if precond_rank > 0:
        return exact_cg.precond_probes(n, precond_rank, probes, dtype, device, gen=key)
    return exact_stochastic.rademacher_probes(n, probes, dtype, device, gen=key)


def fit_exact(
    kernel: str,
    x: Tensor,
    y: Tensor,
    *,
    engine: str = "auto",
    max_iter: int | None = None,
    chunk: int | None = None,
    memory_size: int = 15,
    max_linesearch_steps: int | None = None,
    tol: float = 1e-5,
    patience: int = 10,
    stop_loss: float | None = None,
    stop_decrease: float | None = None,
    noise_variance: float = 0.1,
    noise_floor: float | None = None,
    probes: int | None = None,
    cg_iters: int = 256,
    seg_iters: int = 16,
    precond_rank: int = 128,
    residual_gate: float | None = 0.1,
    cg_stop_tol: float = 0.02,
    host_linesearch: bool | None = None,
    key=None,
    progress: Callable[[int, float], None] | None = None,
) -> tuple[dict[str, Tensor], dict[str, Any]]:
    """Cold-fit an exact GP's hyperparameters from the standard init
    (``exact.init_params`` with ``noise_variance``), on ``x``'s device.

    Engine ``auto`` picks Hutchinson below N = 65,536 and CG at or above
    (``"hutchinson"`` / ``"cg"`` force one). ``host_linesearch`` (auto: on
    for the CG engine) evaluates CG through the segmented step (see the
    module docstring); ``False`` evaluates it in one piece. ``patience``
    counts L-BFGS iterations (each costs one or more loss evaluations, so
    the reference's 50, tuned for one-evaluation Adam steps, would waste
    many evaluations after the plateau). ``stop_loss`` stops at band entry
    (loss <= stop_loss + tol*|stop_loss|) when a converged target is known.
    ``chunk`` (default 1 for CG, 8 otherwise) paces ``progress``.

    ``stop_decrease`` (segmented CG path only): the noise-plateau stop; end
    the fit after an accepted step that earns less than this many nats,
    instead of paying the terminal failing linesearch, whose gate-rejected
    trials each cost at least the gate abort's 4-segment history. Set it to
    the estimator's noise scale at the terminus. ``None`` keeps the
    failing-linesearch terminus.

    ``cg_stop_tol`` (segmented CG path): the per-column relative-residual
    tolerance at which mbcg freezes a column and, through the early exit,
    at which an evaluation stops once every column has reached it.
    ``cg_iters`` stays the budget sized for the hardest (true-noise) region;
    easier regions converge in a fraction of it. Set it below ~1e-6 to
    reproduce the fixed-budget protocol.

    ``noise_floor`` (a variance) defaults per engine: 1e-4 for Hutchinson
    (its log-determinant comes from an exact factorization), 1e-3 for CG,
    whose truncated estimator is biased in the near-floor-noise regime,
    where a linesearch would find and exploit that bias. The CG objective
    applies the floor to the parameters it is evaluated at, so linesearch
    trials cannot drive the noise below it.

    ``key``: the fixed probe draws, or a ``torch.Generator`` that makes them
    (default: one seeded 0). Hutchinson takes (N, probes) Rademacher z; CG
    with ``precond_rank`` > 0 takes (u1 (rank, probes), u2 (N, probes))
    normal draws, and Rademacher z without a preconditioner.

    Probes default to 127 for CG (the reference's choice, which its
    128-lane padding made as cheap as 16) and 16 for Hutchinson; the
    linesearch budget to 4 (CG) or 8 evaluations per iteration.

    Returns ``(params, info)``; ``info["engine"]`` is ``"hutchinson"``,
    ``"cg"`` or ``"cg_hostls"`` (whose ``info["segments"]`` lists the CG
    segments each evaluation ran), and ``info["stopped_by"]`` one of
    ``stop_loss_band`` / ``plateau_rule`` / ``noise_plateau`` /
    ``max_iter`` / ``linesearch_failure`` / ``non_finite_init``.
    """
    n = x.shape[0]
    if engine == "auto":
        engine = "cg" if n >= CG_THRESHOLD else "hutchinson"
    if engine not in ("hutchinson", "cg"):
        raise ValueError(f"unknown engine {engine!r}; expected auto|hutchinson|cg")
    big = engine == "cg"
    if max_iter is None:
        max_iter = 64
    if chunk is None:
        chunk = 1 if big else 8
    if max_linesearch_steps is None:
        max_linesearch_steps = 4 if big else 8
    if probes is None:
        probes = 127 if big else 16
    if host_linesearch is None:
        host_linesearch = big
    if noise_floor is None:
        noise_floor = 1e-3 if big else 1e-4  # see docstring

    params0 = exact.init_params(kernel, x, noise_variance=noise_variance)
    floors = {"log_noise_variance": float(math.log(noise_floor))}
    draws = _draws(key, n, probes, precond_rank if big else 0, x.dtype, x.device)

    if stop_decrease is not None and not host_linesearch:
        raise ValueError("stop_decrease requires the host-linesearch CG path (the "
                         "one-piece driver has no per-step decrease hook)")
    if host_linesearch:
        if not big:
            raise ValueError("host_linesearch requires the cg engine")
        step = exact_cg.make_cg_step_chunked(kernel, probes=probes, max_iters=cg_iters,
                                             seg_iters=seg_iters, precond_rank=precond_rank,
                                             residual_gate=residual_gate,
                                             tol=max(cg_stop_tol, 1e-7))

        segments = []

        def vag(p: dict[str, Tensor]) -> tuple[float, dict[str, Tensor]]:
            # the noise floor inside the objective: linesearch trials would
            # otherwise drive the noise far below it, where the CG / SLQ
            # estimate goes non-finite
            loss, grads = step(_apply_floors(p, floors), x, y, draws)
            segments.append(step.last_segments)
            return float(loss), grads

        params, info = lbfgs_fit_hostls(
            vag, params0, max_iter=max_iter, memory_size=memory_size,
            max_linesearch_steps=max_linesearch_steps, tol=tol, patience=patience,
            stop_loss=stop_loss, min_decrease=stop_decrease, floors=floors,
            progress=progress)
        info["engine"] = "cg_hostls"
        info["segments"] = segments
        return params, info

    if big:
        loss = exact_cg.make_cg_training_loss(kernel, probes=probes, max_iters=cg_iters,
                                              precond_rank=precond_rank,
                                              residual_gate=residual_gate)
    else:
        loss = exact_stochastic.make_hutchinson_training_loss(
            kernel, **exact_stochastic.default_chol_config(n))

    params, info = lbfgs_fit_chunked(
        lambda p: loss(p, x, y, draws), params0, max_iter=max_iter, chunk=chunk,
        memory_size=memory_size, max_linesearch_steps=max_linesearch_steps, tol=tol,
        patience=patience, stop_loss=stop_loss, floors=floors, progress=progress)
    info["engine"] = engine
    return params, info
