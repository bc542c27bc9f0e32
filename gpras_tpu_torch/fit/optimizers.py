"""Optimizers over a GP training loss: the reference's optimizer zoo.

Port of ``gpras_tpu/fit/optimizers.py``: the gradient masks and floors,
``adam_fit`` with the reference's early stop, ``adadelta_fit``, the host
L-BFGS (``lbfgs_fit_hostls``) and its two wrappers ``lbfgs_fit`` and
``lbfgs_fit_chunked``, the staged schedules (``two_stage_fit``, the
default of ``GPRAS.fit``, and ``three_stage_fit``), the multi-start fit
(``"stochastic"``) and differential evolution. The reference runs Adam and
Adadelta inside one ``lax.while_loop``; here a Python loop takes the steps
and reads the loss once per step to apply the stopping rule.

Adam is optax's update, not ``torch.optim.Adam``'s: eps 1e-7 (tf.keras's
default, which the reference keeps) outside the square root, and optax's
bias correction, 1 - b**t computed in float64 and divided in the
parameter's dtype. Adadelta is optax's too (rho 0.95, eps 1e-7).

L-BFGS: every driver here runs the one host core, ``lbfgs_fit_hostls``
(two-loop recursion, strong-Wolfe bracket and zoom, float64 numpy), a copy
of the reference's line for line. The reference's ``lbfgs_fit`` and
``lbfgs_fit_chunked`` run optax's zoom linesearch inside device programs
instead; the two linesearches do not share a trajectory, so the wrappers
are held to the reference by final loss. ``chunk`` only paces
``progress``: the per-program time budget it worked around does not exist
on the card.

Randomness is an input: a ``torch.Generator`` seeded from the reference's
``seed`` draws the restarts and the DE population on the CPU, and
``multi_start_fit`` also takes the restarts themselves (``starts=``).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from gpras_tpu_torch.utils import profiling

Tensor = torch.Tensor
Params = dict[str, Tensor]
LossFn = Callable[[Params], Tensor]

LN10 = math.log(10.0)

#: Structural (non-trainable) parameter keys, excluded from every gradient mask.
NON_TRAINABLE = ("degree",)


def mask_only(params: Params, keys: tuple[str, ...]) -> Params:
    """Mask that trains only ``keys``."""
    return {k: torch.tensor(float(k in keys and k not in NON_TRAINABLE)) for k in params}


def mask_except(params: Params, keys: tuple[str, ...] = ()) -> Params:
    """Mask that trains everything except ``keys`` (and structural constants)."""
    return {k: torch.tensor(float(k not in keys and k not in NON_TRAINABLE)) for k in params}


def _read(t: Tensor) -> bool:
    """``bool(t)``: a host read, counted."""
    profiling.count("host_reads")
    return bool(t)


def _apply_mask(grads: Params, mask: Params | None) -> Params:
    if mask is None:
        mask = {k: torch.tensor(float(k not in NON_TRAINABLE)) for k in grads}
    # each mask moves up from pageable memory, which waits for the device's queue
    profiling.count("host_reads", len(grads))
    return {k: grads[k] * mask[k].to(dtype=grads[k].dtype, device=grads[k].device)
            for k in grads}


def _apply_floors(params: Params, floors: dict[str, float] | None) -> Params:
    """Project parameters onto ``{p_k >= floor_k}`` after an update step (the
    float32 noise floor of the exact-GP fit)."""
    if not floors:
        return params
    return {k: (torch.clamp_min(v, floors[k]) if k in floors else v) for k, v in params.items()}


def value_and_grad(loss_fn: LossFn, params: Params) -> tuple[Tensor, Params]:
    """(loss, gradient) of ``loss_fn`` at ``params``; zero gradients where the
    loss does not depend on a parameter."""
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(v.is_floating_point())
                  for k, v in params.items()}
        loss = loss_fn(leaves)
        names = [k for k, v in leaves.items() if v.requires_grad]
        parts = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    for k, gk in zip(names, parts):
        if gk is not None:
            grads[k] = gk
    return loss.detach(), grads


def _adam_update(grads: Params, state: tuple[Params, Params, int], lr: float,
                 b1: float, b2: float, eps: float) -> tuple[Params, tuple]:
    """optax.adam's update (scale_by_adam, then scale by -lr)."""
    mu, nu, count = state
    mu = {k: (1 - b1) * g + b1 * mu[k] for k, g in grads.items()}
    nu = {k: (1 - b2) * g ** 2 + b2 * nu[k] for k, g in grads.items()}
    count += 1
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    updates = {k: -lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)) for k in grads}
    return updates, (mu, nu, count)


def adam_fit(
    loss_fn: LossFn,
    params: Params,
    max_iter: int = 100,
    learning_rate: float = 0.001,
    tol: float = 1e-5,
    patience: int = 50,
    mask: Params | None = None,
    lower_bounds: dict[str, float] | None = None,
    reject_nonfinite: bool = False,
) -> tuple[Params, dict[str, Any]]:
    """Adam with the reference's early stopping (gpras/gpr.py:159-173).

    Stops when the relative improvement over the best-seen loss has been
    below ``tol`` for more than ``patience`` consecutive steps. Defaults
    mirror tf.keras Adam (lr 0.001, eps 1e-7). ``lower_bounds`` projects
    named parameters onto ``>= floor`` after each step.

    ``reject_nonfinite``: a step whose loss or gradient is not finite is
    skipped, and parameters and optimizer state go back to the last finite
    iterate (the step still counts against ``patience``); at the end, if the
    last iterate's loss is not finite, the last good parameters are
    returned. Without it a non-finite loss stops the fit at once.

    Returns ``(params, {"iterations", "losses", "loss"})``: ``losses`` holds
    ``max_iter`` entries, NaN past the last step.
    """
    b1, b2, eps = 0.9, 0.999, 1e-7
    p = {k: v.detach() for k, v in params.items()}
    ref = next(iter(p.values()))
    state = ({k: torch.zeros_like(v) for k, v in p.items()},
             {k: torch.zeros_like(v) for k, v in p.items()}, 0)
    losses = torch.full((max_iter,), float("nan"), dtype=ref.dtype, device=ref.device)
    profiling.count("host_reads")  # ``best`` moves up from pageable memory
    best = torch.tensor(float("inf"), dtype=ref.dtype, device=ref.device)
    good_p, good_state = p, state
    i = count = 0
    while i < max_iter and count <= patience:
        loss, grads = value_and_grad(loss_fn, p)
        with profiling.span("fit.adam"):
            grads = _apply_mask(grads, mask)
            updates, state_next = _adam_update(grads, state, learning_rate, b1, b2, eps)
            p_next = _apply_floors({k: p[k] + updates[k] for k in p}, lower_bounds)
            improved = _read((best - loss) / torch.abs(loss) > tol)
            if improved:
                best = loss
            count = 0 if improved else count + 1
            losses[i] = loss
            if reject_nonfinite:
                finite = _read(torch.isfinite(loss)) and all(
                    _read(torch.all(torch.isfinite(g))) for g in grads.values())
                if finite:
                    good_p, good_state = p, state
                else:
                    p_next, state_next = good_p, good_state
            elif not _read(torch.isfinite(loss)):
                # a non-finite loss can never improve again: stop now
                count = patience + 1
        p, state = p_next, state_next
        i += 1
    with torch.no_grad():
        final = loss_fn(p)
        if reject_nonfinite:
            with profiling.span("fit.adam"):
                rejected = not _read(torch.isfinite(final))
            if rejected:
                p = good_p
                final = loss_fn(p)
    return p, {"iterations": i, "losses": losses, "loss": final.detach()}


def adadelta_fit(
    loss_fn: LossFn,
    params: Params,
    max_iter: int = 100,
    learning_rate: float = 0.001,
    mask: Params | None = None,
) -> tuple[Params, dict[str, Any]]:
    """Fixed-iteration Adadelta, mirroring the reference's graph loop
    (gpras/gpr.py:176-192; keras defaults lr 0.001, rho 0.95, eps 1e-7):
    optax's update, E[g^2] then the step sqrt(E[dx^2] + eps) /
    sqrt(E[g^2] + eps) * g, then E[dx^2], scaled by -lr."""
    rho, eps = 0.95, 1e-7
    p = {k: v.detach() for k, v in params.items()}
    ref = next(iter(p.values()))
    e_g = {k: torch.zeros_like(v) for k, v in p.items()}
    e_x = {k: torch.zeros_like(v) for k, v in p.items()}
    losses = torch.full((max_iter,), float("nan"), dtype=ref.dtype, device=ref.device)
    for i in range(max_iter):
        loss, grads = value_and_grad(loss_fn, p)
        grads = _apply_mask(grads, mask)
        e_g = {k: (1 - rho) * g ** 2 + rho * e_g[k] for k, g in grads.items()}
        step = {k: (torch.sqrt(e_x[k] + eps) / torch.sqrt(e_g[k] + eps)) * g
                for k, g in grads.items()}
        e_x = {k: (1 - rho) * s ** 2 + rho * e_x[k] for k, s in step.items()}
        p = {k: p[k] + -learning_rate * step[k] for k in p}
        losses[i] = loss
    with torch.no_grad():
        final = loss_fn(p)
    return p, {"iterations": max_iter, "losses": losses, "loss": final.detach()}


# ---------------------------------------------------------------------------
# L-BFGS
# ---------------------------------------------------------------------------


def _masked_loss(loss_fn: LossFn, params: Params, mask: Params | None) -> LossFn:
    """``loss_fn`` of the trained leaves merged with the frozen ones (the
    caller's ``params``): p * mask + frozen * (1 - mask)."""
    if mask is None:
        return loss_fn
    return lambda p: loss_fn(_merge_frozen(p, params, mask))


def _merge_frozen(p: Params, frozen: Params, mask: Params | None) -> Params:
    if mask is None:
        return p
    out = {}
    for k in p:
        profiling.count("host_reads")  # the mask moves up from pageable memory
        m = mask[k].to(dtype=p[k].dtype, device=p[k].device)
        out[k] = p[k] * m + frozen[k] * (1.0 - m)
    return out


def _host_value_and_grad(loss_fn: LossFn) -> Callable[[Params], tuple[float, Params]]:
    """The host core's evaluation: (loss as a float, gradients)."""

    def vag(p: Params) -> tuple[float, Params]:
        loss, grads = value_and_grad(loss_fn, p)
        profiling.count("host_reads")
        return float(loss), grads

    return vag


def lbfgs_fit(
    loss_fn: LossFn,
    params: Params,
    max_iter: int = 100,
    memory_size: int = 15,
    gtol: float = 1e-8,
    mask: Params | None = None,
) -> tuple[Params, dict[str, Any]]:
    """L-BFGS over the whole loss (the reference's gpflow -> scipy L-BFGS-B
    bridge, gpras/gpr.py:195-203): the host core ``lbfgs_fit_hostls`` with
    optax's linesearch budget (20 evaluations) and stopping rule (``max_iter``
    iterations, or a gradient norm at or below ``gtol``) and no plateau
    rule. The fit also ends when no step decreases the loss any more
    (``linesearch_failure``), where optax would keep proposing the same
    point. Leaves that ``mask`` freezes keep their values."""
    p, info = lbfgs_fit_hostls(
        _host_value_and_grad(_masked_loss(loss_fn, params, mask)), params,
        max_iter=max_iter, memory_size=memory_size, max_linesearch_steps=20,
        patience=max_iter, gtol=gtol)
    p = _merge_frozen(p, params, mask)
    with torch.no_grad():
        final = loss_fn(p)
    return p, {"iterations": info["iterations"], "losses": info["losses"],
               "loss": final.detach()}


def lbfgs_fit_chunked(
    loss_fn: LossFn,
    params: Params,
    max_iter: int = 96,
    chunk: int = 8,
    memory_size: int = 15,
    max_linesearch_steps: int = 8,
    mask: Params | None = None,
    floors: dict[str, float] | None = None,
    stop_loss: float | None = None,
    tol: float = 1e-5,
    patience: int = 50,
    progress: Callable[[int, float], None] | None = None,
) -> tuple[Params, dict[str, Any]]:
    """L-BFGS with the reference's early stops: the plateau rule (rel-tol
    ``tol``, ``patience`` iterations, gpras/gpr.py:162-173), the stopping
    band (``stop_loss``: stop once loss <= stop_loss + tol*|stop_loss|),
    ``floors`` projection between iterations, and a failed linesearch ends
    the fit on the last good iterate. It runs ``lbfgs_fit_hostls``;
    ``progress(iterations_done, best_loss)`` is called every ``chunk``
    iterations and once at the end. Returns ``(params, {"iterations",
    "losses", "loss", "stopped_by", "evals"})``; ``evals`` counts loss and
    gradient evaluations."""
    last = [0, float("inf")]

    def paced(done: int, best: float) -> None:
        last[:] = [done, best]
        if done % chunk == 0:
            progress(done, best)

    p, info = lbfgs_fit_hostls(
        _host_value_and_grad(_masked_loss(loss_fn, params, mask)), params,
        max_iter=max_iter, memory_size=memory_size,
        max_linesearch_steps=max_linesearch_steps, floors=floors,
        stop_loss=stop_loss, tol=tol, patience=patience,
        progress=None if progress is None else paced)
    if progress is not None and last[0] % chunk:
        progress(*last)
    return _merge_frozen(p, params, mask), info


def _flatten(params: Params, order: list[str]) -> np.ndarray:
    profiling.count("host_reads", len(order))
    return np.concatenate(
        [params[k].detach().cpu().to(torch.float64).numpy().ravel() for k in order])


def _unflatten(vec: np.ndarray, template: Params, order: list[str]) -> Params:
    out: Params = {}
    i = 0
    profiling.count("host_reads", len(order))  # copies up from pageable memory
    for k in order:
        t = template[k]
        sz = t.numel()
        out[k] = torch.as_tensor(vec[i:i + sz].reshape(t.shape), dtype=t.dtype, device=t.device)
        i += sz
    return out


def lbfgs_fit_hostls(
    value_and_grad_fn: Callable[[Params], tuple[float, Params]],
    params: Params,
    max_iter: int = 64,
    memory_size: int = 15,
    max_linesearch_steps: int = 8,
    c1: float = 1e-4,
    c2: float = 0.9,
    floors: dict[str, float] | None = None,
    stop_loss: float | None = None,
    tol: float = 1e-5,
    patience: int = 10,
    min_decrease: float | None = None,
    progress: Callable[[int, float], None] | None = None,
    gtol: float | None = None,
) -> tuple[Params, dict[str, Any]]:
    """L-BFGS with the whole optimizer on the host: the two-loop recursion
    and the strong-Wolfe bracket and zoom linesearch run in float64 numpy,
    and every loss evaluation is one ``value_and_grad_fn(params) -> (float,
    grads)`` call (a host function, free to run one device computation or
    several, e.g. ``exact_cg.make_cg_step_chunked``'s CG segments).

    Early stops: the reference plateau rule (rel-tol ``tol``, ``patience``
    L-BFGS iterations), ``stop_loss`` band entry (loss <= stop_loss +
    tol*|stop_loss|), ``floors`` projection between iterations, and a
    non-finite or no-descent linesearch ends the fit on the best iterate.
    The Wolfe parameters are the classics (c1=1e-4, c2=0.9, Nocedal &
    Wright alg. 3.5-3.6, quadratic-bisection zoom).

    ``min_decrease`` (absolute loss units) is the noise-plateau stop: after
    an accepted step whose decrease is below it, stop at once
    (``stopped_by="noise_plateau"``) instead of proposing another
    linesearch. On a stochastic-estimator objective with fixed probes, once
    a step earns less than the estimator's noise the next linesearch is the
    failing one, and discovering that costs ``max_linesearch_steps``
    rejected trials; stopping here leaves the trajectory up to the stop
    unchanged. ``None`` (default) disables the rule.

    ``gtol`` (this port's addition, for ``lbfgs_fit``): stop after an
    accepted step whose gradient norm is at or below it
    (``stopped_by="gtol"``); ``None`` (default) disables it.

    Returns ``(best params, {"iterations", "losses" (float32, NaN past the
    last iteration), "loss" (the best, float32), "stopped_by", "evals"})``.
    """
    order = sorted(params.keys())
    template = {k: params[k] for k in order}

    def vag(vec: np.ndarray) -> tuple[float, np.ndarray]:
        val, grads = value_and_grad_fn(_unflatten(vec, template, order))
        return float(val), _flatten(grads, order)

    x = _flatten(params, order)
    f0, g = vag(x)
    evals = 1
    if not np.isfinite(f0):
        return params, {
            "iterations": torch.tensor(0),
            "losses": torch.full((max_iter,), float("nan"), dtype=torch.float32),
            "loss": torch.tensor(float("nan"), dtype=torch.float32),
            "stopped_by": "non_finite_init", "evals": evals,
        }

    s_mem: list[np.ndarray] = []
    y_mem: list[np.ndarray] = []
    losses = np.full((max_iter,), np.nan, np.float32)
    best = f0
    best_x = x.copy()
    count = 0
    stopped = ""
    done = 0

    for it in range(max_iter):
        # two-loop recursion for d = -H g
        q = g.copy()
        alphas = []
        for s, yv in zip(reversed(s_mem), reversed(y_mem)):
            a = (s @ q) / (yv @ s)
            alphas.append(a)
            q -= a * yv
        if s_mem:
            gamma = (s_mem[-1] @ y_mem[-1]) / (y_mem[-1] @ y_mem[-1])
            q *= gamma
        for (s, yv), a in zip(zip(s_mem, y_mem), reversed(alphas)):
            b = (yv @ q) / (yv @ s)
            q += (a - b) * s
        d = -q
        slope0 = g @ d
        if not np.isfinite(slope0) or slope0 >= 0.0:
            d = -g  # reset to steepest descent on a bad pair
            slope0 = g @ d
            s_mem.clear()
            y_mem.clear()

        # strong-Wolfe linesearch (bracket + zoom) on phi(a) = f(x + a d).
        # A non-finite gradient poisons the next direction even when the
        # value is finite, so it fails the trial as a non-finite value does.
        def phi(a: float) -> tuple[float, np.ndarray, float]:
            fv, gv = vag(x + a * d)
            if not np.all(np.isfinite(gv)):
                return np.nan, gv, np.nan
            return fv, gv, gv @ d

        a_prev, f_prev, slope_prev, g_prev = 0.0, f0, slope0, g
        a_cur = 1.0 if s_mem else min(1.0, 1.0 / max(1.0, float(np.abs(g).sum())))
        lo = hi = None  # zoom bracket: (a, f, slope, grad) tuples; the
        # gradient rides along so the budget-exhausted fallback never
        # evaluates a point twice (each evaluation is a factorization or
        # a CG solve)
        accepted = None
        ls_evals = 0
        while ls_evals < max_linesearch_steps:
            f_cur, g_cur, slope_cur = phi(a_cur)
            evals += 1
            ls_evals += 1
            if not np.isfinite(f_cur):
                a_cur = 0.5 * (a_prev + a_cur)  # pull back toward the base
                continue
            if f_cur > f0 + c1 * a_cur * slope0 or \
                    (a_prev > 0.0 and f_cur >= f_prev):
                lo, hi = (a_prev, f_prev, slope_prev, g_prev), \
                    (a_cur, f_cur, slope_cur, g_cur)
                break
            if abs(slope_cur) <= -c2 * slope0:
                accepted = (a_cur, f_cur, g_cur)
                break
            if slope_cur >= 0.0:
                lo, hi = (a_cur, f_cur, slope_cur, g_cur), \
                    (a_prev, f_prev, slope_prev, g_prev)
                break
            a_prev, f_prev, slope_prev, g_prev = a_cur, f_cur, slope_cur, g_cur
            a_cur = 2.0 * a_cur
        if accepted is None and lo is None and a_prev > 0.0 and f_prev < f0:
            # expansion exhausted the budget while every trial satisfied
            # Armijo and kept descending: the last point is a valid step
            accepted = (a_prev, f_prev, g_prev)
        while accepted is None and lo is not None and ls_evals < max_linesearch_steps:
            # zoom: quadratic interpolation, bisection fallback
            a_lo, f_lo, s_lo, _ = lo
            a_hi, f_hi, _, _ = hi
            denom = 2.0 * (f_hi - f_lo - s_lo * (a_hi - a_lo))
            a_j = a_lo + (-s_lo * (a_hi - a_lo) ** 2 / denom
                          if abs(denom) > 1e-300 else 0.5 * (a_hi - a_lo))
            width = abs(a_hi - a_lo)
            if not np.isfinite(a_j) or \
                    not (min(a_lo, a_hi) + 0.1 * width <= a_j
                         <= max(a_lo, a_hi) - 0.1 * width):
                a_j = 0.5 * (a_lo + a_hi)
            f_j, g_j, slope_j = phi(a_j)
            evals += 1
            ls_evals += 1
            if not np.isfinite(f_j) or f_j > f0 + c1 * a_j * slope0 or f_j >= f_lo:
                hi = (a_j, f_j, slope_j, g_j)
            else:
                if abs(slope_j) <= -c2 * slope0:
                    accepted = (a_j, f_j, g_j)
                    break
                if slope_j * (a_hi - a_lo) >= 0.0:
                    hi = lo
                lo = (a_j, f_j, slope_j, g_j)
            if width < 1e-12:
                break
        if accepted is None:
            # no Wolfe point inside the budget: take the best finite
            # decrease seen in the zoom bracket, else stop
            cand = [t for t in (lo, hi) if t is not None
                    and np.isfinite(t[1]) and t[1] < f0 and t[0] > 0.0
                    and np.all(np.isfinite(t[3]))]
            if not cand:
                if s_mem:
                    # stale curvature pairs can demand a step the trial
                    # budget cannot bracket; restart from steepest descent
                    # before giving up
                    s_mem.clear()
                    y_mem.clear()
                    continue
                stopped = "linesearch_failure"
                break
            a_b, f_b, _, g_b = min(cand, key=lambda t: t[1])
            accepted = (a_b, f_b, g_b)

        a_acc, f_new, g_new = accepted
        earned = f0 - f_new  # accepted-step decrease (>= 0 by construction)
        x_new = x + a_acc * d
        if floors:
            p_proj = _apply_floors(_unflatten(x_new, template, order), floors)
            x_new = _flatten(p_proj, order)
        s_vec = x_new - x
        y_vec = g_new - g
        if np.isfinite(y_vec @ s_vec) and (y_vec @ s_vec) > 1e-10 * \
                np.linalg.norm(s_vec) * np.linalg.norm(y_vec):
            s_mem.append(s_vec)
            y_mem.append(y_vec)
            if len(s_mem) > memory_size:
                s_mem.pop(0)
                y_mem.pop(0)
        x, f0, g = x_new, f_new, g_new
        losses[it] = f_new
        done = it + 1
        if progress is not None:
            progress(done, min(best, f_new))
        if f_new < best:
            if (best - f_new) / max(abs(f_new), 1e-300) > tol:
                count = 0
            else:
                count += 1
            best, best_x = f_new, x.copy()
        else:
            count += 1
        if stop_loss is not None and f_new <= stop_loss + tol * abs(stop_loss):
            stopped = "stop_loss_band"
            break
        if min_decrease is not None and earned < min_decrease:
            stopped = "noise_plateau"
            break
        if count > patience:
            stopped = "plateau_rule"
            break
        if gtol is not None and np.linalg.norm(g) <= gtol:
            stopped = "gtol"
            break

    return _unflatten(best_x, template, order), {
        "iterations": torch.tensor(done),
        "losses": torch.from_numpy(losses),
        "loss": torch.tensor(best, dtype=torch.float32),
        "stopped_by": stopped or "max_iter",
        "evals": evals,
    }


# ---------------------------------------------------------------------------
# staged schedules
# ---------------------------------------------------------------------------


def two_stage_fit(loss_fn: LossFn, params: Params, max_iter: int = 100,
                  **adam_kwargs: Any) -> tuple[Params, dict[str, Any]]:
    """Adam on the inducing inputs Z only, then Adam on every other
    parameter with Z frozen (reference gpras/gpr.py:112-127). A model
    without Z (the exact backend) skips the first stage."""
    if "z" in params:
        p, _ = adam_fit(loss_fn, params, max_iter, mask=mask_only(params, ("z",)),
                        **adam_kwargs)
    else:
        p = params
    return adam_fit(loss_fn, p, max_iter, mask=mask_except(p, ("z",)), **adam_kwargs)


def three_stage_fit(loss_fn: LossFn, params: Params,
                    max_iter: int = 100) -> tuple[Params, dict[str, Any]]:
    """Adam on Z, L-BFGS on the hyperparameters (Z frozen), L-BFGS polish on
    everything (reference gpras/gpr.py:130-144). The Z stage is skipped
    when the model has no inducing inputs."""
    p = params
    if "z" in params:
        p, _ = adam_fit(loss_fn, p, max_iter, mask=mask_only(p, ("z",)))
    p, _ = lbfgs_fit(loss_fn, p, max_iter, mask=mask_except(p, ("z",)))
    return lbfgs_fit(loss_fn, p, max_iter)


# ---------------------------------------------------------------------------
# multi-start ("stochastic")
# ---------------------------------------------------------------------------


def _sample_restart(gen: torch.Generator, params: Params, x: Tensor | None) -> Params:
    """One random restart in the reference's log10 sampling boxes
    (gpras/gpr.py:87-91): variance 10^U(-1,1), lengthscale 10^U(-1,1)
    (a scalar broadcast over the ARD dimensions), noise 10^U(-3,0),
    Z ~ U(feature mins, maxs). The uniforms are drawn on the CPU from
    ``gen`` in float64, in that order (the lengthscale's always)."""
    ref = params["log_variance"]

    def uniform(lo: float, hi: float, shape=()) -> Tensor:
        u = torch.rand(shape, generator=gen, dtype=torch.float64)
        return (lo + (hi - lo) * u).to(ref.dtype)

    out = dict(params)
    out["log_variance"] = (uniform(-1.0, 1.0) * LN10).to(ref.device)
    ls = uniform(-1.0, 1.0) * LN10
    if "log_lengthscales" in params:
        out["log_lengthscales"] = torch.full_like(params["log_lengthscales"], float(ls))
    out["log_noise_variance"] = (uniform(-3.0, 0.0) * LN10).to(ref.device)
    if "z" in params and x is not None:
        mins, maxs = torch.min(x, dim=0).values, torch.max(x, dim=0).values
        u = uniform(0.0, 1.0, tuple(params["z"].shape)).to(ref.device)
        out["z"] = mins + u * (maxs - mins)
    return out


def multi_start_fit(
    loss_fn: LossFn,
    params: Params,
    x: Tensor | None = None,
    n_starts: int = 40,
    iter_initial: int = 20,
    iter_final: int = 1000,
    seed: int = 1,
    starts: Params | None = None,
) -> tuple[Params, dict[str, Any]]:
    """Multi-start Adam, keep the best restart, L-BFGS polish (reference
    "stochastic", gpras/gpr.py:73-109, with the intended keep-the-best
    behaviour). ``starts`` (leading axis = restart) replaces the
    ``n_starts`` restarts drawn by ``_sample_restart`` from a generator
    seeded ``seed``. The restarts run one after another."""
    if starts is None:
        gen = torch.Generator().manual_seed(seed)
        draws = [_sample_restart(gen, params, x) for _ in range(n_starts)]
    else:
        lead = next(iter(starts.values())).shape[0]
        draws = [{k: v[i] for k, v in starts.items()} for i in range(lead)]
    fitted, losses = [], []
    for start in draws:
        p_i, info = adam_fit(loss_fn, start, iter_initial)
        fitted.append(p_i)
        losses.append(info["loss"])
    losses = torch.stack(losses)
    best = int(torch.argmin(torch.nan_to_num(losses, nan=float("inf"))))
    p, info = lbfgs_fit(loss_fn, fitted[best], iter_final)
    info["restart_losses"] = losses
    return p, info


# ---------------------------------------------------------------------------
# differential evolution
# ---------------------------------------------------------------------------

#: DE's box over (log10 variance, log10 lengthscale, log10 noise variance)
DE_LOWER = (-1.0, -1.0, -3.0)
DE_UPPER = (1.0, 1.0, 0.0)


def _member_loop(energy_one: Callable[[Tensor], Tensor]) -> Callable[[Tensor], Tensor]:
    """The default population evaluator: members one after another."""

    def energy(pop: Tensor) -> Tensor:
        return torch.stack([torch.as_tensor(energy_one(u)).detach().to(
            device="cpu", dtype=torch.float64) for u in pop])

    return energy


def _de_draws(gen: torch.Generator, n_pop: int, dim: int):
    """One generation's draws (float64 and int64, on the CPU): the dithered
    mutation factor F ~ U(0.5, 1), the two difference members of each
    mutant, the crossover uniforms and each member's forced dimension."""
    fmut = 0.5 + 0.5 * torch.rand((), generator=gen, dtype=torch.float64)
    idx = torch.randint(0, n_pop, (n_pop, 2), generator=gen)
    cross_u = torch.rand((n_pop, dim), generator=gen, dtype=torch.float64)
    jdim = torch.randint(0, dim, (n_pop,), generator=gen)
    return fmut, idx, cross_u, jdim


def _de_generation(pop: Tensor, f: Tensor, draws, energy: Callable[[Tensor], Tensor],
                   lo: Tensor, hi: Tensor, recombination: float) -> tuple[Tensor, Tensor]:
    """best/1/bin: mutant = best + F (pop[r1] - pop[r2]) clipped to the box,
    binomial crossover with one forced dimension, greedy selection."""
    fmut, idx, cross_u, jdim = draws
    best_u = pop[torch.argmin(f)]
    mutant = best_u[None, :] + fmut * (pop[idx[:, 0]] - pop[idx[:, 1]])
    mutant = torch.clamp(mutant, lo, hi)
    force = torch.nn.functional.one_hot(jdim, pop.shape[1]).bool()
    cross = (cross_u < recombination) | force
    trial = torch.where(cross, mutant, pop)
    f_trial = energy(trial)
    accept = f_trial < f
    return torch.where(accept[:, None], trial, pop), torch.where(accept, f_trial, f)


def de_fit(
    loss_fn: LossFn,
    params: Params,
    popsize: int = 15,
    max_iter: int = 500,
    adam_iter: int = 3000,
    tol: float = 0.01,
    recombination: float = 0.7,
    seed: int = 0,
    eval_map: Callable[[Callable], Callable] | None = None,
) -> tuple[Params, dict[str, Any]]:
    """Adam on Z first, then differential evolution (best/1/bin with dithered
    mutation, scipy-compatible defaults) over the three log10
    hyperparameters with bounds [(-1,1), (-1,1), (-3,0)] (reference
    gpras/gpr.py:44-70); lengthscales are assigned as one scalar broadcast,
    as the reference's ``assign``. Stops after ``max_iter`` generations or
    once the population's energies spread (std) by at most
    tol * |mean|. The population and the draws are float64 on the CPU,
    drawn from a generator seeded ``seed``.

    ``eval_map`` overrides how the population's energies are evaluated: it
    wraps the per-member loss (a function of one (3,) member) into a
    function of the (members, 3) population; by default the members run
    one after another."""
    if "z" in params:
        params, _ = adam_fit(loss_fn, params, adam_iter, mask=mask_only(params, ("z",)))
    lo = torch.tensor(DE_LOWER, dtype=torch.float64)
    hi = torch.tensor(DE_UPPER, dtype=torch.float64)
    dim = 3
    n_pop = popsize * dim
    ref = params["log_variance"]

    def set_params(u: Tensor) -> Params:
        u = (u * LN10).to(ref.dtype)  # on the CPU: float(u[1]) waits for nothing
        out = dict(params)
        out["log_variance"] = u[0].to(ref.device)
        if "log_lengthscales" in params:
            out["log_lengthscales"] = torch.full_like(params["log_lengthscales"], float(u[1]))
        out["log_noise_variance"] = u[2].to(ref.device)
        return out

    def member_energy(u: Tensor) -> Tensor:
        with torch.no_grad():
            return loss_fn(set_params(u))

    energy = (eval_map or _member_loop)(member_energy)
    gen = torch.Generator().manual_seed(seed)
    pop = lo + torch.rand((n_pop, dim), generator=gen, dtype=torch.float64) * (hi - lo)
    f = energy(pop)
    i = 0
    while i < max_iter and bool(torch.std(f, correction=0) > tol * torch.abs(torch.mean(f))):
        pop, f = _de_generation(pop, f, _de_draws(gen, n_pop, dim), energy, lo, hi,
                                recombination)
        i += 1
    return set_params(pop[torch.argmin(f)]), {"iterations": i, "loss": torch.min(f),
                                               "losses": f}


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

FITTERS: dict[str, Callable[..., tuple[Params, dict[str, Any]]]] = {
    "two-stage": two_stage_fit,
    "three-stage": three_stage_fit,
    "adam": adam_fit,
    "adadelta": adadelta_fit,
    "L-BFGS-B": lbfgs_fit,
    "stochastic": multi_start_fit,
    "diffential_evolution": de_fit,  # [sic] reference key, gpras/gpr.py:213
    "differential_evolution": de_fit,
}


def fit(loss_fn: LossFn, params: Params, method: str = "two-stage",
        **kwargs: Any) -> tuple[Params, dict[str, Any]]:
    """Dispatch to an optimizer by its reference-parity name (gpras/gpr.py:206-214)."""
    if method not in FITTERS:
        raise ValueError(f"Unknown optimizer {method!r}; expected one of {sorted(FITTERS)}")
    return FITTERS[method](loss_fn, params, **kwargs)
