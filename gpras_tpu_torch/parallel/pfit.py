"""Data-parallel hyperparameter search over a mesh axis.

Port of ``gpras_tpu/parallel/pfit.py``: the restarts of the multi-start fit
and the population members of differential evolution are independent, so
each rank takes its share of them; the results meet in one all-gather, and
every rank continues with the same numbers.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh

from gpras_tpu_torch.fit import optimizers as fitters
from gpras_tpu_torch.parallel.mesh import _all_gather, _device, _index, _size

Tensor = torch.Tensor


def sharded_multi_start(
    mesh: DeviceMesh,
    loss_fn: Callable[[dict], Tensor],
    params: dict[str, Tensor],
    x: Tensor | None = None,
    n_starts: int = 40,
    iter_initial: int = 20,
    iter_final: int = 1000,
    seed: int = 1,
    axis: str = "i",
    starts: dict[str, Tensor] | None = None,
) -> tuple[dict[str, Tensor], dict[str, Any]]:
    """The reference's "stochastic" strategy with the restarts split over
    ``axis``: each rank Adam-fits its share, the fitted restarts and their
    losses are gathered, and every rank polishes the best with L-BFGS (the
    same result everywhere). ``n_starts`` is rounded up to a multiple of the
    axis size. ``starts`` (leading axis = restart, whole on every rank)
    replaces the restarts drawn as ``fit/optimizers.multi_start_fit`` draws
    them from ``seed``; their count must divide by the axis size."""
    d = _size(mesh, axis)
    if starts is None:
        n_starts = ((n_starts + d - 1) // d) * d
        gen = torch.Generator().manual_seed(seed)
        draws = [fitters._sample_restart(gen, params, x) for _ in range(n_starts)]
        starts = {k: torch.stack([s[k] for s in draws]) for k in params}
    n_starts = next(iter(starts.values())).shape[0]
    if n_starts % d:
        raise ValueError(f"{n_starts} starts do not divide over mesh axis {axis!r} of {d}")
    per = n_starts // d
    r0 = _index(mesh, axis) * per
    fitted, losses = [], []
    for i in range(r0, r0 + per):
        p_i, info = fitters.adam_fit(loss_fn, {k: v[i] for k, v in starts.items()}, iter_initial)
        fitted.append(p_i)
        losses.append(info["loss"])
    dev = _device(mesh)
    losses = _all_gather(torch.stack(losses).to(dev), mesh, axis)
    gathered = {k: _all_gather(torch.stack([p[k] for p in fitted]).to(dev), mesh, axis)
                for k in fitted[0]}
    best = int(torch.argmin(torch.nan_to_num(losses, nan=float("inf"))))
    ref = params["log_variance"]
    best_params = {k: v[best].to(ref.device) for k, v in gathered.items()}
    p, info = fitters.lbfgs_fit(loss_fn, best_params, iter_final)
    info["restart_losses"] = losses.to(ref.device)
    return p, info


def sharded_de(
    mesh: DeviceMesh,
    loss_fn: Callable[[dict], Tensor],
    params: dict[str, Tensor],
    popsize: int = 15,
    max_iter: int = 500,
    axis: str = "i",
    **kwargs: Any,
) -> tuple[dict[str, Tensor], dict[str, Any]]:
    """Differential evolution (``fit/optimizers.de_fit``) with each
    generation's energies split over ``axis``: each rank evaluates its rows
    of the population, one all-gather joins them. ``popsize`` is rounded up
    so the population (3 x popsize members) divides over the axis; every
    rank draws the same population and takes the same steps."""
    d = _size(mesh, axis)
    popsize = ((popsize + d - 1) // d) * d
    dev = _device(mesh)

    def eval_map(f: Callable[[Tensor], Tensor]) -> Callable[[Tensor], Tensor]:
        def batched(pop: Tensor) -> Tensor:
            rows = pop.shape[0] // d
            r0 = _index(mesh, axis) * rows
            local = torch.stack([torch.as_tensor(f(u)).detach().to(dev, torch.float64)
                                 for u in pop[r0:r0 + rows]])
            return _all_gather(local, mesh, axis).cpu()

        return batched

    return fitters.de_fit(loss_fn, params, popsize=popsize, max_iter=max_iter,
                          eval_map=eval_map, **kwargs)
