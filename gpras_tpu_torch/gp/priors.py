"""Hyperparameter priors.

Port of ``gpras_tpu/gp/priors.py``: LogNormal(0, 1) priors on the kernel
variance, the lengthscales and the noise variance. With the parameters held
in log space, the prior density plus its change-of-variables term is a
standard-normal log-density on each unconstrained parameter.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

#: Unconstrained parameter names that carry the LogNormal(0, 1) prior.
PRIOR_PARAM_NAMES = ("log_variance", "log_lengthscales", "log_noise_variance")


def log_prior(params: dict[str, Tensor],
              names: tuple[str, ...] = PRIOR_PARAM_NAMES) -> Tensor:
    """Sum of Normal(0, 1) log-densities over the parameters of ``names``
    that ``params`` holds."""
    ref = next(iter(params.values()))
    total = torch.zeros((), dtype=ref.dtype, device=ref.device)
    for name in names:
        if name in params:
            eta = params[name]
            total = total + torch.sum(-0.5 * eta * eta - 0.5 * math.log(2.0 * math.pi))
    return total
