"""Carry parameter dictionaries between numpy (and so the JAX package) and torch.

A parameter dictionary maps names (``log_variance``, ``log_lengthscales``,
``log_noise_variance``, ...) to arrays, batched over EOF modes along the
leading axis in ``GPRAS``. The checkpoint (``utils/serialization.py``) is the
on-disk form of the same thing; these two functions are the in-memory form.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def params_from_numpy(params: dict[str, np.ndarray], device=None,
                      dtype: torch.dtype | None = None) -> dict[str, Tensor]:
    """numpy arrays -> tensors on ``device``. Floating arrays take ``dtype``
    (default: their own); the Polynomial ``degree`` and any other
    non-floating array keeps its dtype, as ``GPRAS.from_file`` does."""
    out = {}
    for name, value in params.items():
        arr = np.asarray(value)
        t = torch.as_tensor(arr, device=device)
        if dtype is not None and name != "degree" and t.is_floating_point():
            t = t.to(dtype)
        out[name] = t
    return out


def params_to_numpy(params: dict[str, Tensor]) -> dict[str, np.ndarray]:
    """Inverse of :func:`params_from_numpy`: tensors -> host numpy arrays."""
    return {name: value.detach().cpu().numpy() for name, value in params.items()}
