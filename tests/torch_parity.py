"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*.py).

Importing this module caps torch at one thread: the suite runs several xdist
workers, and torch's default of one thread per core in each of them would
oversubscribe the machine. Inputs are made with numpy from a seed and handed
to both packages, so the two sides see the same numbers.
"""

import numpy as np
import torch

torch.set_num_threads(1)


def t64(a) -> torch.Tensor:
    """numpy (or a JAX array) -> float64 CPU tensor."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def t32(a) -> torch.Tensor:
    """numpy (or a JAX array) -> float32 CPU tensor."""
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def np_params(params) -> dict[str, np.ndarray]:
    """A parameter dict of either package -> writable numpy arrays."""
    return {k: np.array(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in params.items()}
