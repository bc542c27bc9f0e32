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


#: B3's 3xTF32 contraction against float64, relative to max |result|: the
#: split misses ~2^-22 of each product and the fp32 sums add ~1e-6, while one
#: TF32 pass (2^-11 per operand) leaves ~1e-4 (tests/test_torch_kmv_tf32.py)
TF32X3_TOL = 2e-5


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: cvt.rna.tf32.f32 in plain PyTorch, on the low 13 bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
