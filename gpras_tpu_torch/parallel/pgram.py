"""Sharded Gram-matrix builds over a mesh, without communication.

Port of ``gpras_tpu/parallel/pgram.py``. Two layouts:
- ``pgram_rows``: this rank's row strip k(x_rows, x) of K over a 1-D axis
  "i", the layout the distributed Cholesky (``pcholesky``) consumes;
- ``pgram_2d``: this rank's (N/di, N/dj) tile over a 2-D mesh, the layout of
  ``pcholesky2d``.

``x`` (N, D) is whole on every rank (the reference passes it sharded by rows
for the strip and replicated for the columns); each rank slices its own
rows and columns. The noise goes on the global diagonal. The entries come
from the plain ``ops/kernels.gram`` (as the reference's ``K.gram``), built
``ROW_ENTRIES`` entries at a time into the result, so no temporary of the
full strip's size is made; autograd flows through the build.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from gpras_tpu_torch.ops import kernels as K
from gpras_tpu_torch.parallel.mesh import _index, _size

Tensor = torch.Tensor

#: entries of the Gram built per panel of rows
ROW_ENTRIES = 1 << 26


def _add_diagonal(k: Tensor, noise, offset: int) -> Tensor:
    """k + noise on the entries (r, r + offset); in place unless autograd
    records k (an op such as the Polynomial's power saves its output)."""
    if k.requires_grad:
        k = k.clone()
    k.diagonal(offset=offset).add_(torch.as_tensor(noise, dtype=k.dtype, device=k.device))
    return k


def _gram_panels(kernel: str, params: dict[str, Tensor], x_rows: Tensor,
                 x_cols: Tensor) -> Tensor:
    """K(x_rows, x_cols), built in row panels of at most ROW_ENTRIES entries."""
    n1, n2 = x_rows.shape[0], x_cols.shape[0]
    rows = max(1, ROW_ENTRIES // max(n2, 1))
    if rows >= n1:
        return K.gram(kernel, params, x_rows, x_cols)
    out = torch.empty((n1, n2), dtype=x_rows.dtype, device=x_rows.device)
    for r0 in range(0, n1, rows):
        out[r0:r0 + rows] = K.gram(kernel, params, x_rows[r0:r0 + rows], x_cols)
    return out


def _gram_vjp(kernel: str, params: dict[str, Tensor], x_rows: Tensor, x_cols: Tensor,
              kbar: Tensor) -> dict[str, Tensor]:
    """sum_ij kbar_ij dK(x_rows, x_cols)_ij / dparams, by autograd through
    ``kernels.gram`` on this rank alone (zero for a parameter K does not
    depend on): the pullback of one rank's part of the Gram."""
    names = [k for k, v in params.items() if v.is_floating_point()]
    leaves = {k: (v.detach().requires_grad_(True) if k in names else v)
              for k, v in params.items()}
    with torch.enable_grad():
        parts = torch.autograd.grad(K.gram(kernel, leaves, x_rows, x_cols),
                                    [leaves[k] for k in names], kbar, allow_unused=True)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    grads.update({k: g for k, g in zip(names, parts) if g is not None})
    return grads


def pgram_rows(mesh: DeviceMesh, kernel: str, params: dict[str, Tensor], x: Tensor,
               noise: Tensor | float | None = None, axis: str = "i") -> Tensor:
    """This rank's (N/d, N) row strip of K(x, x) (+ noise * I) over ``axis``
    (d ranks). ``x`` (N, D) and ``params`` are whole on every rank."""
    n = x.shape[0]
    d = _size(mesh, axis)
    if n % d != 0:
        raise ValueError(f"N={n} not divisible by mesh axis {axis}={d}")
    nr = n // d
    r0 = _index(mesh, axis) * nr
    k = _gram_panels(kernel, params, x[r0:r0 + nr], x)
    return k if noise is None else _add_diagonal(k, noise, r0)


def pgram_2d(mesh: DeviceMesh, kernel: str, params: dict[str, Tensor], x: Tensor,
             noise: Tensor | float | None = None,
             axes: tuple[str, str] = ("i", "j")) -> Tensor:
    """This rank's (N/di, N/dj) tile k(x_rows_a, x_cols_b) (+ noise * I where
    the global diagonal crosses it) of a (di, dj) mesh; rank (a, b) holds
    rows a * N/di ... and columns b * N/dj .... ``x`` and ``params`` are
    whole on every rank."""
    ai, aj = axes
    n = x.shape[0]
    di, dj = _size(mesh, ai), _size(mesh, aj)
    if n % di != 0 or n % dj != 0:
        raise ValueError(f"N={n} must divide by both mesh axes ({di}, {dj})")
    nr, nc = n // di, n // dj
    r0, c0 = _index(mesh, ai) * nr, _index(mesh, aj) * nc
    k = _gram_panels(kernel, params, x[r0:r0 + nr], x[c0:c0 + nc])
    # global row r0 + r meets column c0 + c where c - r = r0 - c0
    return k if noise is None else _add_diagonal(k, noise, r0 - c0)
