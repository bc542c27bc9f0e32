"""Sharded PCA/EOF for fields with very many cells (columns).

Port of ``gpras_tpu/parallel/ppca.py``. The cell axis is sharded over a mesh
axis:

- sample Gram G = sum over the ranks of x_s x_s^T: one (S, S) all-reduce;
- eigh(G) on every rank (S x S is small; the same bits everywhere);
- each rank's loadings (k, C/d) from its own cells;
- the sign rule of ``eof/pca.py`` (each component's largest-|loading| entry
  made positive) taken over the whole cell axis: a max-all-reduce of the
  ranks' largest |loading| and a sum of the signed entry where it is held;
- transform: a local matmul and one (S, k) all-reduce; inverse: local.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from gpras_tpu_torch.parallel.mesh import _pmax, _psum

Tensor = torch.Tensor


@torch.no_grad()
def ppca_fit(mesh: DeviceMesh, x: Tensor, n_components: int, axis: str = "i"
             ) -> tuple[Tensor, Tensor]:
    """PCA of pre-centered x (S, C) with its columns sharded over ``axis``:
    ``x`` is this rank's (S, C/d) block. Returns (this rank's (k, C/d) block
    of the components, explained_variance (k,) whole)."""
    s = x.shape[0]
    k = min(n_components, s)
    g = _psum(x @ x.T, mesh, axis)
    evals, evecs = torch.linalg.eigh(g)  # ascending
    evals = evals.flip(0)[:k]
    u = evecs.flip(1)[:, :k]  # (S, k), the same on every rank
    sigma = torch.sqrt(torch.clamp_min(evals, 1e-30))
    comps = (x.T @ (u / sigma[None, :])).T  # (k, C/d)
    # eof/pca.py's rank guard: zero the null-space rows instead of
    # amplifying rounding noise
    rank_ok = evals > 1e-12 * torch.clamp_min(evals[0], 1e-30)
    comps = torch.where(rank_ok[:, None], comps, 0.0)
    # the sign rule over the whole cell axis
    idx = torch.argmax(torch.abs(comps), dim=1)
    local_max = comps[torch.arange(k, device=comps.device), idx]
    gmax = _pmax(torch.abs(local_max), mesh, axis)
    signed = _psum(torch.where(torch.abs(local_max) == gmax, local_max, 0.0), mesh, axis)
    signs = torch.where(signed == 0, 1.0, torch.sign(signed))
    explained = torch.clamp_min(evals, 0.0) / (s - 1)
    return comps * signs[:, None], explained


@torch.no_grad()
def ppca_transform(mesh: DeviceMesh, x: Tensor, comps: Tensor, axis: str = "i") -> Tensor:
    """x (S, C) @ comps^T with both blocks of this rank's cells: a local
    matmul and one (S, k) all-reduce; the (S, k) modes whole on every rank."""
    return _psum(x @ comps.T, mesh, axis)


@torch.no_grad()
def ppca_inverse(mesh: DeviceMesh, modes: Tensor, comps: Tensor, axis: str = "i") -> Tensor:
    """modes (S, k), whole, @ this rank's (k, C/d) components: this rank's
    (S, C/d) block of the reconstruction, without communication."""
    return modes @ comps
