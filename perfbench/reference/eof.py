"""The EOF preprocessor of water-surface fields, from its definition:
cells whose deepest water over the fitting events stays below the wet
threshold are always dry and dropped; the rest are centred; the leading
principal components (each signed so that its largest-magnitude loading is
positive) are the EOFs; the projections are standardised by their mean and
standard deviation. Decoding maps mode values back to the wet cells, fills
dry cells with their elevation, and propagates a mode variance through the
squared linear map."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


class Eof:
    def __init__(self, fields: Tensor, elevation: Tensor, modes: int, wet_threshold: float):
        f = fields.to(torch.float64)
        self.elevation = elevation.to(torch.float64)
        self.wet = (f.max(0).values - self.elevation) >= wet_threshold
        x = f[:, self.wet]
        self.mean = x.mean(0)
        xc = x - self.mean
        _, _, vh = torch.linalg.svd(xc, full_matrices=False)
        comps = vh[:modes]
        idx = comps.abs().argmax(1)
        sign = torch.sign(comps[torch.arange(modes, device=comps.device), idx])
        self.comps = comps * torch.where(sign == 0, 1.0, sign)[:, None]
        xp = xc @ self.comps.T
        self.x_mean = xp.mean(0)
        std = xp.std(0, unbiased=False)
        self.x_std = torch.where(std > 0, std, 1.0)

    def mean_field(self) -> Tensor:
        """The mean field over all cells (dry cells at their elevation)."""
        out = self.elevation.clone()
        out[self.wet] = self.mean
        return out

    def transform(self, fields: Tensor) -> Tensor:
        xp = (fields.to(torch.float64)[:, self.wet] - self.mean) @ self.comps.T
        return (xp - self.x_mean) / self.x_std

    def decode(self, mean: Tensor, var: Tensor) -> tuple[Tensor, Tensor]:
        wet = (mean * self.x_std + self.x_mean) @ self.comps + self.mean
        field = self.elevation.expand(mean.shape[0], -1).clone()
        field[:, self.wet] = wet
        fvar = torch.zeros_like(field)
        fvar[:, self.wet] = var @ (self.x_std[:, None] * self.comps) ** 2
        return field, fvar
