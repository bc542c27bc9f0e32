"""Production serving: batched posterior prediction from checkpoint artifacts.

Port of ``gpras_tpu/gp/serving.py``. ``PosteriorPredictor`` loads a GPRAS
checkpoint once, precomputes the per-mode posterior factors on ``device``,
and pads query batches up to a fixed bucket ladder, so repeated requests of
varying size run a handful of shapes (the matrix-free engine chunks its
variance solves by the largest divisor <= 256 of the padded count). It
composes the EOF transforms, so callers get full cell fields with
propagated variance.
"""

from __future__ import annotations

from collections.abc import Callable
from pathlib import Path

import numpy as np
import torch

from gpras_tpu_torch.eof.preprocessor import PreProcessor
from gpras_tpu_torch.gp.model import GPRAS
from gpras_tpu_torch.utils.profiling import count, span

DEFAULT_BUCKETS = (256, 1024, 4096, 16384)


def make_field_decoder(
    eofs: np.ndarray,
    x_mean: np.ndarray,
    x_std: np.ndarray,
    input_mean: np.ndarray,
    dry_mask: np.ndarray,
    weights: np.ndarray | None = None,
    elevations: np.ndarray | None = None,
    hydraulic_parameter: str = "wse",
    device: str | torch.device = "cuda",
) -> Callable:
    """On-device EOF reverse transform: ``(mode_mean, mode_var) -> (field,
    field_var)`` tensors on ``device``, numerically the same as
    ``PreProcessor.reverse_transform``.

    ``eofs`` is (modes, n_wet); ``dry_mask`` is the (n_cells,) boolean
    always-dry mask; inputs are (events, modes), outputs (events, n_cells).
    Dry cells are filled with 0 (depth) or elevation (wse); their variance
    is 0.
    """
    dev = torch.device(device)
    dry_mask = np.asarray(dry_mask, bool)
    n_cells = dry_mask.shape[0]
    wet_idx = torch.as_tensor(np.flatnonzero(~dry_mask), device=dev)
    eofs_d = torch.as_tensor(np.asarray(eofs), device=dev)
    dtype = eofs_d.dtype
    x_mean_d = torch.as_tensor(np.asarray(x_mean), dtype=dtype, device=dev)
    x_std_d = torch.as_tensor(np.asarray(x_std), dtype=dtype, device=dev)
    input_mean_d = torch.as_tensor(np.asarray(input_mean), dtype=dtype, device=dev)
    inv_w = (None if weights is None else
             1.0 / torch.as_tensor(np.asarray(weights), dtype=dtype, device=dev))
    # exact variance-propagation matrix: (diag(x_std) @ eofs / weights)^2
    a = x_std_d[:, None] * eofs_d
    if inv_w is not None:
        a = a * inv_w[None, :]
    var_transform = a * a
    if hydraulic_parameter == "depth":
        fill = torch.zeros((n_cells,), dtype=dtype, device=dev)
    else:
        if elevations is None:
            raise ValueError("wse decoding requires elevations for dry fill")
        elev = torch.as_tensor(np.asarray(elevations), dtype=dtype, device=dev)
        fill = torch.where(torch.as_tensor(dry_mask, device=dev), elev, 0.0)

    def decode(mode_mean, mode_var=None):
        if not isinstance(mode_mean, torch.Tensor):
            count("host_reads")  # the copy up waits for the device's queue
        mode_mean = torch.as_tensor(mode_mean, dtype=dtype, device=dev)
        wet = (mode_mean * x_std_d + x_mean_d) @ eofs_d
        if inv_w is not None:
            wet = wet * inv_w[None, :]
        wet = wet + input_mean_d
        s = mode_mean.shape[0]
        full = fill.expand(s, n_cells).clone()
        full[:, wet_idx] = wet
        if mode_var is None:
            return full
        if not isinstance(mode_var, torch.Tensor):
            count("host_reads")
        var_wet = torch.as_tensor(mode_var, dtype=dtype, device=dev) @ var_transform
        var_full = torch.zeros((s, n_cells), dtype=dtype, device=dev)
        var_full[:, wet_idx] = var_wet
        return full, var_full

    return decode


def field_decoder_from_preprocessor(pre: PreProcessor) -> Callable:
    """Build the decoder from a fitted ``PreProcessor``, on its device."""
    return make_field_decoder(
        pre.eofs, pre.x_mean, pre.x_std, pre.input_mean, pre.dry_indices,
        weights=pre.weights, elevations=pre.elevations,
        hydraulic_parameter=pre.hydraulic_parameter, device=pre.device)


class PosteriorPredictor:
    """Serve a GPRAS checkpoint (and optional EOF preprocessors) on ``device``."""

    def __init__(self, model_path: str | Path,
                 hf_preprocessor_path: str | Path | None = None,
                 lf_preprocessor_path: str | Path | None = None,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.model = GPRAS.from_file(model_path, device=self.device)
        self.model._ensure_cache()  # factorize once at load time
        self.buckets = tuple(sorted(buckets))
        self._decoder = None
        self.hf_pre = (PreProcessor.from_file(hf_preprocessor_path, device=self.device)
                       if hf_preprocessor_path else None)
        # no silent HF fallback: the HF basis applied to an LF field is
        # garbage whenever the meshes share a cell count
        self.lf_pre = (PreProcessor.from_file(lf_preprocessor_path, device=self.device)
                       if lf_preprocessor_path else None)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return n  # beyond the ladder: the exact size

    def _predict_modes_padded(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
        """(mean, variance, n) at the padded bucket size (rows >= n come from
        zero-padded queries and are sliced off by callers)."""
        x = np.asarray(x)
        n = x.shape[0]
        b = self._bucket(n)
        if b > n:
            x = np.concatenate([x, np.zeros((b - n, x.shape[1]), x.dtype)])
        mean, var = self.model.predict(x)
        return mean, var, n

    def predict_modes(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(mean, variance) in EOF-mode space, padded to a bucket."""
        mean, var, n = self._predict_modes_padded(x)
        return mean[:n], var[:n]

    def predict_field(self, lf_field: np.ndarray, *, device_decode: bool = True
                      ) -> tuple[np.ndarray, np.ndarray]:
        """LF cell field -> (HF field, variance): LF transform -> GP posterior
        -> reverse transform with variance. ``device_decode`` decodes on the
        predictor's device (``make_field_decoder``); False takes the
        preprocessor's ``reverse_transform``."""
        if self.lf_pre is None or self.hf_pre is None:
            raise RuntimeError("predict_field requires preprocessor artifacts")
        with span("serve.request"):
            with span("serve.lf_transform"):
                x = self.lf_pre.transform(np.asarray(lf_field))
            if device_decode:
                with span("serve.posterior"):
                    mean, var, n = self._predict_modes_padded(x)
                with span("serve.decode"):
                    if self._decoder is None:
                        self._decoder = field_decoder_from_preprocessor(self.hf_pre)
                    f, fv = self._decoder(np.asarray(mean, np.float64),
                                          np.asarray(var, np.float64))
                with span("serve.copy_back"):
                    count("host_reads", 2)
                    return f[:n].cpu().numpy(), fv[:n].cpu().numpy()
            with span("serve.posterior"):
                mean, var = self.predict_modes(x)
            with span("serve.decode"):
                return self.hf_pre.reverse_transform(mean, var)

    def warmup(self, n_features: int | None = None) -> None:
        """Run every bucket once (and the field decoder, when the EOF
        artifacts are loaded), so first requests pay no one-time set-up."""
        if n_features is None:
            n_features = int(self.model.x.shape[1])
        decode = None
        if self.hf_pre is not None:
            if self._decoder is None:
                self._decoder = field_decoder_from_preprocessor(self.hf_pre)
            decode = self._decoder
        for b in self.buckets:
            mean, var = self.predict_modes(np.zeros((b, n_features), dtype=np.float32))
            if decode is not None:
                decode(np.asarray(mean, np.float64), np.asarray(var, np.float64))
