"""GPRAS: the high-level multi-output GP model — exact-GP serving.

Port of the exact branch of ``gpras_tpu/gp/model.py``: one latent GP per EOF
mode, parameters batched along a leading mode axis, posterior factors cached
once and reused by every ``predict``. The reference ``vmap``s over modes;
here a Python loop walks them. Checkpoints are the reference's npz + JSON
manifest (``utils/serialization.py``), so either package loads the other's.

The posterior cache follows the reference's ladder: a dense Cholesky factor
per mode up to ``SUPER_THRESHOLD`` training points, the matrix-free CG engine
(``gp/exact_cg.py``: alpha + a rank-64 pivoted-Cholesky preconditioner per
mode, no (N, N) buffer) above it or with ``exact_engine="cg"``.

Not ported yet (ROADMAP.md, queue A): ``fit`` (raises NotImplementedError)
and the ``sgpr`` / ``svgp`` backends (their construction raises).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Literal, Self

import numpy as np
import torch

from gpras_tpu_torch.gp import exact as exact_gp
from gpras_tpu_torch.gp.exact_cg import cg_posterior_alpha, cg_predict, pivoted_cholesky
from gpras_tpu_torch.ops import kernels as K
from gpras_tpu_torch.ops import linalg
from gpras_tpu_torch.utils.serialization import load_artifact, save_artifact

Tensor = torch.Tensor

KernelType = K.KernelName
ModelBackendType = Literal["sgpr", "svgp", "exact"]


def _exact_posterior_cache(kernel: str, params: dict[str, Tensor], x: Tensor, y: Tensor):
    kmat = exact_gp.build_train_gram(kernel, params, x)
    # noise variance is already on the diagonal; escalate jitter only on failure
    l = linalg.safe_cholesky(kmat, jitter=0.0)
    alpha = linalg.cho_solve(l, y[:, None])[:, 0]
    return l, alpha


def _exact_predict_from_cache(kernel: str, params: dict[str, Tensor],
                              cache: tuple[Tensor, Tensor], x_train: Tensor, x_test: Tensor):
    l, alpha = cache
    ks = K.gram(kernel, params, x_test, x_train)
    mean = ks @ alpha
    v = linalg.solve_triangular(l, ks.T, lower=True)
    var = K.kdiag(kernel, params, x_test) - torch.sum(v * v, dim=0)
    var = torch.clamp_min(var, 0.0) + torch.exp(params["log_noise_variance"])
    return mean, var


def _torch_dtype(dtype: Any) -> torch.dtype:
    """torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


class GPRAS:
    """Multi-output GP for HEC-RAS upskilling/emulation — exact-GP serving."""

    #: thresholds of the reference's exact-engine ladder, kept for parity
    #: (sized there for a 16 GB TPU; re-deriving them for an 80 GB card is a
    #: measurement for a later change)
    LEAN_THRESHOLD = 8192
    #: above this N the posterior cache goes matrix-free (no (N, N) factor)
    SUPER_THRESHOLD = 16384
    CG_THRESHOLD = 55000

    def __init__(self, kernel: KernelType, model_type: ModelBackendType = "sgpr",
                 dtype: Any = torch.float32, exact_engine: str = "auto",
                 device: str | torch.device = "cpu") -> None:
        """``exact_engine`` names the reference's exact training engines
        ("auto", "dense", "lean", "hutchinson", "cg"); for serving only "cg"
        matters: it forces the matrix-free posterior at any N."""
        if kernel not in K.KERNEL_NAMES:
            raise ValueError(f"Unknown kernel {kernel!r}")
        if model_type not in ("sgpr", "svgp", "exact"):
            raise ValueError(f"Unknown model_type {model_type!r}; "
                             "expected 'sgpr', 'svgp' or 'exact'")
        if model_type != "exact":
            raise NotImplementedError(
                f"model_type={model_type!r} is not ported yet (ROADMAP.md queue A: "
                "A2 for sgpr, A5 for svgp); the port serves model_type='exact'")
        if exact_engine not in ("auto", "dense", "lean", "hutchinson", "cg"):
            raise ValueError(f"Unknown exact_engine {exact_engine!r}")
        self.kernel_str: str = kernel
        self.model_type: str = model_type
        self.exact_engine: str = exact_engine
        self.dtype = _torch_dtype(dtype)
        self.device = torch.device(device)
        self.params: dict[str, Tensor] | None = None  # batched: leading axis = mode
        self.x: Tensor | None = None
        self.y: Tensor | None = None
        self.n_inducing: int = 0
        self._cache: tuple | None = None

    def fit(self, x, y, *args: Any, **kwargs: Any) -> None:
        """Training is not ported yet."""
        raise NotImplementedError(
            "GPRAS.fit is not ported yet: training is ROADMAP.md queue A item A1 "
            "(exact-GP fit); load a checkpoint written by gpras_tpu with from_file")

    # --------------------------------------------------------------- prediction

    @property
    def _n_modes(self) -> int:
        return next(iter(self.params.values())).shape[0]

    def _mode_params(self, i: int) -> dict[str, Tensor]:
        return {k: v[i] for k, v in self.params.items()}

    def _ensure_cache(self) -> None:
        if self._cache is not None:
            return
        if self.params is None:
            raise RuntimeError("from_file() must run before predict()")
        modes = [self._mode_params(i) for i in range(self._n_modes)]
        if self._matrix_free:
            # alpha (batched CG solve) plus the per-mode rank-64 pivoted-
            # Cholesky preconditioner, built once per model, not per predict
            alphas = [cg_posterior_alpha(self.kernel_str, p, self.x, self.y[:, i],
                                         precond_rank=64) for i, p in enumerate(modes)]
            l_pcs = [pivoted_cholesky(self.kernel_str, p, self.x, 64) for p in modes]
            self._cache = (alphas, l_pcs)
        else:
            self._cache = tuple(_exact_posterior_cache(self.kernel_str, p, self.x, self.y[:, i])
                                for i, p in enumerate(modes))

    def predict(self, x) -> tuple[np.ndarray, np.ndarray]:
        """Posterior predictive (mean, variance), each (n_samples, n_modes), as
        host numpy arrays; the variance includes the likelihood noise."""
        xq = torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)
        self._ensure_cache()
        means, variances = [], []
        for i in range(self._n_modes):
            p = self._mode_params(i)
            if self._matrix_free:
                mean, var = cg_predict(self.kernel_str, p, self.x, self.y[:, i], xq,
                                       alpha=self._cache[0][i], l_pc=self._cache[1][i])
            else:
                mean, var = _exact_predict_from_cache(self.kernel_str, p, self._cache[i],
                                                      self.x, xq)
            means.append(mean)
            variances.append(var)
        return (torch.stack(means, dim=1).cpu().numpy(),
                torch.stack(variances, dim=1).cpu().numpy())

    @property
    def _matrix_free(self) -> bool:
        """True when the exact posterior must avoid any (N, N) buffer: above
        SUPER_THRESHOLD a dense cache would hold one (N, N) factor per mode."""
        if self.model_type != "exact" or self.x is None:
            return False
        return self.exact_engine == "cg" or self.x.shape[0] > self.SUPER_THRESHOLD

    # ------------------------------------------------------------ serialization

    def to_file(self, path: str | Path, model_dir: str | Path | None = None) -> None:
        """The reference's npz checkpoint (kernel, data, per-mode params);
        ``model_dir`` is accepted for signature parity and ignored."""
        if self.params is None:
            raise RuntimeError("Nothing to save: load or fit a model first")
        meta = {
            "kernel": self.kernel_str,
            "model_type": self.model_type,
            "exact_engine": self.exact_engine,
            "n_inducing": self.n_inducing,
            "dtype": str(self.x.dtype).removeprefix("torch."),
            "param_names": sorted(self.params.keys()),
        }
        arrays = {"x": self.x.cpu().numpy(), "y": self.y.cpu().numpy()}
        for k, v in self.params.items():
            arrays[f"param_{k}"] = v.cpu().numpy()
        save_artifact(path, meta, arrays)

    @classmethod
    def from_file(cls, path: str | Path, device: str | torch.device = "cpu") -> Self:
        meta, arrays = load_artifact(path)
        inst = cls(meta["kernel"], model_type=meta["model_type"], dtype=meta["dtype"],
                   exact_engine=meta.get("exact_engine", "auto"), device=device)
        inst.n_inducing = int(meta["n_inducing"])
        inst.x = torch.as_tensor(arrays["x"], dtype=inst.dtype, device=inst.device)
        inst.y = torch.as_tensor(arrays["y"], dtype=inst.dtype, device=inst.device)
        # the Polynomial degree keeps its stored dtype, as in the reference
        inst.params = {
            name: torch.as_tensor(arrays[f"param_{name}"], device=inst.device,
                                  dtype=None if name == "degree" else inst.dtype)
            for name in meta["param_names"]
        }
        return inst

    # ------------------------------------------------------------------- extras

    @property
    def models(self) -> list[dict[str, np.ndarray]]:
        """Per-mode constrained hyperparameters (diagnostic convenience)."""
        if self.params is None:
            return []
        out = []
        for i in range(self._n_modes):
            mode = {k: v[i].cpu().numpy() for k, v in self.params.items()}
            out.append({k[4:] if k.startswith("log_") else k:
                        np.exp(v) if k.startswith("log_") else v
                        for k, v in mode.items()})
        return out
