"""GPRAS: the high-level multi-output GP model — the SGPR, SVGP and exact GPs,
fit and served.

Port of ``gpras_tpu/gp/model.py``: one latent
GP per EOF mode, parameters batched along a leading mode axis, posterior
factors cached once and reused by every ``predict``. The reference ``vmap``s (or
``lax.map``s) over modes; here a Python loop walks them. Checkpoints are the
reference's npz + JSON manifest (``utils/serialization.py``), so either
package loads the other's.

SGPR (``model_type="sgpr"``, the default) trains the collapsed ELBO
(``gp/sgpr.py``) with any optimizer of ``fit/optimizers.FITTERS`` from
k-means or grid inducing points (``ops/kmeans.py``); its posterior cache is
(L, LB, c) per mode. It runs plain PyTorch only: no hand-written kernel is
on its path, as none is on the reference's.

SVGP (``model_type="svgp"``) trains the uncollapsed bound (``gp/svgp.py``)
by minibatch Adam, optionally with natural-gradient steps on q, from k-means
inducing points; its posterior is its parameters (no cache), so serving
reads no training set. Plain PyTorch too. The modes' epoch permutations are
drawn in order from one generator on ``device`` seeded with ``seed`` (the
reference splits a JAX key per mode).

Exact training follows the reference's engine ladder (``_loss_fn``): the dense
custom-gradient NLML up to ``LEAN_THRESHOLD`` points, the lean engine's
exact gradient in column panels (``gp/exact_lean.py``) up to
``SUPER_THRESHOLD``, the Hutchinson stochastic-trace engine
(``gp/exact_stochastic.py``, kernels B1, B4 and B5; the in-place
factorization above ``SUPER_THRESHOLD``, ``default_chol_config``) up to
``CG_THRESHOLD``, and above it the matrix-free CG
engine (``gp/exact_cg.make_cg_training_loss``: mbcg over kernel B3, SLQ, the
backward through B5), which holds no (N, N) buffer. ``fit(..., mesh=...)``
runs the exact fit over the ranks of a ``torch.distributed`` mesh through
``parallel/`` (``_fit_distributed``: the same ladder, scaled by the mesh).

The posterior cache follows the reference's ladder: a dense Cholesky factor
per mode up to ``SUPER_THRESHOLD`` training points, the matrix-free CG engine
(``gp/exact_cg.py``: alpha + a rank-64 pivoted-Cholesky preconditioner per
mode, no (N, N) buffer) above it or with ``exact_engine="cg"``.

Everything runs on ``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Literal, Self

import numpy as np
import torch

from gpras_tpu_torch.fit import optimizers as fitters
from gpras_tpu_torch.gp import exact as exact_gp
from gpras_tpu_torch.gp import exact_cg, exact_lean, exact_stochastic, sgpr, svgp, warmstart
from gpras_tpu_torch.gp.exact_cg import cg_posterior_alpha, cg_predict, pivoted_cholesky
from gpras_tpu_torch.ops import kernels as K
from gpras_tpu_torch.ops import kmeans as km
from gpras_tpu_torch.ops import linalg
from gpras_tpu_torch.utils.profiling import count, log_fit_losses, span
from gpras_tpu_torch.utils.serialization import load_artifact, save_artifact

Tensor = torch.Tensor

KernelType = K.KernelName
OptimizerType = Literal[
    "two-stage", "three-stage", "adam", "adadelta", "L-BFGS-B",
    "stochastic", "diffential_evolution", "differential_evolution",
]
InductionInitializerType = Literal["kmeans", "grid"]
ModelBackendType = Literal["sgpr", "svgp", "exact"]


def _sgpr_posterior_cache(kernel: str, params: dict[str, Tensor], x: Tensor, y: Tensor):
    """Per-mode cached factors for repeated prediction: (L, LB, c)."""
    sigma, _, l, a, lb = sgpr._common(kernel, params, x)
    c = linalg.solve_triangular(lb, a @ y[:, None], lower=True)[:, 0] / sigma
    return l, lb, c


def _sgpr_predict_from_cache(kernel: str, params: dict[str, Tensor],
                             cache: tuple[Tensor, Tensor, Tensor], x_test: Tensor):
    l, lb, c = cache
    kus = K.gram(kernel, params, params["z"], x_test)
    tmp1 = linalg.solve_triangular(l, kus, lower=True)
    tmp2 = linalg.solve_triangular(lb, tmp1, lower=True)
    mean = tmp2.T @ c
    var = K.kdiag(kernel, params, x_test) - torch.sum(tmp1 * tmp1, dim=0) + \
        torch.sum(tmp2 * tmp2, dim=0)
    var = torch.clamp_min(var, 0.0) + torch.exp(params["log_noise_variance"])
    return mean, var


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
    """Multi-output GP for HEC-RAS upskilling/emulation (reference
    gpras/gpr.py:217): SGPR, SVGP or the exact GP."""

    #: thresholds of the reference's exact-engine ladder, kept for parity
    #: (sized there for a 16 GB TPU; re-deriving them for an 80 GB card is a
    #: measurement for a later change)
    LEAN_THRESHOLD = 8192
    #: above this N the posterior cache goes matrix-free (no (N, N) factor)
    SUPER_THRESHOLD = 16384
    CG_THRESHOLD = 55000

    def __init__(self, kernel: KernelType, model_type: ModelBackendType = "sgpr",
                 dtype: Any = torch.float32, exact_engine: str = "auto",
                 device: str | torch.device = "cuda") -> None:
        """``exact_engine`` picks the exact GP's training loss ("auto" scales
        with N: dense, then lean above 8,192 points, Hutchinson above 16,384,
        the matrix-free CG engine above 55,000; "dense", "lean" (the exact
        gradient in column panels, ``gp/exact_lean``), "hutchinson", "cg").
        For serving, "cg" forces the matrix-free posterior at any N. Ignored
        by SGPR and SVGP."""
        if kernel not in K.KERNEL_NAMES:
            raise ValueError(f"Unknown kernel {kernel!r}")
        if model_type not in ("sgpr", "svgp", "exact"):
            raise ValueError(f"Unknown model_type {model_type!r}; "
                             "expected 'sgpr', 'svgp' or 'exact'")
        if exact_engine not in ("auto", "dense", "lean", "hutchinson", "cg"):
            raise ValueError(f"Unknown exact_engine {exact_engine!r}")
        self.kernel_str: str = kernel
        self.model_type: str = model_type
        self.exact_engine: str = exact_engine
        self.dtype = _torch_dtype(dtype)
        self.device = torch.device(device)
        self.params: dict[str, Tensor] | None = None  # batched: leading axis = mode
        self.fit_info: dict[str, Any] | None = None
        self.warm_start_info: dict[str, Any] | None = None
        self.x: Tensor | None = None
        self.y: Tensor | None = None
        self.n_inducing: int = 0
        self._cache: tuple | None = None
        self._hutch_loss = None
        self._lean_loss = None
        self._probes: Tensor | None = None
        self._cg_loss = None
        self._cg_draws: tuple[Tensor, Tensor] | None = None

    # ------------------------------------------------------------------ fitting

    def fit(self, x, y, n_inducing: int = 0, inducing_initializer: str = "kmeans",
            optimization_method: str = "two-stage",
            initial_params: dict[str, Tensor] | None = None,
            warm_start_subsample: int = 0, mesh: Any = None, **opt_kwargs: Any) -> None:
        """Fit one latent GP per output column of ``y``, mode after mode.

        The reference's signature and defaults. SGPR and SVGP need
        ``n_inducing`` > 0 inducing points, placed by ``inducing_initializer``
        ("kmeans": k-means centers from a generator seeded 0; "grid"); the
        exact backend ignores both. ``optimization_method`` is any key of
        ``fit/optimizers.FITTERS``; "stochastic" gets ``x`` for its
        inducing-point restarts.
        ``initial_params`` starts from a mode-batched parameter dict (e.g. a
        loaded checkpoint's ``params``).

        ``warm_start_subsample`` first runs the same fit on a uniform
        subsample (every ceil(N / subsample)-th point, used only when N is at
        least twice the subsample), then starts the full-N fit from its
        optimum. In float32 the transfer is clamped and certified by one
        full-N forward loss per mode (``gp/warmstart.py``; the per-mode caps
        and certifying losses land in ``self.warm_start_info``, beside the
        rung's mode-batched optimum before the clamp, ``rung_params``, and
        its ``fit_info`` ``losses`` and ``iterations``, ``rung_losses``).
        The rung runs inside a ``fit.warm_start`` span, the certification
        inside ``fit.certify``.

        For the exact model in float32, "adam" and "two-stage" default to a
        noise-variance floor of 1e-4 and to non-finite step rejection, as in
        the reference.
        ``self.fit_info`` holds the optimizer's per-mode ``iterations``,
        ``losses`` and ``loss``, stacked along the mode axis.

        SVGP trains by minibatch Adam only (``optimization_method="adam"``),
        with the options ``batch_size`` (default min(4096, N)), ``epochs``
        (default ``max_iter``, 100), ``learning_rate`` (0.01), ``seed`` (0)
        and ``natgrad`` (the natural-gradient step's rate on q, default
        off); any other option raises. Its ``fit_info`` holds ``losses``,
        the epochs' mean losses per mode.
        """
        if self.model_type in ("sgpr", "svgp") and n_inducing <= 0:
            raise ValueError("sparse backends require n_inducing > 0 "
                             "(use model_type='exact' for a dense GP)")
        if mesh is not None and self.model_type != "exact":
            raise ValueError("mesh-distributed fitting supports model_type='exact' (the "
                             "distributed engine ladder)")
        if optimization_method not in fitters.FITTERS:
            raise ValueError(f"Unknown optimizer {optimization_method!r}; expected one of "
                             f"{sorted(fitters.FITTERS)}")
        # invalidate BEFORE mutating: a fit that raises mid-way must not
        # leave stale posterior factors paired with the new training data
        self._cache = None
        self.params = None
        self.fit_info = None
        # contiguous: the CUDA kernels take row-major tensors (a strided
        # caller's x, or a rung's subsample, would be refused on the card)
        self.x = torch.as_tensor(x, dtype=self.dtype, device=self.device).contiguous()
        self.y = torch.as_tensor(y, dtype=self.dtype, device=self.device).contiguous()
        if self.y.ndim == 1:
            self.y = self.y[:, None]
        self.n_inducing = int(n_inducing)
        p_modes = self.y.shape[1]
        n = self.x.shape[0]
        # the engine closures and the probes are built for one N
        self._hutch_loss = None
        self._lean_loss = None
        self._probes = None
        self._cg_loss = None
        self._cg_draws = None

        warm_ratio_cap = float(opt_kwargs.pop("warm_ratio_cap", warmstart.DEFAULT_RATIO_CAP))
        self.warm_start_info = None
        if warm_start_subsample > 0 and self.model_type == "exact" \
                and initial_params is None and n >= 2 * warm_start_subsample:
            # ceil stride keeps the warm stage at <= subsample points
            stride = -(-n // warm_start_subsample)
            warm = GPRAS(self.kernel_str, model_type="exact", dtype=self.dtype,
                         exact_engine=self.exact_engine, device=self.device)
            with span("fit.warm_start"):
                warm.fit(self.x[::stride].contiguous(), self.y[::stride].contiguous(),
                         optimization_method=optimization_method, **opt_kwargs)
            initial_params = warm.params
            # the rung's optimum before the clamp, and its loss history
            self.warm_start_info = {
                "rung_params": warm.params,
                "rung_losses": {k: warm.fit_info[k] for k in ("losses", "iterations")}}
            if self.dtype == torch.float32:
                # clamp + certify the rung's parameters against the full-N loss
                fallback = {k: v.expand((p_modes,) + v.shape)
                            for k, v in exact_gp.init_params(self.kernel_str, self.x).items()}
                with span("fit.certify"):
                    initial_params, info = warmstart.certify_transfer_batched(
                        lambda p, i: self._loss_fn(p, self.y[:, i]), initial_params, fallback,
                        ratio_cap=warm_ratio_cap)
                self.warm_start_info.update(info)

        if initial_params is not None:
            lead = next(iter(initial_params.values())).shape[0]
            if lead != p_modes:
                raise ValueError(f"initial_params has {lead} modes, y has {p_modes}")
            batched0 = {k: torch.as_tensor(v, dtype=self.dtype, device=self.device)
                        for k, v in initial_params.items()}
        else:
            # the same init for every mode (leading axis = mode)
            batched0 = {k: v.expand((p_modes,) + v.shape)
                        for k, v in self._init_params(inducing_initializer).items()}

        if mesh is not None:
            self._fit_distributed(mesh, batched0, optimization_method, opt_kwargs)
            return
        if self.model_type == "svgp":
            self._fit_svgp(batched0, optimization_method, opt_kwargs)
            return

        fitter = fitters.FITTERS[optimization_method]
        if optimization_method == "stochastic":
            opt_kwargs.setdefault("x", self.x)
        if self.model_type == "exact" and self.dtype == torch.float32 \
                and optimization_method in ("adam", "two-stage"):
            # float32 guards (overridable): a noise floor and non-finite step
            # rejection; without them a large-N exact fit NaNs once Adam
            # overshoots what the factorization can represent
            opt_kwargs.setdefault("lower_bounds", {"log_noise_variance": math.log(1e-4)})
            opt_kwargs.setdefault("reject_nonfinite", True)
        fitted, infos = [], []
        for i in range(p_modes):
            y_i = self.y[:, i]
            with span("fit.mode"):
                p_i, info = fitter(lambda p, y_i=y_i: self._loss_fn(p, y_i),
                                   {k: v[i].contiguous() for k, v in batched0.items()},
                                   **opt_kwargs)
            fitted.append(p_i)
            infos.append(info)
        self.params = {k: torch.stack([p[k] for p in fitted]) for k in fitted[0]}
        self.fit_info = {k: torch.stack([torch.as_tensor(info[k]) for info in infos])
                         for k in infos[0]}
        self._cache = None
        if "evolution" not in optimization_method:
            # DE's "losses" are the final population's energies, not a history
            log_fit_losses(self.fit_info, name=f"GPRAS[{self.kernel_str}/{self.model_type}]")

    @staticmethod
    def _resolve_mesh(mesh: Any):
        """A ``DeviceMesh`` passes through; ``"auto"`` builds the largest 2-D
        mesh (axes "i", "j", di >= dj) over every rank of the initialized
        default process group, 1-D ("i") when the world size has no such
        split."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from gpras_tpu_torch.parallel.mesh import make_mesh

        if isinstance(mesh, DeviceMesh):
            return mesh
        if mesh == "auto":
            if not dist.is_initialized():
                raise RuntimeError(
                    "mesh='auto' needs an initialized torch.distributed process group: "
                    "launch under torchrun, or call torch.distributed.init_process_group "
                    "first")
            n_dev = dist.get_world_size()
            dj = int(math.floor(math.sqrt(n_dev)))
            while dj > 1 and n_dev % dj:
                dj -= 1
            if dj > 1:
                return make_mesh((n_dev // dj, dj), ("i", "j"))
            return make_mesh((n_dev,), ("i",))
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh or 'auto', got {mesh!r}")

    @staticmethod
    def _dist_block(n: int, mesh: Any) -> int:
        """Largest Cholesky block <= 128 dividing every per-axis local extent
        (the pcholesky / pcholesky2d divisibility contract)."""
        b = 128
        for size in mesh.shape:
            local = n // size
            while b > 8 and local % b:
                b //= 2
        return b

    def _fit_distributed(self, mesh: Any, batched0: dict[str, Tensor],
                         optimization_method: str, opt_kwargs: dict[str, Any]) -> None:
        """The exact GP fit over a mesh of ranks (``parallel/``), mode after
        mode, every rank running this same call on the whole x and y.

        Engine ladder (the single-card one scaled by the mesh): the dense
        exact backward (``pexact.make_dist_nlml``) up to SUPER_THRESHOLD,
        the Hutchinson backward (``make_dist_nlml_stochastic``) above it,
        and the matrix-free CG engine (``pcg.make_dist_cg_nlml``) once N
        exceeds CG_THRESHOLD * sqrt(ranks), the sharded Gram's aggregate
        ceiling; CG shards rows over one axis, so a 2-D mesh is flattened.
        The probes are drawn once (the single-card engine's fixed draws,
        the same on every rank), so the objective is deterministic and
        every optimizer applies. ``fit_info`` adds ``dist_engine`` and
        ``dist_mesh_shape``; the fitted parameters are the same on every
        rank."""
        from gpras_tpu_torch.parallel.mesh import _index, make_mesh

        mesh = self._resolve_mesh(mesh)
        n = self.x.shape[0]
        n_dev = math.prod(mesh.shape)
        for ax, size in zip(mesh.mesh_dim_names, mesh.shape):
            if n % size:
                raise ValueError(f"N={n} must divide by mesh axis {ax!r}={size}")
        engine = self.exact_engine
        if engine == "auto":
            if n > int(self.CG_THRESHOLD * math.sqrt(n_dev)):
                engine = "cg"
            elif n > self.SUPER_THRESHOLD:
                engine = "hutchinson"
            else:
                engine = "dense"
        elif engine == "lean":
            engine = "dense"  # the panel-scan backward is single-card only
        if engine == "cg":
            from gpras_tpu_torch.parallel.pcg import make_dist_cg_nlml

            if len(mesh.shape) > 1:
                # the matrix-free engine shards rows over one axis: all ranks
                # hold rows instead of repeating the solve over "j"
                mesh = make_mesh((n_dev,), ("i",))
            probes = int(opt_kwargs.pop("probes", 16))
            rank = int(opt_kwargs.pop("precond_rank", 64))
            _, dloss = make_dist_cg_nlml(mesh, self.kernel_str, probes=probes,
                                         max_iters=int(opt_kwargs.pop("cg_iters", 32)),
                                         precond_rank=rank)
            opt_kwargs.pop("dist_block", None)
            if rank > 0:
                draws = exact_cg.precond_probes(n, rank, probes, dtype=self.dtype,
                                                device=self.device)
            else:
                draws = exact_stochastic.rademacher_probes(n, probes, dtype=self.dtype,
                                                           device=self.device)
            nl = n // n_dev
            r0 = _index(mesh, "i") * nl
            x_local = self.x[r0:r0 + nl].contiguous()
            loss = lambda p, y_i: dloss(p, x_local, y_i, draws)
        else:
            from gpras_tpu_torch.gp.priors import log_prior
            from gpras_tpu_torch.parallel import pexact

            b = int(opt_kwargs.pop("dist_block", 0)) or self._dist_block(n, mesh)
            if engine == "hutchinson":
                probes = int(opt_kwargs.pop("probes", 16))
                dnlml = pexact.make_dist_nlml_stochastic(mesh, self.kernel_str, b=b,
                                                         probes=probes)
                z = exact_stochastic.rademacher_probes(n, probes, dtype=self.dtype,
                                                       device=self.device)
                loss = lambda p, y_i: dnlml(p, self.x, y_i, z) - log_prior(p)
            elif engine == "dense":
                dnlml = pexact.make_dist_nlml(mesh, self.kernel_str, b=b)
                loss = lambda p, y_i: dnlml(p, self.x, y_i) - log_prior(p)
            else:
                raise ValueError(f"unknown distributed engine {engine!r}; "
                                 "expected auto|dense|hutchinson|cg")
        if self.dtype == torch.float32 and optimization_method in ("adam", "two-stage"):
            opt_kwargs.setdefault("lower_bounds", {"log_noise_variance": math.log(1e-4)})
            opt_kwargs.setdefault("reject_nonfinite", True)
        fitter = fitters.FITTERS[optimization_method]
        fitted, infos = [], []
        for i in range(self.y.shape[1]):
            y_i = self.y[:, i].contiguous()
            p_i, info = fitter(lambda p, y_i=y_i: loss(p, y_i),
                               {k: v[i].contiguous() for k, v in batched0.items()},
                               **opt_kwargs)
            fitted.append(p_i)
            infos.append(info)
        self.params = {k: torch.stack([p[k] for p in fitted]) for k in fitted[0]}
        self.fit_info = {k: torch.stack([torch.as_tensor(info[k]) for info in infos])
                         for k in infos[0]}
        self.fit_info["dist_engine"] = engine
        self.fit_info["dist_mesh_shape"] = tuple(mesh.shape)

    def _fit_svgp(self, batched0: dict[str, Tensor], optimization_method: str,
                  opt_kwargs: dict[str, Any]) -> None:
        """Minibatch SVGP, mode after mode (``gp/svgp.make_minibatch_fit``);
        the zoo's full-batch fitters do not apply."""
        if optimization_method != "adam":
            raise ValueError("model_type='svgp' trains with minibatch Adam; pass "
                             f"optimization_method='adam' (got {optimization_method!r})")
        bs = int(opt_kwargs.pop("batch_size", min(4096, self.x.shape[0])))
        epochs = int(opt_kwargs.pop("epochs", opt_kwargs.pop("max_iter", 100)))
        lr = float(opt_kwargs.pop("learning_rate", 0.01))
        seed = int(opt_kwargs.pop("seed", 0))
        ng = opt_kwargs.pop("natgrad", None)
        if opt_kwargs:
            raise ValueError(f"unsupported svgp fit options: {sorted(opt_kwargs)}")
        fit_fn = svgp.make_minibatch_fit(self.kernel_str, batch_size=bs, epochs=epochs,
                                         learning_rate=lr,
                                         natgrad=None if ng is None else float(ng))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        fitted, hists = [], []
        for i in range(self.y.shape[1]):
            p_i, hist = fit_fn({k: v[i].contiguous() for k, v in batched0.items()}, self.x,
                               self.y[:, i], gen)
            fitted.append(p_i)
            hists.append(hist)
        self.params = {k: torch.stack([p[k] for p in fitted]) for k in fitted[0]}
        self.fit_info = {"losses": torch.stack(hists)}
        self._cache = None
        log_fit_losses(self.fit_info, name=f"GPRAS[{self.kernel_str}/svgp]")

    def _engine(self) -> str:
        """The training engine for the current N (the reference's ladder)."""
        n = self.x.shape[0]
        engine = self.exact_engine
        if engine == "auto":
            if n > self.CG_THRESHOLD:
                engine = "cg"
            elif n > self.SUPER_THRESHOLD:
                engine = "hutchinson"
            elif n > self.LEAN_THRESHOLD:
                engine = "lean"
            else:
                engine = "dense"
        return engine

    def _loss_fn(self, params: dict[str, Tensor], y_i: Tensor) -> Tensor:
        """Mode ``y_i``'s training loss at ``params``: -(ELBO + log prior)
        for SGPR and SVGP (its full-batch bound; training takes minibatches),
        NLML minus log prior for the exact GP. One ``fit.eval`` span."""
        with span("fit.eval"):
            return self._loss(params, y_i)

    def _loss(self, params: dict[str, Tensor], y_i: Tensor) -> Tensor:
        if self.model_type == "sgpr":
            return sgpr.training_loss(self.kernel_str, params, self.x, y_i)
        if self.model_type == "svgp":
            return svgp.training_loss(self.kernel_str, params, self.x, y_i, self.x.shape[0])
        engine = self._engine()
        if engine == "cg":
            if self._cg_loss is None:
                # the reference's knobs: a rank-64 pivoted-Cholesky
                # preconditioner (in float32 the rank, not the iteration
                # count, is the conditioning dial), 16 probes, 32 iterations
                self._cg_loss = exact_cg.make_cg_training_loss(self.kernel_str, probes=16,
                                                               max_iters=32, precond_rank=64)
                # fixed draws: a deterministic objective (the reference's PRNGKey(0))
                self._cg_draws = exact_cg.precond_probes(self.x.shape[0], 64, 16,
                                                         dtype=self.dtype, device=self.device)
            return self._cg_loss(params, self.x, y_i, self._cg_draws)
        if engine == "hutchinson":
            n = self.x.shape[0]
            if self._hutch_loss is None:
                self._hutch_loss = exact_stochastic.make_hutchinson_training_loss(
                    self.kernel_str, **exact_stochastic.default_chol_config(n))
                # fixed probes: a deterministic objective (the reference's PRNGKey(0))
                self._probes = exact_stochastic.rademacher_probes(
                    n, 16, dtype=self.dtype, device=self.device)
            return self._hutch_loss(params, self.x, y_i, self._probes)
        if engine == "lean":
            if self._lean_loss is None:
                n = self.x.shape[0]
                self._lean_loss = exact_lean.make_lean_training_loss(
                    self.kernel_str, engine="super" if n > self.SUPER_THRESHOLD else None,
                    chol_strip=16384 if n <= 32768 else 4096)
            return self._lean_loss(params, self.x, y_i)
        return exact_gp.training_loss(self.kernel_str, params, self.x, y_i)

    def _init_params(self, inducing_initializer: str) -> dict[str, Tensor]:
        if self.model_type == "exact":
            return exact_gp.init_params(self.kernel_str, self.x)
        z = self._create_inducing(self.x, self.n_inducing, inducing_initializer)
        if self.model_type == "svgp":
            return svgp.init_params(self.kernel_str, self.x, z)
        return sgpr.init_params(self.kernel_str, self.x, z)

    @staticmethod
    def _create_inducing(x: Tensor, n_inducing: int, method: str) -> Tensor:
        """k-means cluster centers or the per-feature grid (gpras/gpr.py:310-320)."""
        if method == "kmeans":
            return km.kmeans_inducing(x, n_inducing, seed=0)
        if method == "grid":
            return km.grid_inducing(x, n_inducing)
        raise ValueError(f"Unknown inducing initializer {method!r}")

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
        if self.model_type == "svgp":
            self._cache = ()  # the variational posterior is the model's state
        elif self.model_type == "sgpr":
            self._cache = tuple(_sgpr_posterior_cache(self.kernel_str, p, self.x, self.y[:, i])
                                for i, p in enumerate(modes))
        elif self._matrix_free:
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
        count("host_reads")  # the copy up waits for the device's queue
        xq = torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)
        self._ensure_cache()
        means, variances = [], []
        for i in range(self._n_modes):
            p = self._mode_params(i)
            if self.model_type == "svgp":
                mean, var = svgp.predict(self.kernel_str, p, xq)
            elif self.model_type == "sgpr":
                mean, var = _sgpr_predict_from_cache(self.kernel_str, p, self._cache[i], xq)
            elif self._matrix_free:
                mean, var = cg_predict(self.kernel_str, p, self.x, self.y[:, i], xq,
                                       alpha=self._cache[0][i], l_pc=self._cache[1][i])
            else:
                mean, var = _exact_predict_from_cache(self.kernel_str, p, self._cache[i],
                                                      self.x, xq)
            means.append(mean)
            variances.append(var)
        count("host_reads", 2)
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
    def from_file(cls, path: str | Path, device: str | torch.device = "cuda") -> Self:
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
