"""The port's public surface against the JAX package's.

C4's calls (ROADMAP.md queue C): ``certify_transfer``'s and
``certify_transfer_batched``'s ``min_cap``, ``log_prior``'s ``names``, the
``fit`` package's re-exports and ``gp/model.py``'s ``Literal`` aliases are
accepted by the port and return the reference's values (float64, 1e-12).

Then an ``inspect.signature`` diff of every public function and method of
the two packages (``parallel/`` included), held to ``DEVIATIONS``: exactly
the deviations ROADMAP.md's queue A records, each with the differences it
accounts for. A difference no deviation records fails the test, and so does
a recorded difference that is gone."""

import importlib
import inspect
import math
import pkgutil
import typing

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import t64

DEVICE_ARG = [
    "accuracy.run_exact_path", "accuracy.run_path",
    "data.builders.PseudoSurfaceDataBuilder.__init__",
    "eof.preprocessor.HmsPreProcessor.__init__", "eof.preprocessor.HmsPreProcessor.from_file",
    "eof.preprocessor.PreProcessor.__init__", "eof.preprocessor.PreProcessor.from_file",
    "gp.model.GPRAS.__init__", "gp.model.GPRAS.from_file",
    "gp.serving.PosteriorPredictor.__init__", "gp.serving.make_field_decoder",
    "metrics.metrics.export_metric_summary", "ops.kernels.init_params",
    "pipeline.cross_validation.run_cv", "pipeline.cross_validation.run_cv_serial",
    "pipeline.cross_validation.run_inducing_points", "pipeline.cross_validation.run_kernels",
    "pipeline.cross_validation.run_optimization_method",
    "pipeline.cross_validation.run_spatial_modes", "pipeline.cross_validation.setup",
    "pipeline.event_selection.EventSelection.__init__",
    "pipeline.pipeline.get_data_extracter", "pipeline.pipeline.get_hf_pre_processor",
    "pipeline.pipeline.get_hms_preprocessor", "pipeline.pipeline.get_pre_processors",
    "pipeline.pipeline.pipeline",
]

#: ROADMAP.md queue A's recorded deviations, one key per bullet in its
#: order -> the signature differences each accounts for: "-name" a function
#: or method only the JAX package has, "+name" one only the port has,
#: "name: -arg" / "name: +arg" a parameter only the JAX package's / the
#: port's signature has. A deviation of behaviour alone accounts for none.
DEVIATIONS = {
    "kernels: the Pallas bodies are CUDA kernels with their own wrappers": [
        "-ops.pallas_gram.gram", "-ops.pallas_gram.pallas_gram", "-ops.pallas_gram.pallas_kgrad",
        "-ops.pallas_gram.pallas_kmv"] + [f"+ops.fused_gram.{n}" for n in (
            "gram", "gram_plain", "gram_plan", "gram_smem", "kgrad", "kgrad_dense",
            "kgrad_dense_plan", "kgrad_plain", "kgrad_sym", "kgrad_sym_plan", "kmv_dense",
            "kmv_dense_plan", "kmv_dense_smem", "kmv_plain", "kmv_sym", "kmv_sym_plan",
            "kmv_sym_smem")],
    "the port's own helpers: torch has no jax.value_and_grad or pytree converters": [
        "+fit.optimizers.value_and_grad", "+utils.convert.params_from_numpy",
        "+utils.convert.params_to_numpy"],
    "kmv_cross picks B2 by the training-side N": [],
    "arguments that only steer the TPU are dropped": [
        "gp.exact_cg.kmv: -precision", "gp.exact_cg.kmv: -sub",
        "gp.exact_cg.kmv_cross: -precision", "gp.exact_cg.make_cg_nlml: -precision",
        "gp.exact_cg.make_cg_nlml: -col_panel",
        "gp.exact_cg.make_cg_step_chunked: +row_panel",
        "gp.exact_stochastic.make_hutchinson_nlml: -probes",
        "gp.exact_stochastic.make_hutchinson_nlml: -col_panel",
        "gp.exact_stochastic.make_hutchinson_nlml: -chol_precision",
        "gp.exact_stochastic.make_hutchinson_training_loss: -probes",
        "gp.exact_stochastic.make_hutchinson_training_loss: -col_panel",
        "gp.exact_lean.make_lean_nlml: -chol_precision",
        "ops.block_cholesky.blocked_cho_solve: -precision",
        "ops.block_cholesky.blocked_cholesky: -precision",
        "ops.block_cholesky.blocked_solve_lower: -precision",
        "ops.block_cholesky.blocked_solve_upper: -precision",
        "ops.block_cholesky.super_cholesky: -precision", "ops.linalg.tri_inverse: -precision",
        "parallel.pcholesky.dist_cholesky_local: -precision",
        "parallel.pcholesky2d.dist_cholesky_2d_local: -precision"],
    "the GPRAS_EOF_HOST_ELEMENTS switch is dropped": [],
    "two_stage_fit skips its Z stage when there is no Z": [],
    "one host L-BFGS core, with a gtol stop": ["fit.optimizers.lbfgs_fit_hostls: +gtol"],
    "chunk only paces progress": [],
    "randomness is an input": [
        "+gp.exact_cg.precond_probes", "+gp.exact_cg.rr_depth",
        "+gp.exact_stochastic.rademacher_probes",
        "gp.exact_cg.slq_logdet_rr: -key", "gp.exact_cg.slq_logdet_rr: -probes",
        "gp.exact_cg.slq_logdet_rr: -n_tail", "gp.exact_cg.slq_logdet_rr: +draws",
        "gp.exact_cg.slq_logdet_rr: +j_trunc",
        "fit.optimizers.multi_start_fit: +starts", "ops.kmeans.kmeans: +init",
        "parallel.pfit.sharded_multi_start: +starts"],
    "SVGP's optimizer argument is not ported; the data-parallel trainers take natgrad": [
        "gp.svgp.make_minibatch_fit: -optimizer", "gp.svgp.make_stream_fit: -optimizer",
        "parallel.psvgp.make_dp_minibatch_step: -optimizer",
        "parallel.psvgp.make_dp_minibatch_step: +natgrad",
        "parallel.psvgp.dp_minibatch_fit: +natgrad"],
    "devices: every entry point takes device": [f"{n}: +device" for n in DEVICE_ARG],
    "EventSelection's diversity PCA runs in float64": [],
    "h5py and matplotlib are imported at first use": [],
    "on the card the SST.dss files are stand-ins": [],
    "the mesh is a DeviceMesh; mesh='auto' needs an initialized process group": [],
    "the distributed per-rank bodies take the mesh (torch has no ambient shard_map axis)": [
        f"parallel.{m}.{f}: +mesh" for m, fs in (
            ("pcholesky", ("dist_cholesky_local", "dist_solve_lower_local",
                           "dist_solve_upper_local")),
            ("pcholesky2d", ("dist_cholesky_2d_local", "dist_solve_lower_2d_local",
                             "dist_solve_upper_2d_local"))) for f in fs],
    "the distributed factorization and solves run without autograd, on the trailing block": [],
    "the port's spans and counters": [f"+utils.profiling.{n}" for n in (
        "clear", "count", "current", "records", "span", "totals", "tracing")],
}


def _surface(package: str) -> dict:
    """{module.name or module.Class.method: function} of the package's public
    functions and methods (jitted and custom-VJP functions unwrapped)."""
    root = importlib.import_module(package)
    out = {}
    for info in pkgutil.walk_packages(root.__path__, package + "."):
        name = info.name
        rel = name[len(package) + 1:]
        if name.endswith("__main__") or any(p.startswith("_") for p in rel.split(".")):
            continue
        try:
            mod = importlib.import_module(name)
        except ImportError:  # a compiled library, not a Python module
            continue
        for attr, obj in vars(mod).items():
            if attr.startswith("_"):
                continue
            if not inspect.isclass(obj) and not inspect.isfunction(obj) and callable(obj):
                inner = getattr(obj, "__wrapped__", None) or getattr(obj, "fun", None)
                if getattr(obj, "__module__", None) == name and inspect.isfunction(inner):
                    obj = inner
            if inspect.isfunction(obj) and obj.__module__ == name:
                out[f"{rel}.{attr}"] = obj
            elif inspect.isclass(obj) and obj.__module__ == name:
                for meth, fn in vars(obj).items():
                    if meth.startswith("_") and meth != "__init__":
                        continue
                    fn = fn.__func__ if isinstance(fn, (classmethod, staticmethod)) else fn
                    if inspect.isfunction(fn):
                        out[f"{rel}.{attr}.{meth}"] = fn
    return out


def _diff() -> set[str]:
    ref, port = _surface("gpras_tpu"), _surface("gpras_tpu_torch")
    found = {f"-{n}" for n in set(ref) - set(port)} | {f"+{n}" for n in set(port) - set(ref)}
    for name in set(ref) & set(port):
        a = inspect.signature(ref[name]).parameters
        b = inspect.signature(port[name]).parameters
        found |= {f"{name}: -{p}" for p in a if p not in b}
        found |= {f"{name}: +{p}" for p in b if p not in a}
        for p in set(a) & set(b):
            if a[p].kind != b[p].kind:
                found.add(f"{name}: kind of {p}")
            literal = (int, float, str, bool, type(None))
            da, db = a[p].default, b[p].default
            if isinstance(da, literal) and isinstance(db, literal) and da != db:
                found.add(f"{name}: default of {p}")
        common = [p for p in a if p in b]
        if common != [p for p in b if p in a]:
            found.add(f"{name}: order")
    return found


def test_signatures_differ_only_by_recorded_deviations():
    recorded = [d for diffs in DEVIATIONS.values() for d in diffs]
    assert len(recorded) == len(set(recorded)), "a difference is recorded twice"
    found = _diff()
    assert sorted(found - set(recorded)) == [], "differences no recorded deviation covers"
    assert sorted(set(recorded) - found) == [], "recorded differences that are gone"


# ------------------------------------------------------------------- C4


def test_certify_transfer_takes_min_cap():
    """tests/test_warmstart.py:82's call: never finite, so the cap halves down
    to min_cap and the clamp at the last cap is returned, infeasible."""
    from gpras_tpu.gp import warmstart as ref
    from gpras_tpu_torch.gp import warmstart as port

    for min_cap in (2.0, 8.0):
        p = {"log_variance": math.log(1e6), "log_noise_variance": 0.0}
        want, want_info = ref.certify_transfer(
            lambda q: float("nan"), {k: jnp.asarray(v) for k, v in p.items()},
            ratio_cap=50.0, min_cap=min_cap)
        got, got_info = port.certify_transfer(
            lambda q: float("nan"), {k: t64(v) for k, v in p.items()}, ratio_cap=50.0,
            min_cap=min_cap)
        assert got_info["feasible"] is False and want_info["feasible"] is False
        assert got_info["ratio_cap_used"] == want_info["ratio_cap_used"]
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-12)


def test_certify_transfer_batched_takes_min_cap():
    """Mode 0 certifies at cap 12.5; mode 1 never does above min_cap = 8 and
    falls back, in both packages."""
    from gpras_tpu.gp import warmstart as ref
    from gpras_tpu_torch.gp import warmstart as port

    p = {"log_variance": [math.log(1e6)] * 2, "log_noise_variance": [0.0, 0.0]}
    fallback = {"log_variance": [0.0, 0.0], "log_noise_variance": [-1.0, -1.0]}

    def loss(q, i):
        r = math.exp(float(q["log_variance"]) - float(q["log_noise_variance"]))
        return r if (i == 0 and r < 13.0) else float("nan")

    want, want_info = ref.certify_transfer_batched(
        loss, {k: jnp.asarray(v) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in fallback.items()}, ratio_cap=50.0, min_cap=8.0)
    got, got_info = port.certify_transfer_batched(
        loss, {k: t64(v) for k, v in p.items()}, {k: t64(v) for k, v in fallback.items()},
        ratio_cap=50.0, min_cap=8.0)
    assert got_info["fell_back_modes"] == want_info["fell_back_modes"] == [1]
    assert got_info["ratio_caps"] == want_info["ratio_caps"]
    np.testing.assert_allclose(got_info["cert_losses"][0], want_info["cert_losses"][0],
                               rtol=1e-12)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-12)


@pytest.mark.parametrize("names", [("log_variance",), ("log_lengthscales", "log_noise_variance"),
                                   ()])
def test_log_prior_takes_names(names):
    from gpras_tpu.gp.priors import log_prior as ref
    from gpras_tpu_torch.gp.priors import log_prior as port

    rng = np.random.default_rng(3)
    p = {"log_variance": rng.normal(), "log_lengthscales": rng.normal(size=4),
         "log_noise_variance": rng.normal()}
    want = float(ref({k: jnp.asarray(v) for k, v in p.items()}, names=names))
    got = float(port({k: t64(v) for k, v in p.items()}, names=names))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


def test_fit_package_reexports_the_references_names():
    import gpras_tpu.fit as ref
    import gpras_tpu_torch.fit as port
    from gpras_tpu_torch.fit import FITTERS, optimizers

    names = ("FITTERS", "adam_fit", "adadelta_fit", "de_fit", "fit", "lbfgs_fit",
             "multi_start_fit", "three_stage_fit", "two_stage_fit")
    for name in names:
        assert getattr(port, name) is getattr(optimizers, name)
        assert hasattr(ref, name)
    public = lambda m: {n for n in vars(m) if not n.startswith("_")} - {"optimizers"}
    assert public(port) == public(ref) == set(names)
    assert sorted(FITTERS) == sorted(ref.FITTERS)


def test_model_literal_aliases():
    from gpras_tpu.gp import model as ref
    from gpras_tpu_torch.gp import model as port

    for alias in ("OptimizerType", "InductionInitializerType", "ModelBackendType"):
        assert typing.get_args(getattr(port, alias)) == typing.get_args(getattr(ref, alias))
    assert set(typing.get_args(port.OptimizerType)) == set(port.fitters.FITTERS)
    assert typing.get_args(port.InductionInitializerType) == ("kmeans", "grid")
