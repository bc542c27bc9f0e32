"""The exact-GP serving slice end to end: artifacts written by the JAX package
(gpras_tpu) served by the port's PosteriorPredictor (gpras_tpu_torch), LF cell
field in, HF field and variance out, compared in float64 with the JAX
predictor on the same fields; and the checkpoint format in both directions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpras_tpu.eof.preprocessor import PreProcessor as JPre
from gpras_tpu.gp.model import GPRAS as JGPRAS
from gpras_tpu.gp.serving import PosteriorPredictor as JPredictor
from gpras_tpu_torch.eof.preprocessor import PreProcessor as TPre
from gpras_tpu_torch.gp.model import GPRAS as TGPRAS
from gpras_tpu_torch.gp.serving import PosteriorPredictor as TPredictor
from gpras_tpu_torch.utils.convert import params_from_numpy, params_to_numpy
from torch_parity import np_params

N_EVENTS, N_CELLS, D, P = 512, 80, 8, 3


def _fields(seed=0, n_events=N_EVENTS):
    """Synthetic WSE fields: smooth spatial patterns driven by per-event
    storm amplitudes over a sloped bed; a band of high cells stays dry."""
    rng = np.random.default_rng(seed)
    c = np.linspace(0.0, 1.0, N_CELLS)
    elev = 10.0 * c
    elev[60:66] = 40.0  # always dry
    amps = rng.normal(size=(n_events, 12))
    lf_patterns = np.stack([np.sin((k + 1) * np.pi * c) for k in range(12)])
    hf_patterns = lf_patterns + 0.2 * np.stack([np.cos((k + 2) * np.pi * c) for k in range(12)])
    scale = 1.0 / (1.0 + np.arange(12))
    lf = elev + 5.0 + (amps * scale) @ lf_patterns
    hf = elev + 5.0 + np.tanh(amps * scale) @ hf_patterns
    return lf, hf, elev


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """JAX-written LF/HF preprocessors and two GPRAS checkpoints (the
    matrix-free "cg" engine and the dense "auto" one) with per-mode
    hyperparameters set from numpy — no fit is needed to serve."""
    out = tmp_path_factory.mktemp("slice")
    lf, hf, elev = _fields()
    lf_pre = JPre(hydraulic_parameter="wse")
    lf_pre.fit(lf, elev, spatial_mode_count=D)
    hf_pre = JPre(hydraulic_parameter="wse")
    hf_pre.fit(hf, elev, spatial_mode_count=P)
    lf_pre.to_file(out / "lf.npz")
    hf_pre.to_file(out / "hf.npz")
    x, y = lf_pre.transform(lf), hf_pre.transform(hf)
    rng = np.random.default_rng(1)
    params = {"log_variance": np.log(rng.uniform(0.8, 1.5, P)),
              "log_lengthscales": np.log(rng.uniform(1.0, 3.0, (P, D))),
              "log_noise_variance": np.log(rng.uniform(0.01, 0.05, P))}
    for engine in ("cg", "auto"):
        model = JGPRAS("Matern52", model_type="exact", exact_engine=engine,
                       dtype=jnp.float64)
        model.x, model.y = jnp.asarray(x), jnp.asarray(y)
        model.params = {k: jnp.asarray(v) for k, v in params.items()}
        model.to_file(out / f"gp_{engine}.npz")
    return out, params


def _requests():
    lf, _, _ = _fields(seed=9, n_events=11)
    return lf


@pytest.mark.parametrize("engine", ["cg", "auto"])
def test_port_predict_field_matches_jax(artifacts, engine):
    out, _ = artifacts
    paths = dict(model_path=out / f"gp_{engine}.npz", hf_preprocessor_path=out / "hf.npz",
                 lf_preprocessor_path=out / "lf.npz", buckets=(16, 64))
    jp = JPredictor(**paths)
    tp = TPredictor(**paths, device="cpu")
    assert tp.model._matrix_free == (engine == "cg")
    lf = _requests()
    want_f, want_v = jp.predict_field(lf)
    got_f, got_v = tp.predict_field(lf)
    assert got_f.shape == got_v.shape == (11, N_CELLS)
    # float64 on both sides. The dense branch runs the same factorization
    # and solves: 1e-10 covers another BLAS order. The cg branch solves each
    # column only to CG's 1e-6 relative residual; the last pivots of the
    # rank-64 preconditioner sit on a residual diagonal exhausted to rounding
    # level, and late CG iterations amplify rounding differences, so the two
    # sides agree to the solver's accuracy (measured ~2e-8 of the field's
    # scale), not to float64's: 1e-6 relative.
    rtol = 1e-6 if engine == "cg" else 1e-10
    np.testing.assert_allclose(got_f, want_f, rtol=rtol, atol=rtol * np.abs(want_f).max())
    np.testing.assert_allclose(got_v, want_v, rtol=rtol, atol=rtol * np.abs(want_v).max())
    # the host reverse transform decodes to the same field
    host_f, host_v = tp.predict_field(lf, device_decode=False)
    np.testing.assert_allclose(host_f, got_f, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(host_v, got_v, rtol=1e-12, atol=1e-15)


def test_port_checkpoint_loads_in_jax(artifacts, tmp_path):
    """Cross-load: a checkpoint written by the port predicts the same in JAX."""
    out, _ = artifacts
    port = TGPRAS.from_file(out / "gp_auto.npz", device="cpu")
    port.to_file(tmp_path / "from_port.npz")
    back = JGPRAS.from_file(tmp_path / "from_port.npz")
    xq = np.random.default_rng(3).normal(size=(7, D))
    jm, jv = back.predict(xq)
    tm, tv = port.predict(xq)
    np.testing.assert_allclose(tm, jm, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tv, jv, rtol=1e-10, atol=1e-12)
    assert back.kernel_str == port.kernel_str and back.exact_engine == port.exact_engine
    for got, want in zip(port.models, back.models):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-15)


@pytest.mark.parametrize("request_kind", ["1_field", "64_fields", "nan_in_dry_cell",
                                          "float32_field"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("parameter", ["wse", "depth"])
def test_port_preprocessor_matches_jax(tmp_path, parameter, weighted, request_kind):
    """The port's PreProcessor fitted on the same field gives the JAX basis,
    and its transforms agree both ways: the port's fit against the JAX
    fit, and the JAX artifact loaded by the port to float64 round-off."""
    lf, _, elev = _fields()
    lf[:, 60:66] = elev[60:66] - 1.0  # below ground in every event: always dry
    lf[::2, 20:24] = elev[20:24] - 0.5  # below ground in half: a depth clamped to 0
    weights = np.random.default_rng(5).uniform(0.5, 2.0, N_CELLS) if weighted else None
    ref = JPre(hydraulic_parameter=parameter)
    ref.fit(lf, elev, weights=weights, spatial_mode_count=D)
    ref.to_file(tmp_path / "lf.npz")
    mine = TPre(hydraulic_parameter=parameter, device="cpu")
    mine.fit(lf, elev, weights=weights, spatial_mode_count=D)
    np.testing.assert_allclose(mine.eofs, ref.eofs, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(mine.eigenvalues, ref.eigenvalues, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(mine.wetness_classes, ref.wetness_classes)
    loaded = TPre.from_file(tmp_path / "lf.npz", device="cpu")
    req = _fields(seed=9, n_events=64)[0]
    req[:, 60:66] = elev[60:66] - 1.0
    req[::2, 20:24] = elev[20:24] - 0.5
    if request_kind == "1_field":
        req = req[:1]
    elif request_kind == "nan_in_dry_cell":
        assert ref.wetness_classes[62] == "AD"
        req[::3, 62] = np.nan
    elif request_kind == "float32_field":
        req = req.astype(np.float32)  # against the float64 basis: numpy's promotion
    want = ref.transform(req)
    assert np.isfinite(want).all()
    for got, tol in ((mine.transform(req), 1e-9), (loaded.transform(req), 1e-12)):
        assert got.shape == want.shape and got.dtype == want.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    modes = ref.transform(req)
    var = np.abs(modes) * 0.1
    f_j, v_j = ref.reverse_transform(modes, var)
    f_t, v_t = loaded.reverse_transform(modes, var)
    np.testing.assert_allclose(f_t, f_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-12, atol=1e-15)


def test_params_from_numpy_round_trip(artifacts):
    _, params = artifacts
    params = dict(params, degree=np.asarray(3.0, np.float32))
    t = params_from_numpy(params, device="cpu", dtype=torch.float32)
    assert t["log_variance"].dtype == torch.float32
    assert t["degree"].dtype == torch.float32  # non-float params keep their dtype
    t64 = params_from_numpy(params, dtype=torch.float64)
    back = params_to_numpy(t64)
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v)
    # and the JAX package's dict carries across unchanged
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for k, v in params_to_numpy(params_from_numpy(np_params(jp))).items():
        np.testing.assert_array_equal(v, params[k])


def test_port_refuses_what_it_does_not_serve(artifacts):
    out, _ = artifacts
    model = TGPRAS.from_file(out / "gp_cg.npz", device="cpu")
    # its engine, "cg", now trains (tests/test_torch_cg_train.py); a
    # mesh-distributed fit runs over a process group
    # (tests/test_torch_parallel_model.py) and, without one, says how to start it
    with pytest.raises(RuntimeError, match="torchrun"):
        model.fit(np.zeros((4, D)), np.zeros((4, P)), mesh="auto")
    # sgpr and svgp are ported (tests/test_torch_sgpr.py, tests/test_torch_svgp.py);
    # a sparse backend refuses a mesh as the reference does
    with pytest.raises(ValueError, match="mesh-distributed"):
        TGPRAS("RBF", model_type="svgp", device="cpu").fit(
            np.zeros((4, D)), np.zeros((4, P)), n_inducing=2, optimization_method="adam",
            mesh="auto")


@pytest.mark.parametrize("active, noise", [((1.0, 0.6, 0.35), 0.01), ((3.5, 3.0, 3.0), 0.1)],
                         ids=["generating_scales", "smoke_scales"])
def test_cg_serving_error_is_the_references(active, noise):
    """The matrix-free serving solver (64 PCG iterations, rank-64 pivoted-
    Cholesky preconditioner) in both packages, float64, against the dense
    exact posterior, on chip_smoke.py's mode-0 data recipe at N = 1,024.

    At the data's generating scales the solver stops short of the dense
    posterior, in the JAX package as much as in the port: the shortfall is
    the reference algorithm's, and it grows with N (PERF.md). At the scales
    chip_smoke.py serves, both converge and agree to rounding."""
    from gpras_tpu_torch.gp.exact import predict as dense_predict
    from torch_parity import t64

    n = 1024
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, D))
    y = (np.sin(x[:, 0]) + 0.5 * np.sin(2.0 * x[:, 1]) + 0.4 * np.sin(4.0 * x[:, 2])
         + 0.1 * rng.normal(size=n))[:, None]
    xq = np.random.default_rng(99).normal(size=(17, D))
    params = {"log_variance": np.zeros(1),
              "log_lengthscales": np.log([list(active) + [10.0] * (D - 3)]),
              "log_noise_variance": np.log([noise])}
    jax_model = JGPRAS("Matern52", model_type="exact", exact_engine="cg", dtype=jnp.float64)
    jax_model.x, jax_model.y = jnp.asarray(x), jnp.asarray(y)
    jax_model.params = {k: jnp.asarray(v) for k, v in params.items()}
    port = TGPRAS("Matern52", model_type="exact", exact_engine="cg", dtype=torch.float64,
                  device="cpu")
    port.x, port.y = t64(x), t64(y)
    port.params = params_from_numpy(params, dtype=torch.float64)
    (jm, jv), (tm, tv) = jax_model.predict(xq), port.predict(xq)
    dm, dv = (a.numpy() for a in dense_predict(
        "Matern52", {k: t64(v[0]) for k, v in params.items()}, t64(x), t64(y[:, 0]), t64(xq)))
    scale = np.abs(dm).max()
    miss = {name: (np.abs(m[:, 0] - dm).max() / scale, (np.abs(v[:, 0] - dv) / dv).max())
            for name, (m, v) in (("jax", (jm, jv)), ("port", (tm, tv)))}
    if noise == 0.1:
        # converged: the CG tolerance (1e-6 relative residual) bounds the
        # miss (measured 3.7e-7 of the mean's scale, 3.2e-9 of the variance),
        # and the two packages run the same arithmetic (measured 7e-14)
        for mean_miss, var_miss in miss.values():
            assert mean_miss <= 1e-5 and var_miss <= 1e-5, miss
        np.testing.assert_allclose(tm, jm, rtol=1e-9, atol=1e-9 * scale)
        np.testing.assert_allclose(tv, jv, rtol=1e-9)
    else:
        # not converged: both miss by far more than the CG tolerance allows
        # (measured mean 7.4e-3 JAX / 4.5e-3 port, variance 2.8e-3 each); the
        # iterates left at the budget depend on rounding, so the two misses
        # are held to the same size (within 3x), not to the same digits
        for mean_miss, var_miss in miss.values():
            assert mean_miss > 1e-3 and var_miss > 1e-3, miss
        for k in (0, 1):
            ratio = miss["port"][k] / miss["jax"][k]
            assert 1 / 3 <= ratio <= 3, miss
