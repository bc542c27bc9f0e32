"""The port's data-parallel SVGP step and fit (gpras_tpu_torch/parallel/psvgp)
against the JAX package's and against the port's one-process step.

Mirrors tests/test_psvgp.py at its float32 tolerances: the JAX side on its
8 virtual devices ("dp") here, the port on 8 gloo ranks (tests/torch_dist.py)
from the JAX package's initial parameters. The port's step with natural
gradients (``natgrad``, as gp/svgp's trainers take it) is held to the
one-process step of gp/svgp on the whole batch."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_dist
from torch_dist_cases import svgp_data

from gpras_tpu.gp import svgp
from gpras_tpu.parallel import make_mesh
from gpras_tpu.parallel.psvgp import dp_minibatch_fit, make_dp_minibatch_step, shard_batch

#: the epoch losses of 20 epochs of 4 float32 Adam steps, port against JAX
FIT_RTOL = 1e-3


def _init(n, m, seed, noise):
    x, y, z = (jnp.asarray(a) for a in svgp_data(n=n, m=m, seed=seed))
    return x, y, svgp.init_params("RBF", x, z, noise_variance=noise)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = {"svgp_params": {k: np.asarray(v) for k, v in _init(128, 8, 0, 0.3)[2].items()},
              "svgp_fit_params": {k: np.asarray(v)
                                  for k, v in _init(256, 8, 1, 0.5)[2].items()}}
    return torch_dist.Ranks("psvgp", inputs, tmp_path_factory.mktemp("psvgp"))


def test_dp_step_matches_single_device(ranks):
    mesh = make_mesh((8,), ("dp",))
    x, y, params = _init(128, 8, 0, 0.3)
    init, step = make_dp_minibatch_step(mesh, "RBF", n_total=x.shape[0], learning_rate=0.01)
    xb, yb = shard_batch(mesh, x, y)
    p_dp, _, loss_dp = step(params, init(params), xb, yb)
    # the single-device reference step
    opt = optax.adam(0.01)
    loss_ref, g = jax.value_and_grad(
        lambda p: svgp.training_loss("RBF", p, x, y, x.shape[0]))(params)
    updates, _ = opt.update(g, opt.init(params), params)
    p_ref = optax.apply_updates(params, updates)
    np.testing.assert_allclose(float(loss_dp), float(loss_ref), rtol=1e-5)
    for r in ranks.case("step"):
        for tag in ("adam", "natgrad"):
            got = r[tag]
            np.testing.assert_allclose(got["loss"], got["loss_one"], rtol=1e-5, err_msg=tag)
            for name, v in got["params_one"].items():
                np.testing.assert_allclose(got["params"][name], v, rtol=2e-4, atol=2e-6,
                                           err_msg=f"{tag}:{name}")
        got = r["adam"]
        np.testing.assert_allclose(got["loss"], float(loss_dp), rtol=1e-5)
        for name in p_ref:
            np.testing.assert_allclose(got["params"][name], np.asarray(p_dp[name]), rtol=2e-4,
                                       atol=2e-6, err_msg=name)


def test_dp_fit_improves_bound(ranks):
    mesh = make_mesh((8,), ("dp",))
    x, y, params = _init(256, 8, 1, 0.5)
    _, hist_jax = dp_minibatch_fit(mesh, "RBF", params, np.asarray(x), np.asarray(y),
                                   batch_size=64, epochs=20, learning_rate=0.02)
    for r in ranks.case("fit"):
        hist = r["hist"]
        assert hist.shape == (20,)
        assert hist[-1] < hist[0]
        assert r["elbo1"] > r["elbo0"]
        np.testing.assert_allclose(hist, hist_jax, rtol=FIT_RTOL)
