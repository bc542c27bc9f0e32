"""The port's hybrid data x model step (gpras_tpu_torch/parallel/hybrid) over
a ("dp", "i", "j") = (2, 2, 2) mesh against the JAX package's.

Mirrors tests/test_hybrid.py: the JAX side on its 8 virtual devices here,
the port on 8 gloo ranks in float64 (tests/torch_dist.py). Each mode's
probes are the ones the reference folds from its key (drawn here with JAX
and handed to the port), so the per-mode losses and Hutchinson gradients
are held to the JAX package's at the reference test's tolerances, and the
fit steps' losses to its trajectory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist
from torch_dist_cases import HYB_B, HYB_N, HYB_P, HYB_PROBES, hybrid_data

from gpras_tpu.gp import exact
from gpras_tpu.parallel import make_mesh
from gpras_tpu.parallel.hybrid import make_hybrid_fit_step, make_hybrid_nlml_and_grads

KERNEL = "Matern52"


def _mesh():
    return make_mesh((2, 2, 2), ("dp", "i", "j"))


def _params_batched(x):
    ps = [exact.init_params(KERNEL, x, noise_variance=0.1, lengthscales=0.5 + 0.3 * i)
          for i in range(HYB_P)]
    return jax.tree.map(lambda *ls: jnp.stack(ls), *ps)


def _probes(key):
    return np.stack([np.asarray(jax.random.rademacher(jax.random.fold_in(key, mode),
                                                      (HYB_N, HYB_PROBES), dtype=jnp.float64))
                     for mode in range(HYB_P)])


def _step_probes(steps=10):
    key, out = jax.random.PRNGKey(0), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(_probes(sub))
    return np.stack(out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = {"hyb_z": _probes(jax.random.PRNGKey(7)), "hyb_step_z": _step_probes()}
    return torch_dist.Ranks("hybrid", inputs, tmp_path_factory.mktemp("hybrid"))


def test_hybrid_nlml_and_grads_match_dense(ranks):
    x, y = (jnp.asarray(a) for a in hybrid_data())
    params_b = _params_batched(x)
    fn = make_hybrid_nlml_and_grads(_mesh(), KERNEL, b=HYB_B, probes=HYB_PROBES)
    losses, grads = jax.jit(fn)(params_b, x, y, jax.random.PRNGKey(7))
    assert losses.shape == (HYB_P,)
    seen = set()
    for r in ranks.case("nlml_and_grads"):
        for slot, mode in enumerate(r["modes"]):
            seen.add(mode)
            np.testing.assert_allclose(r["losses"][slot], np.asarray(losses[mode]), rtol=1e-8)
            for name in grads:
                np.testing.assert_allclose(r["grads"][name][slot], np.asarray(grads[name][mode]),
                                           rtol=1e-6, atol=1e-9,
                                           err_msg=f"mode {mode} grad {name}")
    assert seen == set(range(HYB_P))


def test_hybrid_fit_step_makes_progress(ranks):
    x, y = (jnp.asarray(a) for a in hybrid_data(seed=1))
    params_b = _params_batched(x)
    init, step = make_hybrid_fit_step(_mesh(), KERNEL, b=HYB_B, probes=HYB_PROBES,
                                      learning_rate=0.05)
    opt_state, key, history = init(params_b), jax.random.PRNGKey(0), []
    for _ in range(10):
        params_b, opt_state, losses, key = step(params_b, opt_state, x, y, key)
        history.append(np.asarray(losses))
    history = np.stack(history)
    for r in ranks.case("fit_step"):
        got = r["losses"]  # (steps, local modes)
        assert np.all(np.isfinite(got))
        assert got[-1].sum() < got[0].sum(), got
        np.testing.assert_allclose(got, history[:, r["modes"]], rtol=1e-6)


def test_hybrid_shape_validation(ranks):
    mesh = _mesh()
    fn = make_hybrid_nlml_and_grads(mesh, KERNEL, b=HYB_B, probes=4)
    x, y = (jnp.asarray(a) for a in hybrid_data())
    params_b = _params_batched(x)
    with pytest.raises(ValueError, match="modes must divide"):
        fn(params_b, x, y[:, :3], jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="needs mesh axis"):
        make_hybrid_nlml_and_grads(make_mesh((8,), ("i",)), KERNEL, b=HYB_B)(
            params_b, x, y, jax.random.PRNGKey(0))
    for r in ranks.case("shapes"):
        modes_err, axis_err = r["errors"]
        assert "modes must divide" in modes_err
        assert "needs mesh axis" in axis_err
