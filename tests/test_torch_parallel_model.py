"""``GPRAS.fit(x, y, mesh=...)`` in the port against the JAX package's.

Mirrors tests/test_model.py:247-303. The port runs on 8 gloo ranks in
float64 (tests/torch_dist.py, every rank the same call on the whole x and
y); the JAX side fits here, on one device and on its 8 virtual devices.
``mesh="auto"`` builds the (4, 2) mesh and takes the dense engine; the CG
engine flattens it to 8 ranks on one axis; a sparse backend refuses a mesh;
and without a process group ``"auto"`` says how to start one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist

from gpras_tpu.gp.model import GPRAS


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model")
    return torch_dist.Ranks("model", {"ckpt": str(tmp / "dist.npz")}, tmp), tmp


def test_fit_exact_distributed_mesh_matches_single_chip(ranks):
    ranks, tmp = ranks
    rng = np.random.default_rng(7)
    n = 256
    x = rng.normal(size=(n, 3))
    base = np.sin(1.5 * x[:, 0]) + 0.4 * x[:, 1]
    y = np.stack([base, base * 0.5 + 0.1], axis=1)
    y += 0.05 * rng.normal(size=y.shape)
    kw = dict(optimization_method="adam", max_iter=60, learning_rate=0.05)
    single = GPRAS("RBF", model_type="exact", dtype=jnp.float64)
    single.fit(x, y, **kw)
    dist = GPRAS("RBF", model_type="exact", dtype=jnp.float64)
    dist.fit(x, y, mesh="auto", **kw)
    l_s = np.asarray(single.fit_info["loss"]).ravel()
    l_d = np.asarray(dist.fit_info["loss"]).ravel()
    m_s, _ = single.predict(x[:16])
    m_d, _ = dist.predict(x[:16])
    per_rank = ranks.case("dense")
    for r in per_rank:
        assert r["engine"] == "dense"
        assert tuple(r["mesh"]) == (4, 2)
        np.testing.assert_allclose(r["loss"].ravel(), l_s, rtol=1e-5)
        np.testing.assert_allclose(r["loss"].ravel(), l_d, rtol=1e-5)
        np.testing.assert_allclose(r["mean"], m_s, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(r["mean"], m_d, rtol=1e-4, atol=1e-6)
        for k, v in per_rank[0]["params"].items():  # the same on every rank
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)
    # the port's checkpoint loads in the JAX package and serves the same mean
    back = GPRAS.from_file(tmp / "dist.npz")
    m_b, _ = back.predict(x[:16])
    np.testing.assert_allclose(m_b, per_rank[0]["mean"], rtol=1e-6)


def test_fit_exact_distributed_cg_engine(ranks):
    """exact_engine="cg" with mesh="auto" flattens the (4, 2) mesh to the
    8-rank row-sharded matrix-free engine and fits."""
    for r in ranks[0].case("cg"):
        assert r["engine"] == "cg"
        assert tuple(r["mesh"]) == (8,)
        assert np.all(np.isfinite(r["losses"]))
        assert np.all(np.isfinite(r["mean"])) and np.all(r["var"] >= 0)


def test_fit_mesh_rejects_sparse_backend():
    from gpras_tpu_torch.gp.model import GPRAS as TorchGPRAS

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 2))
    y = np.stack([np.sin(x[:, 0]), np.cos(x[:, 1])], axis=1)
    m = TorchGPRAS("RBF", dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="mesh-distributed"):
        m.fit(x, y, n_inducing=8, mesh="auto")


def test_fit_mesh_auto_needs_a_process_group():
    """Where JAX sees its devices, torch needs a process group: without one,
    mesh="auto" says how to start it (torchrun or init_process_group)."""
    from gpras_tpu_torch.gp.model import GPRAS as TorchGPRAS

    assert not torch.distributed.is_initialized()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 2))
    m = TorchGPRAS("RBF", model_type="exact", dtype=torch.float64, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        m.fit(x, np.sin(x[:, 0]), mesh="auto", optimization_method="adam", max_iter=2)
