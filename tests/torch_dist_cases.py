"""The port's side of the distributed parity tests, run on every gloo rank.

Imported by the processes that ``tests/torch_dist.py`` starts, so it imports
no JAX. Each case builds its inputs as the JAX package's tests do (numpy from
a seed; the probes and restarts the JAX side draws come in ``inputs``), runs
the port's distributed functions as one SPMD program, and returns this
rank's results as numpy arrays. ``GROUPS`` maps a test file's group to its
cases, in the order they run.
"""

from __future__ import annotations

import numpy as np
import torch

from gpras_tpu_torch.gp import exact, sgpr, svgp
from gpras_tpu_torch.ops import kernels as K
from gpras_tpu_torch.parallel import make_mesh

N, D, B = 64, 3, 8


def make_spd(n=N, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


def make_xy(n=N, seed=1, d=D):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    return x, y


def t64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def npd(params) -> dict:
    return {k: v.detach().numpy().copy() for k, v in params.items()}


def value_and_grad(fn, params):
    from gpras_tpu_torch.fit.optimizers import value_and_grad as vg

    loss, grads = vg(fn, params)
    return float(loss), npd(grads)


def coords(mesh) -> tuple:
    return tuple(mesh.get_coordinate())


def strip(a, mesh, axis="i"):
    """This rank's rows of a (n, ...) array over ``axis``."""
    d = mesh.size(mesh.mesh_dim_names.index(axis))
    r = a.shape[0] // d
    i = mesh.get_local_rank(axis)
    return a[i * r:(i + 1) * r]


def tile(a, mesh):
    """This rank's (i, j) tile of a square array."""
    di, dj = mesh.shape
    nr, nc = a.shape[0] // di, a.shape[1] // dj
    i, j = mesh.get_local_rank("i"), mesh.get_local_rank("j")
    return a[i * nr:(i + 1) * nr, j * nc:(j + 1) * nc]


# ------------------------------------------------------------------ parallel


def mesh_has_8_devices(inputs):
    mesh = make_mesh()
    return {"size": mesh.size(), "shape": tuple(mesh.shape), "coords": coords(mesh)}


def pgram_rows_case(inputs):
    from gpras_tpu_torch.parallel.pgram import pgram_rows

    mesh = make_mesh()
    x, _ = make_xy()
    params = K.init_params("Matern52", D, variance=1.3, lengthscales=0.8, dtype=torch.float64)
    return {"strip": pgram_rows(mesh, "Matern52", params, t64(x), noise=0.25).numpy()}


def pgram_2d_case(inputs):
    from gpras_tpu_torch.parallel.pgram import pgram_2d

    mesh = make_mesh((4, 2), ("i", "j"))
    x, _ = make_xy()
    params = K.init_params("RBF", D, dtype=torch.float64)
    rng = np.random.default_rng(5)
    x5 = rng.normal(size=(N, D))
    return {"tile": pgram_2d(mesh, "RBF", params, t64(x)).numpy(),
            "tile_noise": pgram_2d(mesh, "RBF", params, t64(x5), noise=0.37).numpy(),
            "coords": coords(mesh)}


def dist_cholesky_case(inputs):
    from gpras_tpu_torch.parallel.pcholesky import dist_cholesky

    mesh = make_mesh()
    k = make_spd()
    out = {"l": dist_cholesky(mesh, t64(strip(k, mesh)), b=B).numpy()}
    mesh4 = make_mesh((4,), ("i",))  # ranks 4-7 are outside this mesh
    if mesh4.get_coordinate() is not None:
        out["l_b16"] = dist_cholesky(mesh4, t64(strip(k, mesh4)), b=16).numpy()
    return out


def dist_solve_case(inputs):
    from gpras_tpu_torch.parallel.pcholesky import (dist_cho_solve, dist_cholesky,
                                                    dist_logdet_from_chol)

    mesh = make_mesh()
    k = make_spd(seed=2)
    rhs = np.random.default_rng(3).normal(size=(N, 4))
    l = dist_cholesky(mesh, t64(strip(k, mesh)), b=B)
    l4 = dist_cholesky(mesh, t64(strip(make_spd(seed=4), mesh)), b=B)
    return {"x": dist_cho_solve(mesh, l, t64(rhs), b=B).numpy(),
            "x1": dist_cho_solve(mesh, l, t64(rhs[:, 0]), b=B).numpy(),
            "logdet": float(dist_logdet_from_chol(mesh, l4))}


def dist_nlml_case(inputs):
    from gpras_tpu_torch.parallel.pexact import make_dist_fit_step, make_dist_nlml

    mesh = make_mesh()
    x, y = make_xy()
    params = exact.init_params("RBF", t64(x), noise_variance=0.2)
    value = float(make_dist_nlml(mesh, "RBF", b=B)(params, t64(x), t64(y)))
    x5, y5 = make_xy(seed=5)
    p5 = exact.init_params("Matern32", t64(x5), noise_variance=0.3)
    nlml = make_dist_nlml(mesh, "Matern32", b=B, col_batch=16)
    v5, g5 = value_and_grad(lambda p: nlml(p, t64(x5), t64(y5)), p5)
    x6, y6 = make_xy(seed=6)
    p6 = exact.init_params("RBF", t64(x6), noise_variance=0.5)
    init, step = make_dist_fit_step(mesh, "RBF", b=B, learning_rate=0.05)
    state, losses = init(p6), []
    for _ in range(5):
        p6, state, loss = step(p6, state, t64(x6), t64(y6))
        losses.append(float(loss))
    return {"value": value, "grad_value": v5, "grads": g5, "step_losses": losses,
            "step_params": npd(p6)}


def ppca_case(inputs):
    from gpras_tpu_torch.eof.pca import pca_fit
    from gpras_tpu_torch.parallel.ppca import ppca_fit, ppca_inverse, ppca_transform

    mesh = make_mesh()
    rng = np.random.default_rng(7)
    s, c, k = 24, 64, 5
    x = rng.normal(size=(s, c))
    x = x - x.mean(axis=0)
    xl = t64(strip(x.T, mesh).T)
    comps, expl = ppca_fit(mesh, xl, k)
    modes = ppca_transform(mesh, xl, comps)
    recon = ppca_inverse(mesh, modes, comps)
    comps1, expl1 = pca_fit(t64(x), k)
    return {"comps": comps.numpy(), "expl": expl.numpy(), "modes": modes.numpy(),
            "recon": recon.numpy(), "comps_one": comps1.numpy(), "expl_one": expl1.numpy()}


def multi_start_case(inputs):
    from gpras_tpu_torch.parallel.pfit import sharded_multi_start

    rng = np.random.default_rng(0)
    x = t64(rng.normal(size=(32, 2)))
    y = t64(np.sin(x.numpy()[:, 0]) + 0.05 * rng.normal(size=32))
    params = sgpr.init_params("RBF", x, x[:6], noise_variance=0.5)

    def loss_fn(p):
        return sgpr.training_loss("RBF", p, x, y)

    mesh = make_mesh()
    before = float(loss_fn(params))
    starts = {k: t64(v) for k, v in inputs["restarts"].items()}
    _, info = sharded_multi_start(mesh, loss_fn, params, x=x, n_starts=8, iter_initial=5,
                                  iter_final=20, starts=starts)
    return {"before": before, "loss": float(info["loss"]),
            "restart_losses": info["restart_losses"].numpy()}


def sharded_de_case(inputs):
    from gpras_tpu_torch.fit.optimizers import de_fit
    from gpras_tpu_torch.parallel.pfit import sharded_de

    x, y = make_xy(n=32, seed=9, d=2)
    params = exact.init_params("RBF", t64(x), noise_variance=0.5)

    def loss_fn(p):
        return exact.training_loss("RBF", p, t64(x), t64(y))

    mesh = make_mesh()
    p_d, info_d = sharded_de(mesh, loss_fn, params, popsize=4, max_iter=3)
    p_1, info_1 = de_fit(loss_fn, params, popsize=8, max_iter=3)
    return {"params": npd(p_d), "losses": info_d["losses"].numpy(),
            "params_one": npd(p_1), "losses_one": info_1["losses"].numpy()}


def dist_cg_case(inputs):
    from gpras_tpu_torch.parallel.pcg import make_dist_cg_nlml

    mesh = make_mesh((8,), ("i",))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 3))
    y = t64(np.sin(x[:, 0]) + 0.1 * rng.normal(size=128))
    params = exact.init_params("Matern52", t64(x), noise_variance=0.3)
    xl = t64(strip(x, mesh))
    nlml_d, _ = make_dist_cg_nlml(mesh, "Matern52", probes=8, max_iters=96, row_panel=8)
    plain = float(nlml_d(params, xl, y, t64(inputs["cg_z"])))
    nlml_pc, _ = make_dist_cg_nlml(mesh, "Matern52", probes=8, max_iters=32, row_panel=8,
                                   precond_rank=16)
    draws = (t64(inputs["cg_u1"]), t64(inputs["cg_u2"]))
    v_pc, g_pc = value_and_grad(lambda p: nlml_pc(p, xl, y, draws), params)
    return {"plain": plain, "pc": v_pc, "pc_grads": g_pc}


def dist_cg_small_noise_case(inputs):
    from gpras_tpu_torch.parallel.pcg import make_dist_cg_nlml

    mesh = make_mesh((8,), ("i",))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(128, 2))
    y = t64(np.sin(2.0 * x[:, 0]) + 0.03 * rng.normal(size=128))
    params = exact.init_params("RBF", t64(x), noise_variance=1e-3)
    xl = t64(strip(x, mesh))
    nlml_plain, _ = make_dist_cg_nlml(mesh, "RBF", probes=8, max_iters=16, row_panel=8)
    nlml_pc, _ = make_dist_cg_nlml(mesh, "RBF", probes=8, max_iters=16, row_panel=8,
                                   precond_rank=64)
    return {"plain": float(nlml_plain(params, xl, y, t64(inputs["sn_z"]))),
            "pc": float(nlml_pc(params, xl, y, (t64(inputs["sn_u1"]), t64(inputs["sn_u2"]))))}


def sharded_predict_case(inputs):
    from gpras_tpu_torch.gp.model import GPRAS
    from gpras_tpu_torch.parallel.ppredict import sharded_predict

    mesh = make_mesh((8,), ("i",))
    out = {}
    for backend, model_in in inputs["predict_models"].items():
        m = GPRAS("RBF", model_type=backend, dtype=torch.float64, device="cpu")
        m.x, m.y = t64(model_in["x"]), t64(model_in["y"])
        m.params = {k: t64(v) for k, v in model_in["params"].items()}
        mean, var = sharded_predict(mesh, m, model_in["xq"])
        mean1, var1 = m.predict(model_in["xq"])
        out[backend] = {"mean": mean, "var": var, "mean_one": mean1, "var_one": var1}
    return out


def _fit_step_2d(n, dtype, b):
    from gpras_tpu_torch.parallel.pexact import make_dist_fit_step, resolve_layout

    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, D))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    xt = torch.as_tensor(x.astype(dtype))
    yt = torch.as_tensor(y.astype(dtype))
    params = exact.init_params("Matern52", xt, noise_variance=0.1)
    mesh = make_mesh((4, 2), ("i", "j"))
    init, step = make_dist_fit_step(mesh, "Matern52", b=b, learning_rate=0.05)
    p1, _, loss = step(params, init(params), xt, yt)
    return {"layout": resolve_layout(mesh), "loss": float(loss), "p0": npd(params),
            "p1": npd(p1)}


def dist_fit_step_2d_case(inputs):
    return _fit_step_2d(2048, np.float64, 128)


def dist_fit_step_2d_f32_case(inputs):
    return _fit_step_2d(4096, np.float32, 256)


def dist_stochastic_case(inputs):
    from gpras_tpu_torch.parallel.pexact import make_dist_nlml, make_dist_nlml_stochastic

    x, y = make_xy(64)
    xt, yt = t64(x), t64(y)
    params = exact.init_params("Matern52", xt, noise_variance=0.3)
    z = t64(inputs["stoch_z"])
    out = {}
    for mesh, layout in ((make_mesh((8,), ("i",)), "1d"), (make_mesh((4, 2), ("i", "j")), "2d")):
        nlml_e = make_dist_nlml(mesh, "Matern52", b=8, col_batch=16, layout=layout)
        nlml_s = make_dist_nlml_stochastic(mesh, "Matern52", b=8, col_batch=16, layout=layout,
                                           probes=1024)
        ve, ge = value_and_grad(lambda p: nlml_e(p, xt, yt), params)
        vs, gs = value_and_grad(lambda p: nlml_s(p, xt, yt, z), params)
        out[layout] = {"value_exact": ve, "grads_exact": ge, "value_stoch": vs,
                       "grads_stoch": gs}
    return out


# -------------------------------------------------------------- pcholesky2d


def cholesky_2d_case(inputs):
    from gpras_tpu_torch.parallel.pcholesky2d import dist_cholesky_2d

    out = {}
    k = make_spd()
    for shape in ((4, 2), (2, 4), (8, 1), (1, 8)):
        mesh = make_mesh(shape, ("i", "j"))
        out[shape] = {"l": dist_cholesky_2d(mesh, t64(tile(k, mesh)), b=8).numpy(),
                      "coords": coords(mesh)}
    mesh = make_mesh((2, 4), ("i", "j"))
    k5 = make_spd(seed=5)
    out["b16"] = {"l": dist_cholesky_2d(mesh, t64(tile(k5, mesh)), b=16).numpy(),
                  "coords": coords(mesh)}
    return out


def rejects_straddling_case(inputs):
    from gpras_tpu_torch.parallel.pcholesky2d import dist_cholesky_2d

    mesh = make_mesh((4, 2), ("i", "j"))
    errors = []
    for k, b in ((make_spd(), 24), (make_spd(n=60), 4)):
        try:
            dist_cholesky_2d(mesh, t64(tile(k, mesh)), b=b)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return {"errors": errors}


def solve_2d_case(inputs):
    from gpras_tpu_torch.parallel.pcholesky2d import (dist_cho_solve_2d, dist_cholesky_2d,
                                                      dist_logdet_from_chol_2d)

    out = {}
    k = make_spd(seed=2)
    rhs = np.random.default_rng(3).normal(size=(N, 4))
    for shape in ((4, 2), (2, 4)):
        mesh = make_mesh(shape, ("i", "j"))
        l = dist_cholesky_2d(mesh, t64(tile(k, mesh)), b=8)
        out[shape] = {"x": dist_cho_solve_2d(mesh, l, t64(rhs), b=8).numpy(),
                      "x1": dist_cho_solve_2d(mesh, l, t64(rhs[:, 0]), b=8).numpy()}
    mesh = make_mesh((4, 2), ("i", "j"))
    l4 = dist_cholesky_2d(mesh, t64(tile(make_spd(seed=4), mesh)), b=8)
    out["logdet"] = float(dist_logdet_from_chol_2d(mesh, l4))
    return out


def composes_with_pgram_2d_case(inputs):
    from gpras_tpu_torch.parallel.pcholesky2d import dist_cho_solve_2d, dist_cholesky_2d
    from gpras_tpu_torch.parallel.pgram import pgram_2d

    mesh = make_mesh((4, 2), ("i", "j"))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(N, 3))
    y = np.sin(x[:, 0])
    params = K.init_params("Matern52", 3, dtype=torch.float64)
    kmat = pgram_2d(mesh, "Matern52", params, t64(x), noise=0.1)
    l = dist_cholesky_2d(mesh, kmat, b=8)
    return {"alpha": dist_cho_solve_2d(mesh, l, t64(y), b=8).numpy()}


def nlml_2d_vs_1d_case(inputs):
    from gpras_tpu_torch.parallel.pexact import make_dist_nlml

    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, 3))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=N)
    xt, yt = t64(x), t64(y)
    params = exact.init_params("Matern52", xt, noise_variance=0.1)
    nlml_2d = make_dist_nlml(make_mesh((4, 2), ("i", "j")), "Matern52", b=8, col_batch=16,
                             layout="2d")
    nlml_1d = make_dist_nlml(make_mesh((8,), ("i",)), "Matern52", b=8, col_batch=16)
    v2, g2 = value_and_grad(lambda p: nlml_2d(p, xt, yt), params)
    v1, g1 = value_and_grad(lambda p: nlml_1d(p, xt, yt), params)
    return {"v2": v2, "g2": g2, "v1": v1, "g1": g1}


def rejects_col_batch_case(inputs):
    from gpras_tpu_torch.parallel.pexact import make_dist_nlml

    rng = np.random.default_rng(1)
    x = rng.normal(size=(N, 3))
    y = np.sin(x[:, 0])
    params = exact.init_params("RBF", t64(x), noise_variance=0.2)
    nlml = make_dist_nlml(make_mesh((1, 8), ("i", "j")), "RBF", b=8, col_batch=3,
                          layout="2d")
    try:
        value_and_grad(lambda p: nlml(p, t64(x), t64(y)), params)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


# ------------------------------------------------------------------- hybrid

HYB_N, HYB_P, HYB_B, HYB_PROBES = 32, 4, 8, 8


def hybrid_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(HYB_N, D))
    y = np.stack([np.sin(rng.normal(size=HYB_N) + i) for i in range(HYB_P)], axis=1)
    return x, y


def _hybrid_local(mesh, x, y):
    """This rank's modes: params, y columns and their global indices."""
    ps = [exact.init_params("Matern52", t64(x), noise_variance=0.1, lengthscales=0.5 + 0.3 * i)
          for i in range(HYB_P)]
    pm = HYB_P // mesh.size(0)
    modes = list(range(mesh.get_local_rank("dp") * pm, (mesh.get_local_rank("dp") + 1) * pm))
    params = {k: torch.stack([ps[i][k] for i in modes]) for k in ps[0]}
    return params, t64(y[:, modes]), modes


def hybrid_nlml_and_grads_case(inputs):
    from gpras_tpu_torch.parallel.hybrid import make_hybrid_nlml_and_grads

    mesh = make_mesh((2, 2, 2), ("dp", "i", "j"))
    x, y = hybrid_data()
    params, y_loc, modes = _hybrid_local(mesh, x, y)
    fn = make_hybrid_nlml_and_grads(mesh, "Matern52", b=HYB_B, probes=HYB_PROBES)
    losses, grads = fn(params, t64(x), y_loc, t64(inputs["hyb_z"][modes]))
    return {"modes": modes, "losses": losses.numpy(), "grads": npd(grads)}


def hybrid_fit_step_case(inputs):
    from gpras_tpu_torch.parallel.hybrid import make_hybrid_fit_step

    mesh = make_mesh((2, 2, 2), ("dp", "i", "j"))
    x, y = hybrid_data(seed=1)
    params, y_loc, modes = _hybrid_local(mesh, x, y)
    init, step = make_hybrid_fit_step(mesh, "Matern52", b=HYB_B, probes=HYB_PROBES,
                                      learning_rate=0.05)
    state, history = init(params), []
    for z in inputs["hyb_step_z"]:
        params, state, losses = step(params, state, t64(x), y_loc, t64(z[modes]))
        history.append(losses.numpy())
    return {"modes": modes, "losses": np.stack(history)}


def hybrid_shape_validation_case(inputs):
    from gpras_tpu_torch.parallel.hybrid import check_hybrid_shapes, make_hybrid_nlml_and_grads

    errors = []
    mesh = make_mesh((2, 2, 2), ("dp", "i", "j"))
    try:
        check_hybrid_shapes(mesh, HYB_N, 3, HYB_B)
    except ValueError as e:
        errors.append(str(e))
    x, y = hybrid_data()
    params, y_loc, _ = _hybrid_local(mesh, x, y)
    flat = make_mesh((8,), ("i",))
    try:
        make_hybrid_nlml_and_grads(flat, "Matern52", b=HYB_B)(
            params, t64(x), y_loc, torch.zeros(y_loc.shape[1], HYB_N, 16, dtype=torch.float64))
    except ValueError as e:
        errors.append(str(e))
    return {"errors": errors}


# -------------------------------------------------------------------- psvgp


def svgp_data(n=128, m=8, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sin(x[:, 0]).astype(np.float32)
    return x, y, x[:: n // m][:m]


def _params32(raw):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in raw.items()}


def dp_step_case(inputs):
    from gpras_tpu_torch.parallel.psvgp import make_dp_minibatch_step, shard_batch

    mesh = make_mesh((8,), ("dp",))
    x, y, _ = svgp_data()
    params = _params32(inputs["svgp_params"])
    out = {}
    for tag, ng in (("adam", None), ("natgrad", 0.5)):
        init, step = make_dp_minibatch_step(mesh, "RBF", n_total=x.shape[0], learning_rate=0.01,
                                            natgrad=ng)
        xb, yb = shard_batch(mesh, torch.as_tensor(x), torch.as_tensor(y))
        p_dp, _, loss = step(params, init(params), xb, yb)
        # the one-process step of gp/svgp on the whole batch
        one = svgp._step_fn("RBF", 0.01, ng)
        p_1, _, loss_1 = one(params, svgp._adam_init(params), torch.as_tensor(x),
                             torch.as_tensor(y), x.shape[0])
        out[tag] = {"params": npd(p_dp), "loss": float(loss), "params_one": npd(p_1),
                    "loss_one": float(loss_1)}
    return out


def dp_fit_case(inputs):
    from gpras_tpu_torch.parallel.psvgp import dp_minibatch_fit

    mesh = make_mesh((8,), ("dp",))
    x, y, _ = svgp_data(n=256, m=8, seed=1)
    params = _params32(inputs["svgp_fit_params"])
    p_fit, hist = dp_minibatch_fit(mesh, "RBF", params, x, y, batch_size=64, epochs=20,
                                   learning_rate=0.02)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    return {"hist": hist, "elbo0": float(svgp.elbo("RBF", params, xt, yt, x.shape[0])),
            "elbo1": float(svgp.elbo("RBF", p_fit, xt, yt, x.shape[0]))}


# -------------------------------------------------------------------- model


def model_dense_case(inputs):
    from gpras_tpu_torch.gp.model import GPRAS

    rng = np.random.default_rng(7)
    n = 256
    x = rng.normal(size=(n, 3))
    base = np.sin(1.5 * x[:, 0]) + 0.4 * x[:, 1]
    y = np.stack([base, base * 0.5 + 0.1], axis=1)
    y += 0.05 * rng.normal(size=y.shape)
    m = GPRAS("RBF", model_type="exact", dtype=torch.float64, device="cpu")
    m.fit(x, y, mesh="auto", optimization_method="adam", max_iter=60, learning_rate=0.05)
    mean, var = m.predict(x[:16])
    if torch.distributed.get_rank() == 0:
        m.to_file(inputs["ckpt"])
    return {"engine": m.fit_info["dist_engine"], "mesh": m.fit_info["dist_mesh_shape"],
            "loss": m.fit_info["loss"].numpy(), "mean": mean, "var": var,
            "params": npd(m.params)}


def model_cg_case(inputs):
    from gpras_tpu_torch.gp.model import GPRAS

    rng = np.random.default_rng(8)
    n = 256
    x = rng.normal(size=(n, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    m = GPRAS("Matern52", model_type="exact", exact_engine="cg", dtype=torch.float64,
              device="cpu")
    m.fit(x, y, mesh="auto", optimization_method="adam", max_iter=25, learning_rate=0.05,
          probes=4, cg_iters=24, precond_rank=0)
    mean, var = m.predict(x[:8])
    return {"engine": m.fit_info["dist_engine"], "mesh": m.fit_info["dist_mesh_shape"],
            "losses": m.fit_info["loss"].numpy(), "mean": mean, "var": var}


GROUPS = {
    "parallel": {
        "mesh": mesh_has_8_devices, "pgram_rows": pgram_rows_case, "pgram_2d": pgram_2d_case,
        "cholesky": dist_cholesky_case, "solve": dist_solve_case, "nlml": dist_nlml_case,
        "ppca": ppca_case, "multi_start": multi_start_case, "de": sharded_de_case,
        "predict": sharded_predict_case, "stochastic": dist_stochastic_case,
    },
    "parallel_engines": {
        "cg": dist_cg_case, "cg_small_noise": dist_cg_small_noise_case,
        "step_2d": dist_fit_step_2d_case, "step_2d_f32": dist_fit_step_2d_f32_case,
    },
    "pcholesky2d": {
        "cholesky": cholesky_2d_case, "rejects": rejects_straddling_case,
        "solve": solve_2d_case, "composes": composes_with_pgram_2d_case,
        "nlml": nlml_2d_vs_1d_case, "col_batch": rejects_col_batch_case,
    },
    "hybrid": {
        "nlml_and_grads": hybrid_nlml_and_grads_case, "fit_step": hybrid_fit_step_case,
        "shapes": hybrid_shape_validation_case,
    },
    "psvgp": {"step": dp_step_case, "fit": dp_fit_case},
    "model": {"dense": model_dense_case, "cg": model_cg_case},
}
