"""Two faults of the port's CUDA path, held on the CPU.

C2, any input dimension: the kernels' plans (ops/fused_gram) for inputs wider
than STAGED_DIM = 128 dimensions fit a block's 227 KB of shared memory at
D = 129, 200, 300 and 1,024 and with up to 127 probes, and for D <= 128
every plan is the one the kernels ran before the wide path existed (the
formulas of that version are copied below), so the D <= 128 kernels and
their output bits do not move. The kernels themselves are held against
their plain versions at D = 129, 200 and 300 on the card
(tests/test_torch_cuda_kernels.py, marker ``cuda``).

C1, strided training inputs: ``GPRAS.fit`` stores contiguous tensors and
hands its warm-start rung a contiguous subsample, so with the route forced
to the CUDA kernels every wrapper's own check (contiguous float32) passes.
"""

import numpy as np
import pytest
import torch

from gpras_tpu_torch.gp import exact_stochastic as TS
from gpras_tpu_torch.gp.model import GPRAS
from gpras_tpu_torch.ops import fused_gram as F
import torch_parity  # noqa: F401  (one torch thread)

T = F.TILE
WIDE = (129, 200, 300, 1024)


# ---------------------------------------------- the plans before the wide path


def _pr5_kmv_dense(n1, n2, r, sms):
    tiles1, tiles2 = -(-n1 // T), -(-n2 // T)
    rows = r <= 16 and tiles1 < 2 * sms
    if rows:
        per = -(-tiles2 // -(-16 * sms // tiles1))
        splits = -(-tiles2 // per)
    else:
        row_blocks = tiles1 * -(-r // (256 if r > 64 else 64 if r > 16 else 16))
        splits = max(1, min(tiles2, -(-2 * sms // row_blocks)))
    return (rows, splits, splits * n1 * r if splits > 1 else 0, 1 + (splits > 1))


def _pr5_tc(n, d, r, splits):
    npad = -(-n // 128) * 128
    width = 8 if r <= 64 else 32
    chunks = -(-r // (8 * width))
    return (True, width, chunks, splits, npad, -(-d // 8) * 8, -(-n // T),
            chunks * npad * 16 * width, splits * n * r if splits > 1 else 0, 2 + (splits > 1))


def _pr5_kmv_sym(n, d, r, sms):
    if r > 16:
        plan = _pr5_tc(n, d, r, 1)
        blocks = plan[4] // 128 * plan[2]
        resident = sms * (2 if plan[1] == 8 else 1)
        if blocks < 2 * resident and plan[4] // 32 >= 16:
            return _pr5_tc(n, d, r, 2)
        return plan
    npad = -(-n // 128) * 128
    nb = -(-n // T)
    width = 1 if r == 1 else 4
    chunks = -(-r // width)
    return (False, width, chunks, 1, npad, -(-d // 8) * 8, nb, chunks * npad * width,
            nb * (nb + 1) // 2 * T * r, 3)


def _pr5_gram(n1, n2, d, square, sms):
    smem = 4 * (2 * (T * T + T) + 4 * (d + 1) * T)
    nb1, nb2 = -(-n1 // T), -(-n2 // T)
    tiles = nb1 * (nb1 + 1) // 2 if square else nb1 * nb2
    store = 1 if n2 % 4 == 0 else 0
    per_sm = max(1, min(3, (228 * 1024) // (smem + 1024)))
    pack = (nb1 if square else nb1 + nb2) * (d + 1) * T
    return (nb1, nb2, tiles, max(1, min(tiles, per_sm * sms)), d + 1, pack, smem, store,
            2 if square else 3)


def _pr5_stages(fields):
    tile_bytes = fields * T * 4
    if 16 * tile_bytes <= 227 * 1024:
        return 3
    if 3 * tile_bytes <= 227 * 1024:
        return 2
    return 1


def _pr5_kgrad_sym(n, d, m, sms):
    nb = -(-n // T)
    pairs = (nb + 1) // 2
    dp = -(-d // 8) * 8
    fields = dp + 2 * m + 1
    per = max(4, -(-(nb + 1) // -(-64 * sms // pairs)))
    segs = -(-(nb + 1) // per)
    per = -(-(nb + 1) // segs)
    return (nb, pairs, segs, per, dp, fields, _pr5_stages(fields), nb * fields * T,
            (1 + dp) * pairs * segs, 3)


def _pr5_kgrad_dense(n, d, m, sms):
    nb = -(-n // T)
    dp = -(-d // 8) * 8
    fields = dp + 2 * m + 1
    blocks = max(1, min(nb * (nb + 1) // 2, 3 * sms))
    return (nb, blocks, 1, 0, dp, fields, _pr5_stages(fields), nb * fields * T,
            (1 + dp) * blocks, 3)


@pytest.mark.parametrize("sms", [132, 108])
@pytest.mark.parametrize("d", [1, 3, 8, 9, 20, 64, 120, 127, 128])
def test_plans_up_to_128_dimensions_are_unchanged(d, sms):
    """Every plan field the kernels read is what it was before the wide
    path; the new fields say that every coordinate is staged."""
    for n in (1, 50, 2003, 3585, 49_152, 131_072):
        for r in (1, 4, 16, 17, 64, 65, 256):
            assert F.kmv_sym_plan(n, d, r, sms)[:10] == _pr5_kmv_sym(n, d, r, sms)
            for n1 in (1, 64, 256, 5000):
                plan = F.kmv_dense_plan(n1, n, r, sms, d)
                assert plan[:4] == _pr5_kmv_dense(n1, n, r, sms)
        for m in (1, 16, 127):
            if (d + 7) // 8 * 8 + 2 * m + 1 > 400:  # two tiles no longer fit 227 KB
                continue
            sym, dense = F.kgrad_sym_plan(n, d, m, sms), F.kgrad_dense_plan(n, d, m, sms)
            assert sym[:10] == _pr5_kgrad_sym(n, d, m, sms)
            assert dense[:10] == _pr5_kgrad_dense(n, d, m, sms)
            assert sym.staged == sym.fields and dense.staged == dense.fields
    for n1, n2, square in ((2003, 2003, True), (4999, 3001, False), (49_152, 49_152, True)):
        if d <= 128:
            plan = F.gram_plan(n1, n2, d, square, sms)
            assert plan[:9] == _pr5_gram(n1, n2, d, square, sms) and plan.staged == d


@pytest.mark.parametrize("m", [1, 16, 127])
@pytest.mark.parametrize("d", WIDE)
def test_wide_plans_fit_shared_memory(d, m):
    dp = -(-d // 8) * 8
    for n in (2003, 4096, 49_152, 131_072):
        for sq, n2 in ((True, n), (False, 3001)):
            g = F.gram_plan(n, n2, d, sq)
            assert g.staged == F.STAGED_DIM and g.fields == d + 1
            assert g.smem == F.gram_smem(F.STAGED_DIM) <= F.SMEM_BYTES
            assert g.pack == (g.nb1 + (0 if sq else g.nb2)) * (d + 1) * T  # the whole point
        for r in (1, 4, 16, 17, 64, 256):
            s = F.kmv_sym_plan(n, d, r)
            assert s.dp == dp and s.smem == F.kmv_sym_smem(s.tc, s.width, F.STAGED_DIM)
            assert s.smem <= F.SMEM_BYTES
            for n1 in (64, 256, 5000):
                k = F.kmv_dense_plan(n1, n, r, 132, d)
                assert not k.rows and k.smem <= F.SMEM_BYTES
        for plan in (F.kgrad_sym_plan(n, d, m), F.kgrad_dense_plan(n, d, m)):
            assert plan.dp == dp and plan.fields == dp + 2 * m + 1
            assert plan.staged == F.STAGED_DIM + 2 * m + 1
            assert plan.pack == plan.nb * plan.fields * T
            assert (1 + plan.stages) * plan.staged * T * 4 <= F.SMEM_BYTES


def test_shared_memory_formulas_match_the_kernels_at_the_path_shapes():
    """The Python mirrors of csrc/kmv_sym.cu's and csrc/kmv.cu's sizes at the
    shapes the path runs (worked by hand from the kernels' constants)."""
    # B3 tensor-core build, 64 columns: two stages of (4 x 4 x 296 V floats,
    # 32 points x 8 coordinates, 32 norms)
    assert F.kmv_sym_plan(131_072, 8, 17).smem == 4 * 2 * (4736 + 256 + 32)
    # the symmetric build at R = 16: 2 stages + the row tile + 8 x 64 x 4 reduction
    assert F.kmv_sym_plan(49_152, 8, 16).smem == 4 * (2 * (64 * 12 + 64 + 256) + 64 * 12 + 64
                                                      + 2048)
    # B2 rows design at R = 1, D = 8: 64 records of 8 + 4 floats, 8 lengthscales
    assert F.kmv_dense_plan(256, 49_152, 1, 132, 8).smem == 4 * (64 * 12 + 8)


def test_rows_design_is_not_planned_past_128_dimensions():
    assert F.kmv_dense_plan(256, 49_152, 1, 132, 128).rows
    assert not F.kmv_dense_plan(256, 49_152, 1, 132, 129).rows


def test_kernel_args_take_any_dimension():
    params = {"log_variance": torch.tensor(0.0), "log_lengthscales": torch.zeros(1024)}
    assert F._kernel_args("RBF", params, (torch.zeros((5, 1024)),)).ls_stride == 1
    with pytest.raises(ValueError, match="input dimension"):
        F._kernel_args("RBF", params, (torch.zeros((5, 0)),))


# ------------------------------------------------------------------------ C1


def test_fit_passes_contiguous_tensors_to_the_kernel_route(monkeypatch):
    """The C1 reproduction: a strided float32 x (every other column of a
    wider array) and a warm-start rung (every second point), with the route
    forced to the CUDA kernels. Before the repair B4's wrapper refused the
    rung's x, (2,048, 3) with strides (6, 1). The wrappers' CUDA branch runs
    its own checks and then the plain version, and records what it got."""
    seen = []

    def kgrad_cuda(sym, kernel, params, x, w, z, alpha, g, inv_m, plan=None, tiles=False):
        F._kernel_args(kernel, params, (x,), (w, z, alpha))  # raises on a strided tensor
        seen.append(("kgrad_sym" if sym else "kgrad_dense", tuple(x.shape), x.stride()))
        grads = F.kgrad_plain(kernel, params, x, w, z, alpha, g, inv_m)
        return (lambda: 0), torch.cat([grads["log_variance"].reshape(1),
                                       grads["log_lengthscales"]])

    monkeypatch.setattr(TS, "_kernel_route", lambda kernel, x: True)
    monkeypatch.setattr(F, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(F, "_kgrad_cuda", kgrad_cuda)
    rng = np.random.default_rng(0)
    wide = rng.normal(size=(4096, 6)).astype(np.float32)
    x = torch.as_tensor(wide)[:, ::2]
    assert not x.is_contiguous()
    y = torch.as_tensor(np.sin(wide[:, 0]) + 0.1 * rng.normal(size=4096).astype(np.float32))
    model = GPRAS("Matern52", model_type="exact", exact_engine="hutchinson", device="cpu")
    model.fit(x, y, optimization_method="adam", max_iter=2, warm_start_subsample=2048)
    assert model.x.is_contiguous() and model.y.is_contiguous()
    assert ("kgrad_dense", (2048, 3), (3, 1)) in seen      # the rung: B4
    assert ("kgrad_sym", (4096, 3), (3, 1)) in seen        # the full N: B5
    assert torch.isfinite(model.fit_info["losses"]).all()
