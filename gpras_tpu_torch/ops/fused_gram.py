"""Fused stationary-covariance kernels: the Gram matrix, its matvec, and the
training gradient contraction, each a CUDA C++ kernel for Hopper.

Counterpart of ``gpras_tpu/ops/pallas_gram.py``. Its five Pallas bodies
become CUDA C++ kernels (``csrc/*.cu``; each file's header note says what
bounds it on an H100 and how the design answers it):

- ``gram`` (B1, ``csrc/gram.cu``) replaces ``_tile_body``: K(x1, x2) with
  noise on the diagonal when square, written once to device memory.
- ``kmv_dense`` (B2, ``csrc/kmv.cu``) replaces ``_kmv_body``: any (x1, x2);
  the square case adds noise on the global diagonal. A row tile's block
  sweeps the column tiles with its accumulators in registers; when there are
  too few row tiles to fill the card (the posterior mean of a 64- or
  256-query bucket) the column sweep is split across blocks and the partial
  sums are added in a fixed order by a second pass.
- ``kmv_sym`` (B3, ``csrc/kmv_sym.cu``) replaces ``_kmv_sym_body``: square
  only, the plan from ``kmv_sym_plan``. Above 16 right-hand sides a block
  sweeps the whole square for 128 output rows with its accumulators in
  registers, building covariance entries straight into tensor-core fragments
  and contracting them in 3xTF32; up to 16 each upper-triangle tile is built
  once and contracted twice, its mirror half written to a slot of its own
  and the slots added in a fixed order. Deterministic, no atomics.
- ``kgrad_dense`` (B4) and ``kgrad_sym`` (B5, ``csrc/kgrad.cu``) replace
  ``_kgrad_body`` and ``_kgrad_sym_body``: sum_ij Kbar_ij dK_ij/dtheta for
  the rank-(m+1) training cotangent, per-tile partial sums added in a fixed
  order in float64. ``kgrad`` picks between them by the reference's rule.

All compute in plain fp32, except B3's 3xTF32 contraction above 16
right-hand sides (hi/lo split of both operands, ~2^-22 per product; the one
use of TF32 in the package). Inputs are pre-scaled by the ARD lengthscales
here, outside the kernels, as the reference does.

Each kernel has a plain PyTorch version beside it (``gram_plain``,
``kmv_plain``, ``kgrad_plain``); a wrapper uses it only when its tensors lie
on the CPU. On a CUDA tensor a wrapper launches its kernel or raises — there
is no fallback. Each wrapper counts its kernel launches in a plain integer
attribute (``gram.launches``, ``kmv_dense.launches``, ...): one per wrapper
call that runs its kernel. A ``gram`` call is one CUDA grid; a ``kgrad_*``
call two (the tiles, then the fixed-order sum); a ``kmv_dense`` call is one
grid, or two when it splits its sweep; a ``kmv_sym`` call two or three
whatever N (``kmv_sym_plan(...).grids``), and ``kmv_sym.grids`` adds up the
grids its calls launched as the kernel's entry point counts them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gpras_tpu_torch.ops import kernels as K

Tensor = torch.Tensor

#: kernel name -> the id the CUDA entry points switch on (csrc/kmv.cu)
KERNEL_IDS = {"RBF": 0, "Matern12": 1, "Matern32": 2, "Matern52": 3, "Exponential": 4}
TILE = 64        # covariance tile edge of both CUDA kernels
MAX_DIM = 128    # input dimensions the kernels stage in shared memory
MAX_PROBES = 128  # probe columns kgrad stages in shared memory


def kmv_plain(kernel: str, params: dict[str, Tensor], x1: Tensor, v: Tensor,
              x2: Tensor | None = None, noise: Tensor | float | None = None,
              row_panel: int = 4096) -> Tensor:
    """Plain version of both kernels: (K(x1, x2) [+ noise I]) @ v, built in
    (row_panel, N2) Gram panels. ``noise`` is added only when x2 is None."""
    square = x2 is None
    xb = x1 if square else x2
    out = torch.empty((x1.shape[0], v.shape[1]), dtype=v.dtype, device=v.device)
    for r0 in range(0, x1.shape[0], row_panel):
        out[r0:r0 + row_panel] = K.gram(kernel, params, x1[r0:r0 + row_panel], xb) @ v
    if square and noise is not None:
        out = out + noise * v
    return out


def _on_cpu(*tensors: Tensor | None) -> bool:
    """True when every tensor lies on the CPU; raises on a mix of devices or
    on a device that is neither the CPU nor a CUDA card."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"the fused kernels run on cpu (plain) or cuda (kernel), got {kind}")
    return kind == "cpu"


def _kernel_args(kernel: str, params: dict[str, Tensor], noise: Tensor | float | None,
                 xs: tuple[Tensor, ...], others: tuple[Tensor, ...] = ()):
    """Check what the CUDA kernels take and pre-scale the coordinates ``xs``.
    Returns (kernel id, scaled xs..., variance (1,), noise (1,))."""
    if kernel not in KERNEL_IDS:
        raise ValueError(f"the fused kernels support {sorted(KERNEL_IDS)}, got {kernel}")
    for t in (*xs, *others):
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kernels take float32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the fused kernels take contiguous tensors, got "
                             f"shape {tuple(t.shape)} strides {t.stride()}")
    for t in xs:
        if t.dim() != 2:
            raise ValueError(f"the fused kernels take 2-D inputs, got shape {tuple(t.shape)}")
    d = xs[0].shape[1]
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"the fused kernels take 1..{MAX_DIM} input dimensions, got {d}")
    dev = xs[0].device
    ls = torch.exp(params["log_lengthscales"]).to(device=dev, dtype=torch.float32)
    scaled = [(x / ls).contiguous() for x in xs]
    var = torch.exp(params["log_variance"]).to(device=dev, dtype=torch.float32).reshape(1)
    nz = (torch.zeros(1, dtype=torch.float32, device=dev) if noise is None else
          torch.as_tensor(noise, dtype=torch.float32, device=dev).reshape(1))
    return (KERNEL_IDS[kernel], *scaled, var.contiguous(), nz.contiguous())


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def kmv_dense(kernel: str, params: dict[str, Tensor], x1: Tensor, v: Tensor,
              x2: Tensor | None = None, noise: Tensor | float | None = None) -> Tensor:
    """(K(x1, x2) [+ noise I when x2 is None]) @ v through kernel B2.

    x1 (N1, D), x2 (N2, D), v (N2, R) -> (N1, R) float32."""
    square = x2 is None
    if _on_cpu(x1, v, x2):
        return kmv_plain(kernel, params, x1, v, x2=x2, noise=noise if square else None)
    from gpras_tpu_torch.ops._build import library

    xb = x1 if square else x2
    if xb.shape[0] != v.shape[0]:
        raise ValueError(f"v has {v.shape[0]} rows, x2 has {xb.shape[0]}")
    if v.dim() != 2:
        raise ValueError(f"v must be 2-D, got shape {tuple(v.shape)}")
    kid, a, b, var, nz = _kernel_args(kernel, params, noise if square else None, (x1, xb), (v,))
    n1, d = a.shape
    n2, r = b.shape[0], v.shape[1]
    out = torch.empty((n1, r), dtype=torch.float32, device=v.device)
    # split the column sweep when the row tiles alone leave SMs idle
    # (two blocks per SM); the partial sums are added in a fixed order
    row_blocks = -(-n1 // TILE) * -(-r // (256 if r > 64 else 64 if r > 16 else 16))
    sms = torch.cuda.get_device_properties(v.device).multi_processor_count
    splits = max(1, min(-(-n2 // TILE), -(-2 * sms // row_blocks)))
    parts = (torch.empty((splits, n1, r), dtype=torch.float32, device=v.device)
             if splits > 1 else out)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = library().gpras_kmv_dense(kid, a.data_ptr(), b.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), parts.data_ptr(), var.data_ptr(),
                                   nz.data_ptr(), n1, n2, d, r, int(square), splits,
                                   stream)
    kmv_dense.launches += 1
    _check(rc, "kmv_dense")
    return out


kmv_dense.launches = 0


#: above this many right-hand sides B3 contracts on the tensor cores (3xTF32)
SYM_MAX_R = 16
SYM_ROWS = 128   # B3, tensor-core build: output rows per block; N is padded to it
SYM_STAGE = 32   # B3, tensor-core build: column points per shared-memory stage


class SymPlan(NamedTuple):
    """How ``kmv_sym`` runs one call (csrc/kmv_sym.cu reads the same fields).

    ``tc``: the tensor-core build, else the symmetric one. ``width``: n-tiles
    of 8 columns per block (tc: 8 or 32), or columns per pass (symmetric: 1
    or 4). ``chunks``: blocks along R. ``splits``: blocks along the column
    sweep (tc only; their partial sums are added in a fixed order).
    ``npad``, ``dp``: N padded to 128 rows, D to a multiple of 8 (zeros).
    Scratch sizes in float32 elements: ``vbuf``, V laid out for the build;
    ``parts``, the symmetric build's slots (one 64 x R slot per
    upper-triangle tile i <= j of the ``nb`` row tiles) or the split partial
    sums (splits x N x R, 0 without a split). ``grids``: CUDA grids per
    call."""
    tc: bool
    width: int
    chunks: int
    splits: int
    npad: int
    dp: int
    nb: int
    vbuf: int
    parts: int
    grids: int


def _tc_plan(n: int, d: int, r: int, splits: int) -> SymPlan:
    """The tensor-core build's plan at any R, its sweep split over ``splits``
    blocks (``kmv_sym_plan`` picks it above SYM_MAX_R)."""
    npad = -(-n // SYM_ROWS) * SYM_ROWS
    width = 8 if r <= 64 else 32
    chunks = -(-r // (8 * width))
    return SymPlan(True, width, chunks, splits, npad, -(-d // 8) * 8, -(-n // TILE),
                   chunks * npad * 16 * width, splits * n * r if splits > 1 else 0,
                   2 + (splits > 1))


def kmv_sym_plan(n: int, d: int, r: int, sms: int = 132) -> SymPlan:
    """The plan of one ``kmv_sym`` call on x (n, d), v (n, r) on a card of
    ``sms`` SMs (132: H100): the tensor-core build above SYM_MAX_R
    right-hand sides, else the symmetric one. The tensor-core build splits
    its sweep in two when its blocks would fill fewer than two waves of the
    card's resident blocks (2 an SM for the 64-column build, 1 for the
    256-column one: their launch bounds) and each half keeps 8 stages."""
    if r > SYM_MAX_R:
        plan = _tc_plan(n, d, r, 1)
        blocks = plan.npad // SYM_ROWS * plan.chunks
        resident = sms * (2 if plan.width == 8 else 1)
        if blocks < 2 * resident and plan.npad // SYM_STAGE >= 16:
            return _tc_plan(n, d, r, 2)
        return plan
    npad = -(-n // SYM_ROWS) * SYM_ROWS
    nb = -(-n // TILE)
    width = 1 if r == 1 else 4
    chunks = -(-r // width)
    return SymPlan(False, width, chunks, 1, npad, -(-d // 8) * 8, nb, chunks * npad * width,
                   nb * (nb + 1) // 2 * TILE * r, 3)


def kmv_sym(kernel: str, params: dict[str, Tensor], x: Tensor, v: Tensor,
            noise: Tensor | float | None = None) -> Tensor:
    """(K(x, x) + noise I) @ v through kernel B3, as ``kmv_sym_plan`` plans it.

    x (N, D), v (N, R) -> (N, R) float32."""
    if _on_cpu(x, v):
        return kmv_plain(kernel, params, x, v, noise=noise)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return _kmv_sym_run(kmv_sym_plan(x.shape[0], x.shape[1], v.shape[1], sms), kernel, params,
                        x, v, noise)


def _kmv_sym_run(plan: SymPlan, kernel: str, params: dict[str, Tensor], x: Tensor, v: Tensor,
                 noise: Tensor | float | None) -> Tensor:
    """B3 on CUDA tensors through ``plan`` (``kmv_sym``'s, or another build
    of the same function that examples/torch_kmv_sym_timing.py times)."""
    from gpras_tpu_torch.ops._build import library

    if x.shape[0] != v.shape[0]:
        raise ValueError(f"v has {v.shape[0]} rows, x has {x.shape[0]}")
    if v.dim() != 2:
        raise ValueError(f"v must be 2-D, got shape {tuple(v.shape)}")
    kid, a, var, nz = _kernel_args(kernel, params, noise, (x,), (v,))
    n, d = a.shape
    r = v.shape[1]
    dev = v.device
    out = torch.empty((n, r), dtype=torch.float32, device=dev)
    xp = torch.empty(plan.npad * plan.dp, dtype=torch.float32, device=dev)
    nrm = torch.empty(plan.npad, dtype=torch.float32, device=dev)
    vbuf = torch.empty(plan.vbuf, dtype=torch.float32, device=dev)
    parts = torch.empty(plan.parts, dtype=torch.float32, device=dev) if plan.parts else out
    grids = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = library().gpras_kmv_sym(kid, a.data_ptr(), v.data_ptr(), out.data_ptr(), xp.data_ptr(),
                                 nrm.data_ptr(), vbuf.data_ptr(), parts.data_ptr(),
                                 var.data_ptr(), nz.data_ptr(), n, d, r, plan.npad, plan.dp,
                                 plan.width, int(plan.tc), plan.splits, ctypes.byref(grids),
                                 stream)
    kmv_sym.launches += 1
    kmv_sym.grids += grids.value
    _check(rc, "kmv_sym")
    return out


kmv_sym.launches = 0
kmv_sym.grids = 0  # CUDA grids those calls launched, counted by the kernel's entry point


# ------------------------------------------------------------------ B1: Gram


def gram_plain(kernel: str, params: dict[str, Tensor], x1: Tensor, x2: Tensor | None = None,
               noise: Tensor | float | None = None) -> Tensor:
    """Plain version of ``gram``: ``kernels.gram`` plus noise * I when square
    (added in place on the diagonal: no second (N, N) buffer)."""
    k = K.gram(kernel, params, x1, x2)
    if noise is not None and x2 is None:
        k.diagonal().add_(torch.as_tensor(noise, dtype=k.dtype, device=k.device))
    return k


def gram(kernel: str, params: dict[str, Tensor], x1: Tensor, x2: Tensor | None = None,
         noise: Tensor | float | None = None) -> Tensor:
    """K(x1, x2) [+ noise I when x2 is None] through kernel B1.

    x1 (N1, D), x2 (N2, D) -> (N1, N2) float32. Counterpart of the
    reference's dispatcher ``pallas_gram.gram``."""
    square = x2 is None
    if _on_cpu(x1, x2):
        return gram_plain(kernel, params, x1, x2, noise)
    from gpras_tpu_torch.ops._build import library

    kid, *scaled, var, nz = _kernel_args(kernel, params, noise if square else None,
                                         (x1,) if square else (x1, x2))
    a, b = scaled[0], scaled[-1]
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = library().gpras_gram(kid, a.data_ptr(), b.data_ptr(), out.data_ptr(), var.data_ptr(),
                              nz.data_ptr(), a.shape[0], b.shape[0], a.shape[1], int(square),
                              stream)
    gram.launches += 1
    _check(rc, "gram")
    return out


gram.launches = 0


# ------------------------------------------------------ B4, B5: kgrad


def kgrad_plain(kernel: str, params: dict[str, Tensor], x: Tensor, w: Tensor, z: Tensor,
                alpha: Tensor, g: Tensor | float, inv_m: float,
                col_panel: int = 4096) -> dict[str, Tensor]:
    """Plain version of the gradient contraction: sum_ij Kbar_ij dK_ij/dp for
    every parameter p of ``params`` (zero where K does not depend on it),
    with Kbar = g/2 [inv_m W Z^T - alpha alpha^T].

    The reference's panel loop (exact_stochastic.py:142-161): one column
    panel of the Gram at a time, its cotangent panel built from the
    low-rank factors, pulled back through ``kernels.gram`` by autograd."""
    names = list(params)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    n = x.shape[0]
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(v.is_floating_point()) for k, v in params.items()}
        for c0 in range(0, n, col_panel):
            cols = slice(c0, min(n, c0 + col_panel))
            kbar = 0.5 * g * (inv_m * (w @ z[cols].mT) - alpha[:, None] * alpha[cols][None, :])
            kmat = K.gram(kernel, leaves, x, x[cols])
            diff = [k for k in names if leaves[k].requires_grad]
            parts = torch.autograd.grad(kmat, [leaves[k] for k in diff], kbar,
                                        allow_unused=True)
            for k, gk in zip(diff, parts):
                if gk is not None:
                    grads[k] = grads[k] + gk
    return grads


def _kgrad(sym: bool, kernel: str, params: dict[str, Tensor], x: Tensor, w: Tensor,
           z: Tensor, alpha: Tensor, g: Tensor | float, inv_m: float) -> dict[str, Tensor]:
    if _on_cpu(x, w, z, alpha):
        grads = kgrad_plain(kernel, params, x, w, z, alpha, g, inv_m)
        return {"log_variance": grads["log_variance"],
                "log_lengthscales": grads["log_lengthscales"]}
    from gpras_tpu_torch.ops._build import library

    n, m = w.shape
    if alpha.shape != (n,) or z.shape != (n, m) or x.shape[0] != n:
        raise ValueError(f"kgrad takes x (N, D), w and z (N, m), alpha (N,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(z.shape)}, "
                         f"{tuple(alpha.shape)}")
    if not 1 <= m <= MAX_PROBES:
        raise ValueError(f"kgrad takes 1..{MAX_PROBES} probe columns, got {m}")
    kid, a, var, _ = _kernel_args(kernel, params, None, (x,), (w, z, alpha))
    dev = a.device
    gh = 0.5 * torch.as_tensor(g, dtype=torch.float32, device=dev).reshape(1)
    scal = torch.cat([var, gh, torch.full((1,), inv_m, dtype=torch.float32, device=dev)])
    nb = -(-n // TILE)
    tiles = nb * (nb + 1) // 2 if sym else nb * nb  # kgrad.cu: kgrad_tiles
    d = a.shape[1]
    partial = torch.empty((d + 1) * tiles, dtype=torch.float64, device=dev)
    out = torch.empty(d + 1, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = library().gpras_kgrad(kid, a.data_ptr(), w.data_ptr(), z.data_ptr(), alpha.data_ptr(),
                               scal.data_ptr(), partial.data_ptr(), out.data_ptr(), n, d, m,
                               int(sym), stream)
    wrapper = kgrad_sym if sym else kgrad_dense
    wrapper.launches += 1
    _check(rc, wrapper.__name__)
    out = out.to(x.dtype)
    return {"log_variance": out[0], "log_lengthscales": out[1:]}


def kgrad_dense(kernel: str, params: dict[str, Tensor], x: Tensor, w: Tensor, z: Tensor,
                alpha: Tensor, g: Tensor | float, inv_m: float) -> dict[str, Tensor]:
    """The gradient contraction over every tile, through kernel B4.

    Returns {"log_variance": (), "log_lengthscales": (D,)}; x (N, D), w and
    z (N, m), alpha (N,), float32. The noise and jitter diagonal term is the
    caller's."""
    return _kgrad(False, kernel, params, x, w, z, alpha, g, inv_m)


def kgrad_sym(kernel: str, params: dict[str, Tensor], x: Tensor, w: Tensor, z: Tensor,
              alpha: Tensor, g: Tensor | float, inv_m: float) -> dict[str, Tensor]:
    """The same contraction over upper-triangle tiles with the folded
    cotangent Kbar_ij + Kbar_ji^T, through kernel B5."""
    return _kgrad(True, kernel, params, x, w, z, alpha, g, inv_m)


kgrad_dense.launches = 0
kgrad_sym.launches = 0


def kgrad(kernel: str, params: dict[str, Tensor], x: Tensor, w: Tensor, z: Tensor,
          alpha: Tensor, g: Tensor | float, inv_m: float,
          sym: bool | None = None) -> dict[str, Tensor]:
    """Counterpart of ``pallas_kgrad``: B5 (``kgrad_sym``) when ``sym``, B4
    (``kgrad_dense``) otherwise; by default ``sym`` follows the reference's
    rule, ceil(N / 512) >= 8 (pallas_gram.py:741-742), so B5 from N = 3,585."""
    if sym is None:
        sym = -(-x.shape[0] // 512) >= 8
    return (kgrad_sym if sym else kgrad_dense)(kernel, params, x, w, z, alpha, g, inv_m)
