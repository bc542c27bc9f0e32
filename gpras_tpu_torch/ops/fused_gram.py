"""Fused stationary-covariance kernels: the Gram matrix, its matvec, and the
training gradient contraction, each a CUDA C++ kernel for Hopper.

Counterpart of ``gpras_tpu/ops/pallas_gram.py``. Its five Pallas bodies
become CUDA C++ kernels (``csrc/*.cu``; each file's header note says what
bounds it on an H100 and how the design answers it):

- ``gram`` (B1, ``csrc/gram.cu``) replaces ``_tile_body``: K(x1, x2) with
  noise on the diagonal when square, written once to device memory.
  Persistent blocks (``gram_plan``) walk 64 x 64 tiles, for a square Gram
  only the upper triangle, each tile staged in shared memory with its
  transpose and written out as itself and its mirror.
- ``kmv_dense`` (B2, ``csrc/kmv.cu``) replaces ``_kmv_body``: any (x1, x2);
  the square case adds noise on the global diagonal. ``kmv_dense_plan``
  picks the design from the shape: up to 16 right-hand sides and too few
  64-row tiles to fill the card (the posterior mean of a 64- or 256-query
  bucket), a thread owns a query row and a block sweeps a chunk of the
  training points from packed shared-memory records; otherwise a row tile's
  block sweeps 64 x 64 covariance tiles built in shared memory. Either way
  the column sweep is split across blocks when the rows alone leave SMs
  idle, and a second grid adds the partial sums in a fixed order.
- ``kmv_sym`` (B3, ``csrc/kmv_sym.cu``) replaces ``_kmv_sym_body``: square
  only, the plan from ``kmv_sym_plan``. Above 16 right-hand sides a block
  sweeps the whole square for 128 output rows with its accumulators in
  registers, building covariance entries straight into tensor-core fragments
  and contracting them in 3xTF32; up to 16 each upper-triangle tile is built
  once and contracted twice, its mirror half written to a slot of its own
  and the slots added in a fixed order. Deterministic, no atomics.
- ``kgrad_dense`` (B4, ``csrc/kgrad_dense.cu``) and ``kgrad_sym`` (B5,
  ``csrc/kgrad_sym.cu``) replace ``_kgrad_body`` and ``_kgrad_sym_body``:
  sum_ij Kbar_ij dK_ij/dtheta for the rank-(m+1) training cotangent, partial
  sums in float64 added in a fixed order. Both pack their operands once and
  run persistent blocks over the strip pairs of the upper triangle
  (csrc/kgrad_strips.cuh): B5 segments of each pair (``kgrad_sym_plan``), B4
  an even share of the whole walk per block (``kgrad_dense_plan``).
  ``kgrad`` picks between them by the reference's rule.

Any input dimension D: up to STAGED_DIM = 128 a kernel stages every
coordinate of a point in shared memory; past it B1, B3 and B4/B5 stage the
first 128 and read the rest from the packed coordinates they keep in device
memory, and B2's tiled build stages them 128 at a time (its rows design is
planned only up to 128). The squared distance is accumulated over the whole
feature axis in the order of the dimensions before the covariance is
applied, so the plans and bits at D <= 128 are those of the whole staging.

All compute in plain fp32, except B3's 3xTF32 contraction above 16
right-hand sides (hi/lo split of both operands, ~2^-22 per product; the one
use of TF32 in the package).

A wrapper issues no device operation of its own besides its kernel's grids
and the allocation of the result and scratch: the kernels read the
log-space hyperparameters from device memory, exponentiate them, and divide
the raw coordinates by the lengthscales as they load them (``csrc/hyper.cuh``;
the same bits as ``x / torch.exp(log_lengthscales)``). A noise or cotangent
scale that is a device tensor is read by the kernel; a Python number or a
CPU tensor is passed by value.

Each kernel has a plain PyTorch version beside it (``gram_plain``,
``kmv_plain``, ``kgrad_plain``); a wrapper uses it only when its tensors lie
on the CPU. On a CUDA tensor a wrapper launches its kernel or raises — there
is no fallback. Each wrapper counts its kernel launches in a plain integer
attribute (``gram.launches``, ``kmv_dense.launches``, ...): one per wrapper
call that runs its kernel. A ``gram`` call is two CUDA grids (the pack
grid, then the tiles; three when not square: ``gram_plan(...).grids``); a
``kgrad_dense`` or ``kgrad_sym`` call three (pack, strips, sum); a
``kmv_dense`` call is one grid, or two when it splits its sweep
(``kmv_dense_plan(...).grids``); a
``kmv_sym`` call two or three whatever N (``kmv_sym_plan(...).grids``), and
``kmv_sym.grids`` adds up the grids its calls launched as the kernel's entry
point counts them.
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Callable
from typing import NamedTuple

import torch

from gpras_tpu_torch.ops import kernels as K

Tensor = torch.Tensor

#: kernel name -> the id the CUDA entry points switch on (csrc/kmv.cu)
KERNEL_IDS = {"RBF": 0, "Matern12": 1, "Matern32": 2, "Matern52": 3, "Exponential": 4}
TILE = 64        # covariance tile edge of both CUDA kernels
#: input dimensions a kernel stages in shared memory for a point
#: (csrc/hyper.cuh): a wider input takes the kernels' wide path, any D
STAGED_DIM = 128
#: the first designs kept as timing yardsticks (``_gram_cuda(..., tiles=True)``,
#: ``_kgrad_cuda(..., tiles=True)``) stage every dimension, up to this many
FIRST_DESIGN_MAX_DIM = 128
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


class _Hyper(NamedTuple):
    """What every CUDA entry point takes (csrc/hyper.cuh): the kernel id, the
    log-space hyperparameters in device memory (the tensors are held here so
    that they outlive the launch), and the lengthscales' stride in floats
    (0: one lengthscale for every dimension)."""
    kid: int
    log_var: Tensor
    log_ls: Tensor
    ls_stride: int

    def args(self) -> tuple[int, int, int]:
        return self.log_var.data_ptr(), self.log_ls.data_ptr(), self.ls_stride


def _kernel_args(kernel: str, params: dict[str, Tensor], xs: tuple[Tensor, ...],
                 others: tuple[Tensor, ...] = ()) -> _Hyper:
    """Check what the CUDA kernels take: float32, contiguous tensors, 2-D
    coordinates ``xs`` of at least one dimension, and one log-variance and
    one or D log-lengthscales (moved to the coordinates' device as float32 if
    they are not there already)."""
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
    if d < 1:
        raise ValueError(f"the fused kernels take at least one input dimension, got {d}")
    dev = xs[0].device
    log_var = params["log_variance"].to(device=dev, dtype=torch.float32)
    log_ls = params["log_lengthscales"].to(device=dev, dtype=torch.float32).reshape(-1)
    if log_var.numel() != 1 or log_ls.numel() not in (1, d):
        raise ValueError(f"the fused kernels take one log_variance and 1 or {d} "
                         f"log_lengthscales, got {tuple(log_var.shape)} and {tuple(log_ls.shape)}")
    return _Hyper(KERNEL_IDS[kernel], log_var, log_ls,
                  log_ls.stride(0) if log_ls.numel() > 1 else 0)


def _scalar_arg(value: Tensor | float | None, dev: torch.device) -> tuple[Tensor | None, float]:
    """A scalar as the CUDA entry points take it: (a one-element float32
    tensor on ``dev`` for the kernel to read, 0.0), or (None, the value)
    for a Python number, a CPU tensor or None (0.0). Reading a device tensor
    here would wait for the device; the kernel reads it instead."""
    if value is None:
        return None, 0.0
    if isinstance(value, Tensor) and value.device.type != "cpu":
        if value.numel() != 1:
            raise ValueError(f"expected one value, got shape {tuple(value.shape)}")
        return value.to(device=dev, dtype=torch.float32), 0.0
    return None, float(value)


def _ptr(t: Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


@functools.cache
def _sms(dev: torch.device) -> int:
    """SMs of a CUDA device (looked up once per device)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launcher(fn, args: tuple, held: tuple) -> Callable[[], int]:
    """``fn(*args)`` as a function of no arguments that returns the CUDA error
    code and keeps ``held`` alive: the tensors behind the pointers in
    ``args`` that the caller does not return."""
    def launch() -> int:
        return fn(*args)

    launch.held = held
    return launch


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


#: B2 sweeps rows per thread when R is at most this and the 64-row tiles are
#: fewer than two per SM; B3 contracts on the tensor cores (3xTF32) above it
SYM_MAX_R = 16
#: B2, rows design: blocks of 64 threads wanted per SM (the column sweep is
#: cut into as many chunks as give that many, at least 64 points each)
ROWS_DEPTH = 16


class KmvPlan(NamedTuple):
    """How ``kmv_dense`` runs one call (csrc/kmv.cu reads the same fields).

    ``rows``: a thread per query row sweeping packed records, else 64 x 64
    tiles in shared memory (STAGED_DIM dimensions at a time when wider).
    ``splits``: blocks along the column sweep.
    ``parts``: float32 elements of scratch for their partial sums (0 without
    a split). ``grids``: CUDA grids per call. ``smem``: shared-memory bytes
    of a block (csrc/kmv.cu's ``rows_smem_floats`` or ``smem_floats``)."""
    rows: bool
    splits: int
    parts: int
    grids: int
    smem: int


def kmv_dense_smem(rows: bool, d: int, r: int) -> int:
    """Shared-memory bytes of a B2 block. Rows design: a stage's 64 packed
    records (dp coordinates, the norm, V) and the rows' coordinates past the
    first 8. Tiled design: the covariance tile, staged rows of V, both
    tiles' coordinates (min(d, STAGED_DIM) at a time), norms, lengthscales."""
    if rows:
        dp = -(-d // 8) * 8
        rt = 1 if r == 1 else 4 if r <= 4 else 8 if r <= 8 else 16
        tail = 4 + (0 if rt == 1 else rt)
        return 4 * (TILE * (dp + tail) + (TILE * (dp - 4) if dp > 8 else 0) + dp)
    tr = 1 if r <= 16 else 4 if r <= 64 else 16
    return 4 * (TILE * (TILE + 4) + 16 * 16 * tr + 2 * min(d, STAGED_DIM) * TILE + 2 * TILE + d)


@functools.cache
def kmv_dense_plan(n1: int, n2: int, r: int, sms: int = 132, d: int = 1) -> KmvPlan:
    """The plan of one ``kmv_dense`` call on x1 (n1, d), x2 (n2, d), v (n2, r)
    on a card of ``sms`` SMs. The rows design takes every call of at most
    SYM_MAX_R right-hand sides and STAGED_DIM dimensions (a thread holds its
    row's coordinates) whose 64-row tiles number fewer than two per SM (so
    the tiles alone could not fill the card), and cuts the column sweep into
    chunks of whole 64-point stages, as many as put ROWS_DEPTH blocks on each
    SM. Every other shape takes the tiled design, whose sweep is split over
    two blocks per SM when the row tiles are fewer."""
    tiles1, tiles2 = -(-n1 // TILE), -(-n2 // TILE)
    rows = r <= SYM_MAX_R and tiles1 < 2 * sms and d <= STAGED_DIM
    if rows:
        per = -(-tiles2 // -(-ROWS_DEPTH * sms // tiles1))
        splits = -(-tiles2 // per)
    else:
        row_blocks = tiles1 * -(-r // (256 if r > 64 else 64 if r > 16 else 16))
        splits = max(1, min(tiles2, -(-2 * sms // row_blocks)))
    return KmvPlan(rows, splits, splits * n1 * r if splits > 1 else 0, 1 + (splits > 1),
                   kmv_dense_smem(rows, d, r))


def _kmv_dense_cuda(kernel: str, params: dict[str, Tensor], x1: Tensor, v: Tensor,
                    x2: Tensor | None, noise: Tensor | float | None,
                    plan: KmvPlan | None = None) -> tuple[Callable[[], int], Tensor]:
    """B2 on CUDA tensors: checks, allocates, and returns (launch, out);
    ``launch()`` enqueues the call's grids and returns the CUDA error code.
    ``plan``: another plan of the same function than ``kmv_dense_plan``'s
    (examples/torch_kgrad_timing.py times the tiled design at the shapes the
    rows design serves)."""
    from gpras_tpu_torch.ops._build import library

    square = x2 is None
    xb = x1 if square else x2
    if v.dim() != 2:
        raise ValueError(f"v must be 2-D, got shape {tuple(v.shape)}")
    if xb.shape[0] != v.shape[0]:
        raise ValueError(f"v has {v.shape[0]} rows, x2 has {xb.shape[0]}")
    hyp = _kernel_args(kernel, params, (x1, xb), (v,))
    if xb.shape[1] != x1.shape[1]:
        raise ValueError(f"x1 has {x1.shape[1]} dimensions, x2 has {xb.shape[1]}")
    dev = v.device
    nz, nz_value = _scalar_arg(noise if square else None, dev)
    (n1, d), n2, r = x1.shape, xb.shape[0], v.shape[1]
    if plan is None:
        plan = kmv_dense_plan(n1, n2, r, _sms(dev), d)
    out = torch.empty((n1, r), dtype=torch.float32, device=dev)
    parts = torch.empty(plan.parts, dtype=torch.float32, device=dev) if plan.parts else out
    fn = library().gpras_kmv_dense
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (hyp.kid, x1.data_ptr(), xb.data_ptr(), v.data_ptr(), out.data_ptr(),
            parts.data_ptr(), *hyp.args(), _ptr(nz), nz_value, n1, n2, d, r, int(square),
            int(plan.rows), plan.splits, stream)
    return _launcher(fn, args, (hyp, nz, parts)), out


def kmv_dense(kernel: str, params: dict[str, Tensor], x1: Tensor, v: Tensor,
              x2: Tensor | None = None, noise: Tensor | float | None = None) -> Tensor:
    """(K(x1, x2) [+ noise I when x2 is None]) @ v through kernel B2, as
    ``kmv_dense_plan`` plans it.

    x1 (N1, D), x2 (N2, D), v (N2, R) -> (N1, R) float32."""
    if _on_cpu(x1, v, x2):
        return kmv_plain(kernel, params, x1, v, x2=x2, noise=noise if x2 is None else None)
    launch, out = _kmv_dense_cuda(kernel, params, x1, v, x2, noise)
    rc = launch()
    kmv_dense.launches += 1
    _check(rc, "kmv_dense")
    return out


kmv_dense.launches = 0


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
    call. ``smem``: shared-memory bytes of a block, which stages
    min(dp, STAGED_DIM) coordinates a point (``kmv_sym_smem``)."""
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
    smem: int


def kmv_sym_smem(tc: bool, width: int, dp: int) -> int:
    """Shared-memory bytes of a B3 block (csrc/kmv_sym.cu: two stages of
    ``tc_stage_floats``, or ``sym_smem_floats``) for dp padded dimensions, of
    which min(dp, STAGED_DIM) are staged."""
    sdp = min(dp, STAGED_DIM)
    if tc:  # per stage: V's split fragments (Tc<NT>::V_FLOATS), coordinates, norms
        v_floats = SYM_STAGE // 8 * 4 * (8 * (4 * width + 4) + 8)
        return 4 * 2 * (v_floats + SYM_STAGE * sdp + SYM_STAGE)
    stage = TILE * (sdp + 4) + TILE + TILE * width
    return 4 * (2 * stage + TILE * (sdp + 4) + TILE + 8 * TILE * width)


def _tc_plan(n: int, d: int, r: int, splits: int) -> SymPlan:
    """The tensor-core build's plan at any R, its sweep split over ``splits``
    blocks (``kmv_sym_plan`` picks it above SYM_MAX_R)."""
    npad = -(-n // SYM_ROWS) * SYM_ROWS
    width = 8 if r <= 64 else 32
    chunks = -(-r // (8 * width))
    dp = -(-d // 8) * 8
    return SymPlan(True, width, chunks, splits, npad, dp, -(-n // TILE),
                   chunks * npad * 16 * width, splits * n * r if splits > 1 else 0,
                   2 + (splits > 1), kmv_sym_smem(True, width, dp))


@functools.cache
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
    dp = -(-d // 8) * 8
    return SymPlan(False, width, chunks, 1, npad, dp, nb, chunks * npad * width,
                   nb * (nb + 1) // 2 * TILE * r, 3, kmv_sym_smem(False, width, dp))


def kmv_sym(kernel: str, params: dict[str, Tensor], x: Tensor, v: Tensor,
            noise: Tensor | float | None = None) -> Tensor:
    """(K(x, x) + noise I) @ v through kernel B3, as ``kmv_sym_plan`` plans it.

    x (N, D), v (N, R) -> (N, R) float32."""
    if _on_cpu(x, v):
        return kmv_plain(kernel, params, x, v, noise=noise)
    return _kmv_sym_run(kmv_sym_plan(x.shape[0], x.shape[1], v.shape[1], _sms(x.device)), kernel,
                        params, x, v, noise)


def _kmv_sym_cuda(plan: SymPlan, kernel: str, params: dict[str, Tensor], x: Tensor, v: Tensor,
                  noise: Tensor | float | None
                  ) -> tuple[Callable[[], int], Tensor, ctypes.c_int]:
    """B3 on CUDA tensors through ``plan``: checks, allocates, and returns
    (launch, out, grids); ``launch()`` enqueues the call's grids and returns
    the CUDA error code, and sets ``grids`` to the number it launched."""
    from gpras_tpu_torch.ops._build import library

    if v.dim() != 2:
        raise ValueError(f"v must be 2-D, got shape {tuple(v.shape)}")
    if x.shape[0] != v.shape[0]:
        raise ValueError(f"v has {v.shape[0]} rows, x has {x.shape[0]}")
    hyp = _kernel_args(kernel, params, (x,), (v,))
    (n, d), r = x.shape, v.shape[1]
    dev = v.device
    nz, nz_value = _scalar_arg(noise, dev)
    out = torch.empty((n, r), dtype=torch.float32, device=dev)
    # one scratch allocation: padded coordinates, norms, V's layout, partial
    # sums; every piece a multiple of 4 floats, so each starts 16-byte aligned
    sizes = (plan.npad * plan.dp, plan.npad, plan.vbuf, plan.parts)
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    xp = scratch.data_ptr()
    nrm = xp + 4 * sizes[0]
    vbuf = nrm + 4 * sizes[1]
    parts = vbuf + 4 * sizes[2] if plan.parts else out.data_ptr()
    grids = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (hyp.kid, x.data_ptr(), v.data_ptr(), out.data_ptr(), xp, nrm, vbuf, parts,
            *hyp.args(), _ptr(nz), nz_value, n, d, r, plan.npad, plan.dp, plan.width,
            int(plan.tc), plan.splits, ctypes.byref(grids), stream)
    return _launcher(library().gpras_kmv_sym, args, (hyp, nz, scratch)), out, grids


def _kmv_sym_run(plan: SymPlan, kernel: str, params: dict[str, Tensor], x: Tensor, v: Tensor,
                 noise: Tensor | float | None) -> Tensor:
    """B3 on CUDA tensors through ``plan`` (``kmv_sym``'s, or another build
    of the same function that examples/torch_kmv_sym_timing.py times)."""
    launch, out, grids = _kmv_sym_cuda(plan, kernel, params, x, v, noise)
    rc = launch()
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


#: B1: how a staged tile leaves shared memory (csrc/gram.cu's STORE_*):
#: 4-byte streaming stores (any N2) or 16-byte streaming stores (N2 % 4 == 0)
GRAM_STORE_SCALAR, GRAM_STORE_VECTOR = 0, 1
#: B1: floats of one staged output tile, 64 rows of 64 with 4 floats of skew
#: every 4 rows (csrc/gram.cu's OBUF)
GRAM_OBUF = TILE * TILE + TILE
#: B1: the most blocks an SM runs (gram_sym_kernel's launch bounds)
GRAM_MAX_PER_SM = 3
SMEM_BYTES = 227 * 1024     # shared memory one block may use on an H100
SM_SMEM_BYTES = 228 * 1024  # shared memory of one H100 SM, 1 KB of it reserved per block


def gram_smem(d: int) -> int:
    """Shared-memory bytes of a B1 block: a tile and its mirror staged for
    the stores, and two input stages of both sides' packed points, each
    min(d, STAGED_DIM) coordinates and the norm."""
    return 4 * (2 * GRAM_OBUF + 4 * (min(d, STAGED_DIM) + 1) * TILE)


class GramPlan(NamedTuple):
    """How ``gram`` runs one call (csrc/gram.cu reads the same fields).

    ``nb1``, ``nb2``: 64-point tiles along each side. ``tiles``: the tiles
    the blocks walk (the upper triangle nb1 (nb1 + 1) / 2 when square, else
    nb1 x nb2). ``blocks``: persistent blocks; block b takes tiles b,
    b + blocks, ... ``fields``: floats per packed point (d coordinates and
    the squared norm). ``pack``: float32 elements of scratch for the packed
    points. ``smem``: shared-memory bytes of a block (``gram_smem``).
    ``store``: how the staged tiles leave (GRAM_STORE_*: 16-byte streaming
    stores when N2 % 4 == 0, else 4-byte ones). ``grids``:
    CUDA grids per call (the pack grid of each side, then the tiles).
    ``staged``: coordinates staged per point, d or, wider, STAGED_DIM (the
    rest are read from the packed points in device memory)."""
    nb1: int
    nb2: int
    tiles: int
    blocks: int
    fields: int
    pack: int
    smem: int
    store: int
    grids: int
    staged: int


@functools.cache
def gram_plan(n1: int, n2: int, d: int, square: bool, sms: int = 132,
              per_sm: int | None = None) -> GramPlan:
    """The plan of one ``gram`` call on x1 (n1, d), x2 (n2, d) (``square``:
    x2 is x1) on a card of ``sms`` SMs: as many blocks as fit an SM at once
    (shared memory, at most GRAM_MAX_PER_SM; ``per_sm`` overrides), never
    more than there are tiles."""
    if square and n1 != n2:
        raise ValueError(f"a square Gram has n1 == n2, got {n1} and {n2}")
    smem = gram_smem(d)
    nb1, nb2 = -(-n1 // TILE), -(-n2 // TILE)
    tiles = nb1 * (nb1 + 1) // 2 if square else nb1 * nb2
    store = GRAM_STORE_VECTOR if n2 % 4 == 0 else GRAM_STORE_SCALAR
    if per_sm is None:
        per_sm = max(1, min(GRAM_MAX_PER_SM, SM_SMEM_BYTES // (smem + 1024)))
    pack = (nb1 if square else nb1 + nb2) * (d + 1) * TILE
    return GramPlan(nb1, nb2, tiles, max(1, min(tiles, per_sm * sms)), d + 1, pack, smem, store,
                    2 if square else 3, min(d, STAGED_DIM))


def _gram_cuda(kernel: str, params: dict[str, Tensor], x1: Tensor, x2: Tensor | None,
               noise: Tensor | float | None, plan: GramPlan | None = None,
               tiles: bool = False) -> tuple[Callable[[], int], Tensor]:
    """B1 on CUDA tensors: checks, allocates, and returns (launch, out);
    ``launch()`` enqueues the call's grids and returns the CUDA error code.
    ``plan``: another plan than ``gram_plan``'s; ``tiles``: the first design,
    a block per 64 x 128 tile of the whole output, which
    examples/torch_gram_timing.py times beside the symmetric one."""
    from gpras_tpu_torch.ops._build import library

    square = x2 is None
    xb = x1 if square else x2
    hyp = _kernel_args(kernel, params, (x1, xb))
    if xb.shape[1] != x1.shape[1]:
        raise ValueError(f"x1 has {x1.shape[1]} dimensions, x2 has {xb.shape[1]}")
    dev = x1.device
    nz, nz_value = _scalar_arg(noise if square else None, dev)
    (n1, d), n2 = x1.shape, xb.shape[0]
    if tiles and d > FIRST_DESIGN_MAX_DIM:
        raise ValueError(f"gram's first design (tiles=True) stages 1..{FIRST_DESIGN_MAX_DIM} "
                         f"input dimensions, got {d}")
    out = torch.empty((n1, n2), dtype=torch.float32, device=dev)
    if tiles:  # scratch: the coordinates divided by the lengthscales; no plan
        scratch = torch.empty(n1 * d + (0 if square else n2 * d), dtype=torch.float32,
                              device=dev)
        blocks = store = 0
    else:
        if plan is None:
            plan = gram_plan(n1, n2, d, square, _sms(dev))
        scratch = torch.empty(plan.pack, dtype=torch.float32, device=dev)
        blocks, store = plan.blocks, plan.store
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (hyp.kid, x1.data_ptr(), xb.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            *hyp.args(), _ptr(nz), nz_value, n1, n2, d, int(square), blocks, store, int(tiles),
            stream)
    return _launcher(library().gpras_gram, args, (hyp, nz, scratch)), out


def gram(kernel: str, params: dict[str, Tensor], x1: Tensor, x2: Tensor | None = None,
         noise: Tensor | float | None = None) -> Tensor:
    """K(x1, x2) [+ noise I when x2 is None] through kernel B1, as
    ``gram_plan`` plans it.

    x1 (N1, D), x2 (N2, D) -> (N1, N2) float32. Counterpart of the
    reference's dispatcher ``pallas_gram.gram``."""
    if _on_cpu(x1, x2):
        return gram_plain(kernel, params, x1, x2, noise)
    launch, out = _gram_cuda(kernel, params, x1, x2, noise)
    rc = launch()
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


#: B5: blocks wanted per SM over the whole sweep (its segments are cut so
#: that the blocks run that many deep, 16 waves of the 4 resident per SM) and
#: the fewest tiles a segment holds
KGRAD_DEPTH = 64
KGRAD_MIN_TILES = 4
#: B4: blocks per SM, each an even share of the walk's tiles (at N = 3,072
#: the walk is ~9 tiles an SM: three blocks of three tiles)
KGRAD_DENSE_PER_SM = 3


class KgradPlan(NamedTuple):
    """How ``kgrad_sym`` and ``kgrad_dense`` run one call
    (csrc/kgrad_strips.cuh reads the same fields). ``nb`` row strips of 64
    points, walked in pairs (p with nb - 1 - p), nb + 1 upper-triangle tiles
    a pair (the middle strip of an odd nb is alone, (nb + 1) / 2 tiles).
    ``groups`` x ``segs`` blocks: B5 cuts each of its
    ``groups`` = ceil(nb / 2) pairs into ``segs`` segments of ``per`` tiles;
    B4 (``per`` 0, ``segs`` 1) gives each of its ``groups`` blocks an even
    share of the walk's tiles. ``dp``: D padded to a multiple of 8 (zeros);
    the sweep repeats per 8 dimensions (``dp // 8`` times). ``fields``: floats
    per packed point (dp + 2 m + 1). ``stages``: column tiles in flight in a
    block's shared-memory ring. Scratch: ``pack`` float32 elements,
    ``partial`` float64 elements. ``grids``: CUDA grids per call.
    ``staged``: floats per staged point, min(dp, STAGED_DIM) + 2 m + 1 (the
    coordinates past STAGED_DIM are read from the packed tiles in device
    memory)."""
    nb: int
    groups: int
    segs: int
    per: int
    dp: int
    fields: int
    stages: int
    pack: int
    partial: int
    grids: int
    staged: int


def _kgrad_staged(dp: int, m: int) -> int:
    return min(dp, STAGED_DIM) + 2 * m + 1


def _kgrad_stages(staged: int, d: int, m: int, name: str) -> int:
    """Depth of the strips' ring of tiles of ``staged`` floats a point:
    three stages while four blocks with their row side then fit an SM's
    shared memory, else as deep as one block's share allows."""
    tile_bytes = staged * TILE * 4
    if 4 * 4 * tile_bytes <= SMEM_BYTES:
        return 3
    if 3 * tile_bytes <= SMEM_BYTES:
        return 2
    if 2 * tile_bytes <= SMEM_BYTES:
        return 1
    raise ValueError(f"{name}: {staged} floats per point (D = {d}, m = {m}) do not fit "
                     "a block's shared memory twice")


@functools.cache
def kgrad_sym_plan(n: int, d: int, m: int, sms: int = 132, per: int | None = None) -> KgradPlan:
    """The plan of one ``kgrad_sym`` call on x (n, d), w and z (n, m) on a
    card of ``sms`` SMs. ``per``: tiles per segment, by default as many as
    leave KGRAD_DEPTH blocks per SM, at least KGRAD_MIN_TILES."""
    nb = -(-n // TILE)
    pairs = (nb + 1) // 2
    dp = -(-d // 8) * 8
    fields = dp + 2 * m + 1
    if per is None:
        per = max(KGRAD_MIN_TILES, -(-(nb + 1) // -(-KGRAD_DEPTH * sms // pairs)))
    segs = -(-(nb + 1) // per)
    per = -(-(nb + 1) // segs)  # as the kernel's entry point derives it
    staged = _kgrad_staged(dp, m)
    return KgradPlan(nb, pairs, segs, per, dp, fields, _kgrad_stages(staged, d, m, "kgrad_sym"),
                     nb * fields * TILE, (1 + dp) * pairs * segs, 3, staged)


@functools.cache
def kgrad_dense_plan(n: int, d: int, m: int, sms: int = 132) -> KgradPlan:
    """The plan of one ``kgrad_dense`` call on x (n, d), w and z (n, m) on a
    card of ``sms`` SMs: B5's walk of strip pairs over the upper triangle,
    shared evenly by KGRAD_DENSE_PER_SM blocks per SM, never more blocks
    than tiles."""
    nb = -(-n // TILE)
    dp = -(-d // 8) * 8
    fields = dp + 2 * m + 1
    blocks = max(1, min(nb * (nb + 1) // 2, KGRAD_DENSE_PER_SM * sms))
    staged = _kgrad_staged(dp, m)
    return KgradPlan(nb, blocks, 1, 0, dp, fields, _kgrad_stages(staged, d, m, "kgrad_dense"),
                     nb * fields * TILE, (1 + dp) * blocks, 3, staged)


def _kgrad_cuda(sym: bool, kernel: str, params: dict[str, Tensor], x: Tensor, w: Tensor,
                z: Tensor, alpha: Tensor, g: Tensor | float, inv_m: float,
                plan: KgradPlan | None = None,
                tiles: bool = False) -> tuple[Callable[[], int], Tensor]:
    """B4 (``sym`` False) or B5 on CUDA tensors: checks, allocates, and
    returns (launch, out (1 + D,) float32); ``launch()`` enqueues the call's
    grids and returns the CUDA error code. ``plan``: another plan than
    ``kgrad_sym_plan``'s or ``kgrad_dense_plan``'s (B5 takes only segmented
    ones); ``tiles``: the first port, one block per tile (csrc/kgrad.cu),
    which examples/torch_kgrad_timing.py times beside the strips."""
    from gpras_tpu_torch.ops._build import library

    if sym and plan is not None and not plan.per:
        raise ValueError("kgrad_sym walks strip pairs in segments only")
    n, m = w.shape
    if alpha.shape != (n,) or z.shape != (n, m) or x.shape[0] != n:
        raise ValueError(f"kgrad takes x (N, D), w and z (N, m), alpha (N,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(z.shape)}, "
                         f"{tuple(alpha.shape)}")
    if not 1 <= m <= MAX_PROBES:
        raise ValueError(f"kgrad takes 1..{MAX_PROBES} probe columns, got {m}")
    hyp = _kernel_args(kernel, params, (x,), (w, z, alpha))
    dev = x.device
    d = x.shape[1]
    if tiles and d > FIRST_DESIGN_MAX_DIM:
        raise ValueError(f"kgrad's first port (tiles=True) stages 1..{FIRST_DESIGN_MAX_DIM} "
                         f"input dimensions, got {d}")
    gt, g_value = _scalar_arg(g, dev)
    out = torch.empty(d + 1, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (hyp.kid, x.data_ptr(), w.data_ptr(), z.data_ptr(), alpha.data_ptr(), *hyp.args(),
            _ptr(gt), g_value, float(inv_m))
    if not tiles:
        if plan is None:
            plan = (kgrad_sym_plan if sym else kgrad_dense_plan)(n, d, m, _sms(dev))
        pack = torch.empty(plan.pack, dtype=torch.float32, device=dev)
        partial = torch.empty(plan.partial, dtype=torch.float64, device=dev)
        tail = (pack.data_ptr(), partial.data_ptr(), out.data_ptr(), n, d, plan.dp, m)
        args = (*head, *tail, plan.segs if sym else plan.groups, plan.stages, stream)
        fn = library().gpras_kgrad_sym if sym else library().gpras_kgrad_dense
        return _launcher(fn, args, (hyp, gt, pack, partial)), out
    nb = -(-n // TILE)
    slots = nb * (nb + 1) // 2 if sym else nb * nb  # kgrad.cu: kgrad_tiles
    partial = torch.empty((d + 1) * slots, dtype=torch.float64, device=dev)
    return _launcher(library().gpras_kgrad,
                     (*head, partial.data_ptr(), out.data_ptr(), n, d, m, int(sym), stream),
                     (hyp, gt, partial)), out


def _kgrad(sym: bool, kernel: str, params: dict[str, Tensor], x: Tensor, w: Tensor,
           z: Tensor, alpha: Tensor, g: Tensor | float, inv_m: float) -> dict[str, Tensor]:
    if _on_cpu(x, w, z, alpha):
        grads = kgrad_plain(kernel, params, x, w, z, alpha, g, inv_m)
        return {"log_variance": grads["log_variance"],
                "log_lengthscales": grads["log_lengthscales"]}
    launch, out = _kgrad_cuda(sym, kernel, params, x, w, z, alpha, g, inv_m)
    rc = launch()
    wrapper = kgrad_sym if sym else kgrad_dense
    wrapper.launches += 1
    _check(rc, wrapper.__name__)
    return {"log_variance": out[0], "log_lengthscales": out[1:]}


def kgrad_dense(kernel: str, params: dict[str, Tensor], x: Tensor, w: Tensor, z: Tensor,
                alpha: Tensor, g: Tensor | float, inv_m: float) -> dict[str, Tensor]:
    """The gradient contraction over every tile, through kernel B4, as
    ``kgrad_dense_plan`` plans it.

    Returns {"log_variance": (), "log_lengthscales": (D,)}; x (N, D), w and
    z (N, m), alpha (N,), float32. The noise and jitter diagonal term is the
    caller's."""
    return _kgrad(False, kernel, params, x, w, z, alpha, g, inv_m)


def kgrad_sym(kernel: str, params: dict[str, Tensor], x: Tensor, w: Tensor, z: Tensor,
              alpha: Tensor, g: Tensor | float, inv_m: float) -> dict[str, Tensor]:
    """The same contraction over upper-triangle tiles with the folded
    cotangent Kbar_ij + Kbar_ji^T, through kernel B5, as ``kgrad_sym_plan``
    plans it."""
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
