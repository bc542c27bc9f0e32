"""Fused stationary-covariance matvecs: (K(x1, x2) [+ noise I]) @ V with the
covariance tile never stored in device memory.

Counterpart of ``gpras_tpu/ops/pallas_gram.py``'s ``pallas_kmv``. Its two
Pallas bodies become two CUDA C++ kernels for Hopper (``csrc/kmv.cu``, whose
header note says what bounds them on an H100 and how the design answers it):

- ``kmv_dense`` (B2) replaces ``_kmv_body``: any (x1, x2); the square case
  adds noise on the global diagonal. A row tile's block sweeps the column
  tiles with its accumulators in registers; when there are too few row tiles
  to fill the card (the posterior mean of a 64- or 256-query bucket) the
  column sweep is split across blocks and the partial sums are added in a
  fixed order by a second pass.
- ``kmv_sym`` (B3) replaces ``_kmv_sym_body``: square only, upper-triangle
  tiles, each built once and contracted twice, walked as a diagonal
  wavefront of launches so every accumulator has one writer per launch
  (deterministic, no atomics).

Both contract in plain fp32 FMA (no TF32 anywhere). Inputs are pre-scaled by
the ARD lengthscales here, outside the kernel, as the reference does.

``kmv_plain`` is the kernels' plain PyTorch version (row panels of
``kernels.gram`` @ V, plus noise * V): a wrapper uses it only when its
tensors lie on the CPU. On a CUDA tensor a wrapper launches its kernel or
raises — there is no fallback. Each wrapper counts its kernel launches in a
plain integer attribute (``kmv_dense.launches``, ``kmv_sym.launches``): one
per wrapper call that runs its kernel. A ``kmv_dense`` call is one CUDA grid,
or two when it splits its sweep; a ``kmv_sym`` call on N rows is ceil(N / 64)
wavefront grids plus one grid that adds the mirror (769 at N = 49,152).
"""

from __future__ import annotations

import torch

from gpras_tpu_torch.ops import kernels as K

Tensor = torch.Tensor

#: kernel name -> the id the CUDA entry points switch on (csrc/kmv.cu)
KERNEL_IDS = {"RBF": 0, "Matern12": 1, "Matern32": 2, "Matern52": 3, "Exponential": 4}
TILE = 64        # covariance tile edge of both CUDA kernels
MAX_DIM = 128    # input dimensions the kernels stage in shared memory


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
        raise ValueError(f"fused kmv runs on cpu (plain) or cuda (kernel), got {kind}")
    return kind == "cpu"


def _kernel_args(kernel: str, params: dict[str, Tensor], v: Tensor,
                 noise: Tensor | float | None, *xs: Tensor):
    """Check what the CUDA kernels take and pre-scale the coordinates.
    Returns (kernel id, scaled xs..., variance (1,), noise (1,))."""
    if kernel not in KERNEL_IDS:
        raise ValueError(f"the fused kmv kernels support {sorted(KERNEL_IDS)}, got {kernel}")
    for t in (v, *xs):
        if t.dtype != torch.float32:
            raise TypeError(f"the fused kmv kernels take float32 tensors, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError("the fused kmv kernels take contiguous 2-D tensors, got "
                             f"shape {tuple(t.shape)} strides {t.stride()}")
    d = xs[0].shape[1]
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"the fused kmv kernels take 1..{MAX_DIM} input dimensions, got {d}")
    dev = v.device
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
    kid, a, b, var, nz = _kernel_args(kernel, params, v, noise if square else None, x1, xb)
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


def kmv_sym(kernel: str, params: dict[str, Tensor], x: Tensor, v: Tensor,
            noise: Tensor | float | None = None) -> Tensor:
    """(K(x, x) + noise I) @ v through kernel B3 (upper-triangle tiles).

    x (N, D), v (N, R) -> (N, R) float32."""
    if _on_cpu(x, v):
        return kmv_plain(kernel, params, x, v, noise=noise)
    from gpras_tpu_torch.ops._build import library

    if x.shape[0] != v.shape[0]:
        raise ValueError(f"v has {v.shape[0]} rows, x has {x.shape[0]}")
    kid, a, var, nz = _kernel_args(kernel, params, v, noise, x)
    n, d = a.shape
    r = v.shape[1]
    out = torch.empty((n, r), dtype=torch.float32, device=v.device)
    mirror = torch.empty_like(out)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = library().gpras_kmv_sym(kid, a.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 mirror.data_ptr(), var.data_ptr(), nz.data_ptr(),
                                 n, d, r, stream)
    kmv_sym.launches += 1
    _check(rc, "kmv_sym")
    return out


kmv_sym.launches = 0
