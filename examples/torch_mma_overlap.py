"""Does mma.sync TF32 run beside FP32 work on the same SM? (GPU only)

B3's tensor-core build (gpras_tpu_torch/csrc/kmv_sym.cu) issues covariance
entries (fp32 FMAs, sqrt, exp) and mma.sync.m16n8k8 TF32 products from the
same warps, and its time adds up from the two. This script asks whether
splitting them over warps could overlap them. One kernel, two blocks of 8
warps per SM: the even warps run only mma.sync (8 independent accumulators
each), the odd warps only fp32 FMA chains (16 each). It times the even warps
alone, the odd warps alone, and both together. If the tensor cores ran
beside the FP32 pipes, "both" would take about the longer of the two; if
they share the sub-partitions' issue, about the sum.

Run from the repository root, on the GPU (nvcc builds the kernel into
build/mma_overlap/ first):

    python examples/torch_mma_overlap.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// mode bit 0: even warps run mma.sync; bit 1: odd warps run fp32 FMAs
__global__ void overlap_kernel(float* out, int iters, int mode) {
  const int warp = threadIdx.x >> 5;
  float acc = 0.f;
  if ((warp & 1) == 0 && (mode & 1)) {
    float d[8][4] = {};
    const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) mma(d[u], a, i, u);
    for (int u = 0; u < 8; ++u) acc += d[u][0] + d[u][3];
  }
  if ((warp & 1) == 1 && (mode & 2)) {
    float f[16];
    for (int u = 0; u < 16; ++u) f[u] = threadIdx.x * 1e-3f + u;
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int k = 0; k < 16; ++k)
#pragma unroll
        for (int u = 0; u < 16; ++u) f[u] = fmaf(f[u], 0.9999f, 1e-4f);
    for (int u = 0; u < 16; ++u) acc += f[u];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
extern "C" int run_overlap(void* out, int blocks, int threads, int iters, int mode,
                           void* stream) {
  overlap_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((float*)out, iters, mode);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch

    from gpras_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("torch_mma_overlap: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    build = ROOT / "build" / "mma_overlap"
    build.mkdir(parents=True, exist_ok=True)
    (build / "overlap.cu").write_text(SOURCE)
    lib_path = build / f"liboverlap_{os.getpid()}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:6], "-shared", "-o", str(lib_path),
                    str(build / "overlap.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run_overlap.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 2 * sms, 256, 4000
    out = torch.empty(blocks * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def ms(mode: int) -> float:
        times = []
        for _ in range(4):  # the first is a warm-up
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            if lib.run_overlap(out.data_ptr(), blocks, threads, iters, mode, stream) != 0:
                raise RuntimeError("launch failed")
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times[1:])[1]

    t_mma, t_fma, t_both = ms(1), ms(2), ms(3)
    mma_warps = blocks * threads // 64
    tf32 = mma_warps * iters * 8 * 2 * 16 * 8 * 8 / (t_mma * 1e-3)
    fp32 = (blocks * threads // 2) * iters * 256 * 2 / (t_fma * 1e-3)
    print(f"mma.sync TF32 warps alone: {t_mma:.3f} ms ({tf32 / 1e12:.1f} TFLOP/s)")
    print(f"fp32 FMA warps alone:      {t_fma:.3f} ms ({fp32 / 1e12:.1f} TFLOP/s)")
    print(f"both side by side:         {t_both:.3f} ms (sum {t_mma + t_fma:.3f}, "
          f"longer {max(t_mma, t_fma):.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
