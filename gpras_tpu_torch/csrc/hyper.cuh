// What every kernel of this directory is handed by its wrapper, and how a
// launch asks for its shared memory.
//
// The wrappers (ops/fused_gram.py) issue no device operation of their own
// before a launch: the kernels read the unconstrained (log-space)
// hyperparameters from device memory and exponentiate them themselves, and
// divide the raw coordinates by the lengthscales where they load them.
// expf is the function torch.exp runs on a float32 CUDA tensor, and
// __fdiv_rn is IEEE division, as torch's x / ls, so the scaled coordinates
// and the variance carry the same bits as tensors made by PyTorch would.
#pragma once

#include <cuda_runtime.h>

namespace hyper {

// Input dimensions a kernel stages in shared memory for a point. A wider
// input takes the kernels' wide path (ops/fused_gram.STAGED_DIM): the
// kernels that keep the scaled coordinates in a packed copy in device memory
// (B1, B3, B4/B5) stage the first STAGED_DIM of them as before and read the
// rest from that copy, through the L1 cache, where the sweep reaches them;
// B2's tiled build stages STAGED_DIM at a time. Either way the squared
// distance is accumulated across the whole feature axis, in the order of the
// dimensions, before the covariance is applied.
constexpr int STAGED_DIM = 128;

struct Hyper {
  const float* log_var;  // one float
  const float* log_ls;   // d floats, ls_stride apart (0: one lengthscale for all)
  int ls_stride;
  const float* noise_p;  // one float in device memory, or null: noise_v holds it
  float noise_v;
};

__device__ __forceinline__ float variance(const Hyper& h) { return expf(*h.log_var); }

__device__ __forceinline__ float noise(const Hyper& h) {
  return h.noise_p != nullptr ? *h.noise_p : h.noise_v;
}

__device__ __forceinline__ float lengthscale(const Hyper& h, int c) {
  return expf(h.log_ls[c * h.ls_stride]);
}

// The block's first d threads put the d lengthscales into shared memory;
// the caller synchronizes before reading them.
__device__ __forceinline__ void stage_lengthscales(const Hyper& h, int d, float* ls) {
  for (int c = threadIdx.x; c < d; c += blockDim.x) ls[c] = lengthscale(h, c);
}

// Dynamic shared memory above the 48 KB every kernel has by default must be
// granted once per kernel and device; `granted` is the caller's static
// record per instantiation (bytes granted so far, by device), so a launch
// that fits what was granted, or the default, sets no attribute again.
constexpr int MAX_DEVICES = 64;
constexpr size_t DEFAULT_SMEM = 48 * 1024;

template <typename Kernel>
cudaError_t ensure_smem(Kernel* kernel, size_t bytes, size_t (&granted)[MAX_DEVICES]) {
  if (bytes <= DEFAULT_SMEM) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted[dev] = bytes;
  return err;
}

}  // namespace hyper
