// Shared helpers of the flacx_torch CUDA kernels (plain C interface,
// loaded with ctypes; no PyTorch headers).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define FLACX_API extern "C" __attribute__((visibility("default")))

namespace flacx {

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ uint32_t warp_max(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(FULL_MASK, v, o));
  return v;
}

// zigzag fold of an int32 residual (|r| < 2^30), in unsigned arithmetic.
__device__ __forceinline__ int32_t zigzag32(int32_t r) {
  return (int32_t)(((uint32_t)r << 1) ^ (uint32_t)(r >> 31));
}

}  // namespace flacx
