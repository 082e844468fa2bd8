// Shared helpers of the flacx_torch CUDA kernels (plain C interface,
// loaded with ctypes; no PyTorch headers).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define FLACX_API extern "C" __attribute__((visibility("default")))

namespace flacx {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_DEVICES = 64;  // cards a process may launch on

// Past 48 KB, a kernel's dynamic shared memory is opt-in, and the opt-in
// holds for the current device only: `allowed` keeps the size granted on
// each device (one array a kernel, zero-initialised).  A `carveout` of 0
// to 100 also sets the kernel's preferred shared-memory carveout, in the
// same per-device step.  Returns the CUDA error of the opt-in, which the
// launcher passes back to its wrapper.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       int (&allowed)[MAX_DEVICES], int carveout = -1) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  if (carveout >= 0) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
    if (e != cudaSuccess) return e;
  }
  allowed[dev] = bytes;
  return cudaSuccess;
}

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

// Round-to-nearest f64 add (nvcc contracts nothing into it), wrapping
// integer add, XOR and max: the operations of reduce_scatter and
// warp_all.
struct AddRn {
  __device__ __forceinline__ double operator()(double a, double b) const {
    return __dadd_rn(a, b);
  }
};
struct Add {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct Xor {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a ^ b; }
};
struct Max {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a < b ? b : a;
  }
};

// Sums v[0..V) over the warp with `op`, V a power of two <= 32, by
// halving: at each step a lane keeps half of its values and adds its
// partner's copy of that half, so V - 1 shuffles replace V * 5.  Returns
// value lane >> (5 - log2 V)'s sum (lanes that differ only in the low bits
// hold the same).  Every loop has a constant trip count, so v stays in
// registers, and the order of the adds is fixed.
template <int V, typename T, typename Op>
__device__ __forceinline__ T reduce_scatter(T (&v)[V], int lane, Op op) {
  constexpr int LOG2V = V == 32 ? 5 : V == 16 ? 4 : V == 8 ? 3 : 0;
  static_assert(LOG2V, "V is 8, 16 or 32");
#pragma unroll
  for (int step = 0; step < LOG2V; ++step) {
    const int h = V >> (step + 1), b = 16 >> step;
    const bool hi = lane & b;
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      if (k < h) {
        const T send = hi ? v[k] : v[k + h];
        const T keep = hi ? v[k + h] : v[k];
        v[k] = op(keep, __shfl_xor_sync(FULL_MASK, send, b));
      }
    }
  }
  T s = v[0];
#pragma unroll
  for (int step = LOG2V; step < 5; ++step)
    s = op(s, __shfl_xor_sync(FULL_MASK, s, 16 >> step));
  return s;
}

// `op` of v over the warp, in every lane (a butterfly: the same order in
// every lane).
template <typename T, typename Op>
__device__ __forceinline__ T warp_all(T v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// zigzag fold of an int32 residual (|r| < 2^30), in unsigned arithmetic.
__device__ __forceinline__ int32_t zigzag32(int32_t r) {
  return (int32_t)(((uint32_t)r << 1) ^ (uint32_t)(r >> 31));
}

// Asynchronous global -> shared copies (sm_80+): 16 bytes (both addresses
// 16-byte aligned, bypassing L1), 8 or 4 bytes; a thread's copies since its
// last commit form one group, and wait<N> returns once at most N of its
// groups are still in flight.  A __syncthreads after the wait makes every
// thread's copies visible to the block.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace flacx
