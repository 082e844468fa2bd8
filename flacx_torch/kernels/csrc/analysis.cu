// analysis: windowed autocorrelation (lags 0..max_lag) and the five
// fixed-order zigzag sums of every row, from ONE read of the row.
//
// Replaces the TPU kernels flacx/kernels/autocorr_tile.py::autocorr_tiled
// and flacx/kernels/zzsum_tile.py::fixed_order_sums.  Its f64 mode is the
// counterpart of the f64 analysis that the JAX package runs as XLA
// (flacx/ops/lpc.py:143-150; the TPU kernel takes f32 only).
//
// Semantics (flacx_torch.ops.lpc.autocorrelate and
// flacx_torch.ops.fixedpred.fixed_order_zz_sums), with T = float or double
// the window's type:
//   w[i]        = T(x[i]) * window[i]                         (T, rounded)
//   autoc[l]    = sum_{i=l}^{n-2} (double) T(w[i-l] * w[i])    (f64 sums)
//   fsums[o]    = sum_{i>=o} zigzag(D^o x[i])                  (int64 sums)
// with D^o the o-th difference in int32.  Products use __fmul_rn /
// __dmul_rn and the f64 sums __dadd_rn, so no multiply is fused into an
// add and each product rounds exactly as the plain version's; the sums
// differ from it only in summation order.  With fixed = 0 the fixed-order
// sums are skipped (later windows of a multi-window analysis).
//
// Widths: the kernel serves every path up to 24-bit samples, where the
// stereo side channel is 25 bits (eff_bps 25).  T(x) is exact there: an
// eff_bps-bit sample has |x| <= 2^(eff_bps-1) = 2^24, which f32 holds
// exactly.  The int32 differences are exact up to eff_bps 26: |D^o x| <=
// 2^o * 2^(eff_bps-1) <= 2^(eff_bps+3) for o <= 4, so |D^4 x| <= 2^29 and
// its zigzag fits int32; the sums are int64.  (flacx leaves its TPU kernel
// at eff_bps > 17, where its int32 tile partials could wrap; there is no
// such partial here.)
//
// Bound on the card.  f32: bytes.  Each int32 sample is read once (the
// window is 4 B/sample shared by all rows); at the headline batch, 1024
// frames x 4 virtual channels x 4608 samples = 75.5 MB, 22.5 us at
// 3.35 TB/s; the arithmetic (13 f32 products + 13 f64 adds + ~20 int ops
// per sample) stays below that.  f64: operations.  At lag 12, 13 f64
// products and 13 f64 adds per sample plus the window multiply: 4.9e8 f64
// operations at the same shape, 29 us at 64 per clock per SM (132 SMs,
// 1.98 GHz), against the same 22.5 us of bytes.  At hi-res (128 frames x
// 4 virtual channels x 16384 samples, lag 32, f32) the bytes are 33.6 MB,
// 10 us.
//
// Design: one block per row.  The row streams through shared memory in
// tiles of TILE samples with a halo of max(P, 4) previous samples, so
// every lag product and every difference reads shared memory only.  Each
// thread keeps its partial sums in registers (lags unrolled to the
// template bound); a warp-shuffle then cross-warp reduction ends the row.
// One launch per window: the lag sums of several windows in f64 registers
// would spill at order 32.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 1024;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
template <typename T>
__device__ __forceinline__ T from_int(int32_t v);
template <>
__device__ __forceinline__ float from_int<float>(int32_t v) {
  return __int2float_rn(v);
}
template <>
__device__ __forceinline__ double from_int<double>(int32_t v) {
  return __int2double_rn(v);
}

template <typename T, int MAXLAG>
__global__ void __launch_bounds__(THREADS)
analysis_kernel(const int32_t* __restrict__ x, const T* __restrict__ win,
                double* __restrict__ autoc, long long* __restrict__ fsums,
                int n, int max_lag, int fixed) {
  constexpr int HALO = MAXLAG > 4 ? MAXLAG : 4;
  constexpr int WARPS = THREADS / 32;
  __shared__ T ws[HALO + TILE];
  __shared__ int32_t xs[HALO + TILE];
  __shared__ double red_d[WARPS][MAXLAG + 1];
  __shared__ long long red_i[WARPS][5];

  const int row = blockIdx.x;
  const int32_t* xr = x + (size_t)row * n;
  double acc[MAXLAG + 1];
  long long fs[5];
#pragma unroll
  for (int l = 0; l <= MAXLAG; ++l) acc[l] = 0.0;
#pragma unroll
  for (int o = 0; o < 5; ++o) fs[o] = 0;

  for (int t0 = 0; t0 < n; t0 += TILE) {
    for (int j = threadIdx.x; j < HALO + TILE; j += THREADS) {
      const int i = t0 - HALO + j;
      const bool in = i >= 0 && i < n;
      const int32_t v = in ? xr[i] : 0;
      xs[j] = v;
      ws[j] = in ? mul_rn(from_int<T>(v), win[i]) : T(0);
    }
    __syncthreads();
    const int m = min(TILE, n - t0);
    for (int j = threadIdx.x; j < m; j += THREADS) {
      const int i = t0 + j;
      const int c = HALO + j;
      if (i <= n - 2) {  // the last sample takes part in no product
        const T wi = ws[c];
#pragma unroll
        for (int l = 0; l <= MAXLAG; ++l)
          if (l <= max_lag && i >= l)
            acc[l] = __dadd_rn(acc[l], (double)mul_rn(ws[c - l], wi));
      }
      if (fixed) {
        // o-th differences by the chain d_o[i] = d_{o-1}[i] - d_{o-1}[i-1]
        const int32_t a0 = xs[c], a1 = xs[c - 1], a2 = xs[c - 2];
        const int32_t a3 = xs[c - 3], a4 = xs[c - 4];
        const int32_t d10 = a0 - a1, d11 = a1 - a2, d12 = a2 - a3,
                      d13 = a3 - a4;
        const int32_t d20 = d10 - d11, d21 = d11 - d12, d22 = d12 - d13;
        const int32_t d30 = d20 - d21, d31 = d21 - d22;
        const int32_t d40 = d30 - d31;
        fs[0] += flacx::zigzag32(a0);
        if (i >= 1) fs[1] += flacx::zigzag32(d10);
        if (i >= 2) fs[2] += flacx::zigzag32(d20);
        if (i >= 3) fs[3] += flacx::zigzag32(d30);
        if (i >= 4) fs[4] += flacx::zigzag32(d40);
      }
    }
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int l = 0; l <= MAXLAG; ++l) {
    const double v = flacx::warp_sum(acc[l]);
    if (lane == 0) red_d[warp][l] = v;
  }
#pragma unroll
  for (int o = 0; o < 5; ++o) {
    const long long v = flacx::warp_sum(fs[o]);
    if (lane == 0) red_i[warp][o] = v;
  }
  __syncthreads();
  if (threadIdx.x <= max_lag) {
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s = __dadd_rn(s, red_d[w][threadIdx.x]);
    autoc[(size_t)row * (max_lag + 1) + threadIdx.x] = s;
  } else if (fixed && threadIdx.x >= 64 && threadIdx.x < 69) {
    const int o = threadIdx.x - 64;
    long long s = 0;
    for (int w = 0; w < WARPS; ++w) s += red_i[w][o];
    fsums[(size_t)row * 5 + o] = s;
  }
}

template <typename T>
void launch(const int32_t* x, const void* win, double* autoc,
            long long* fsums, int rows, int n, int max_lag, int fixed,
            cudaStream_t stream) {
  const T* w = static_cast<const T*>(win);
  if (max_lag <= 12)
    analysis_kernel<T, 12><<<rows, THREADS, 0, stream>>>(x, w, autoc, fsums,
                                                          n, max_lag, fixed);
  else
    analysis_kernel<T, 32><<<rows, THREADS, 0, stream>>>(x, w, autoc, fsums,
                                                          n, max_lag, fixed);
}

}  // namespace

// x int32 [rows, n], win [n] (f32, or f64 when f64 != 0) -> autoc f64
// [rows, max_lag+1] and, when fixed != 0, fsums int64 [rows, 5].  Returns
// the CUDA error code of the launch.
FLACX_API int flacx_analysis(const int32_t* x, const void* win,
                             double* autoc, long long* fsums, int rows, int n,
                             int max_lag, int f64, int fixed,
                             cudaStream_t stream) {
  if (rows <= 0 || n < 2 || max_lag < 0 || max_lag > 32 ||
      (fixed && fsums == nullptr))
    return (int)cudaErrorInvalidValue;
  if (f64)
    launch<double>(x, win, autoc, fsums, rows, n, max_lag, fixed, stream);
  else
    launch<float>(x, win, autoc, fsums, rows, n, max_lag, fixed, stream);
  return (int)cudaGetLastError();
}
