// lpc_allorder: the selection statistics of EVERY LPC order o = 1..P of
// every row, from one read of the row:
//   res_o[i]  = x[i] - ((sum_{j<o} q[o-1][j] * x[i-1-j]) >> shift[o-1]),
//   res_o[i < o] = 0,
//   lzz[o-1]  = sum_i zigzag(res_o[i])     (int64)
//   max[o-1]  = max_i |res_o[i]|           (int32)
// (flacx_torch.kernels.lpc_allorder.lpc_allorder_plain: lpc_residuals_all,
// warmup mask, reduce).  The exact order search ranks every order by these.
//
// Replaces the TPU kernel flacx/kernels/lpcres_tile.py::lpc_allorder_stats,
// and the JAX package's int64 XLA route of the same statistics past its
// int32 gate (flacx/encoder.py:432-438: lpc_residuals_all in int64, then
// the zigzag sums).
//
// Two MAC widths, chosen by the wrapper from the static bound
// eff_bps + 1 + bitlen(sum |taps|) <= 31:
//   int32: under the bound, in unsigned (wrap-defined) arithmetic with an
//          arithmetic shift; exact.
//   wide:  past it (24-bit stereo: eff_bps 25), an int64 accumulator, one
//          IMAD.WIDE per tap.  |x| < 2^31 and at most 32 taps of precision
//          <= 15 give |sum| < 2^50, so every order's res, its zigzag and
//          the sums are exact int64 values on every lane, those with
//          |res| >= 2^31 included (the order ranking and the window merge
//          read every order's sum); max |res| clamps to 2^31 - 1.
//
// Bound on the card: operations.  Order o costs o multiply-adds per
// sample, sum_{o<=P} o = P(P+1)/2 in all (78 at P = 12).  At 1024 frames x
// 4 virtual channels x 4608 samples that is 1.47e9 int32 multiply-adds per
// window, 0.088 ms at 64 per clock per SM (132 SMs, 1.98 GHz), against
// 75.5 MB of samples read, 0.023 ms at 3.35 TB/s.  The wide MAC's
// IMAD.WIDE counts as two: 256 x 4 x 4608 samples at P = 12 (the file
// encode's --best batch at 24 bits) is 0.044 ms per window.
//
// Design: one block per row.  The row streams through shared memory in
// tiles of TILE samples with a halo of 32 previous samples (zero before the
// row start, as the plain version's zero-filled shifts); the P x P taps
// and the P shifts sit in shared memory.  Each thread walks its samples:
// it loads the previous samples into registers once, then runs every
// order's MAC against them, and keeps a per-order int64 zigzag sum and
// int32 maximum in registers.  Warp shuffles and one cross-warp pass end
// the row.  Orders run in passes over the row whose order range is fixed
// at compile time: orders 1..12 in one pass (the main path), then passes
// of four orders up to 32, so the per-order sums, the sample window and
// the taps the compiler keeps in registers stay within the register file
// (one pass over orders 1..32 spills).  The wide MAC doubles the sums and
// accumulators, so it runs every pass at four orders.  Each later pass
// reads the row again, from L2.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 1024;
constexpr int HALO = 32;     // also the largest order
constexpr int FIRST = 12;    // orders of the first int32 pass; others take 4
constexpr long long INT32_MAX_LL = 2147483647LL;

struct Smem {
  int32_t xs[HALO + TILE];
  int32_t tp[HALO][HALO];
  int32_t sh[HALO];
  long long red_s[WARPS][FIRST];
  int red_m[WARPS][FIRST];
};

// Orders OLO+1 .. min(OHI, p) of one row: their sums and maxima written to
// lzz / maxabs (the row's [p] slices), in the MAC width of WIDE.
template <bool WIDE, int OLO, int OHI>
__device__ __forceinline__ void order_pass(Smem& sm, const int32_t* xr,
                                           long long* lzz, int32_t* maxabs,
                                           int n, int p) {
  constexpr int K = OHI - OLO;
  long long s[K];
  int m[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    s[q] = 0;
    m[q] = 0;
  }

  for (int t0 = 0; t0 < n; t0 += TILE) {
    for (int j = threadIdx.x; j < HALO + TILE; j += THREADS) {
      const int i = t0 - HALO + j;
      sm.xs[j] = (i >= 0 && i < n) ? xr[i] : 0;
    }
    __syncthreads();
    const int cnt = min(TILE, n - t0);
    for (int j = threadIdx.x; j < cnt; j += THREADS) {
      const int i = t0 + j;
      const int c = HALO + j;
      const int32_t xi = sm.xs[c];
      int32_t xw[OHI];
#pragma unroll
      for (int k = 0; k < OHI; ++k) xw[k] = sm.xs[c - 1 - k];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int o = OLO + q;  // order o + 1
        if (o < p) {
          if (WIDE) {
            long long acc = 0;
#pragma unroll
            for (int k = 0; k <= o; ++k)
              acc += (long long)sm.tp[o][k] * (long long)xw[k];
            long long res = (long long)xi - (acc >> sm.sh[o]);
            if (i <= o) res = 0;
            s[q] += (long long)(((unsigned long long)res << 1) ^
                                (unsigned long long)(res >> 63));
            const long long a = res < 0 ? -res : res;
            m[q] = max(m[q], (int)(a < INT32_MAX_LL ? a : INT32_MAX_LL));
          } else {
            uint32_t acc = 0;
#pragma unroll
            for (int k = 0; k <= o; ++k)
              acc += (uint32_t)sm.tp[o][k] * (uint32_t)xw[k];
            int32_t res = xi - ((int32_t)acc >> sm.sh[o]);
            if (i <= o) res = 0;
            s[q] += flacx::zigzag32(res);
            m[q] = max(m[q], abs(res));
          }
        }
      }
    }
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (OLO + q < p) {
      const long long vs = flacx::warp_sum(s[q]);
      const int vm = flacx::warp_max(m[q]);
      if (lane == 0) {
        sm.red_s[warp][q] = vs;
        sm.red_m[warp][q] = vm;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < K && OLO + (int)threadIdx.x < p) {
    long long ts = 0;
    int tm = 0;
    for (int w = 0; w < WARPS; ++w) {
      ts += sm.red_s[w][threadIdx.x];
      tm = max(tm, sm.red_m[w][threadIdx.x]);
    }
    lzz[OLO + threadIdx.x] = ts;
    maxabs[OLO + threadIdx.x] = tm;
  }
  __syncthreads();  // red_* and xs are reused by the next pass
}

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
lpc_allorder_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ qcoefs,
                    const int32_t* __restrict__ shifts,
                    long long* __restrict__ lzz, int32_t* __restrict__ maxabs,
                    int n, int p, int t) {
  __shared__ Smem sm;
  const int row = blockIdx.x;
  for (int e = threadIdx.x; e < HALO * HALO; e += THREADS) {
    const int o = e / HALO, j = e - o * HALO;
    sm.tp[o][j] = (o < p && j <= o && j < t)
                      ? qcoefs[((size_t)row * p + o) * t + j]
                      : 0;
  }
  if (threadIdx.x < HALO)
    sm.sh[threadIdx.x] =
        threadIdx.x < p ? shifts[(size_t)row * p + threadIdx.x] : 0;
  __syncthreads();

  const int32_t* xr = x + (size_t)row * n;
  long long* lz = lzz + (size_t)row * p;
  int32_t* mx = maxabs + (size_t)row * p;
  if (WIDE) {
    order_pass<true, 0, 4>(sm, xr, lz, mx, n, p);
    if (p > 4) order_pass<true, 4, 8>(sm, xr, lz, mx, n, p);
    if (p > 8) order_pass<true, 8, 12>(sm, xr, lz, mx, n, p);
  } else {
    order_pass<false, 0, FIRST>(sm, xr, lz, mx, n, p);
  }
  if (p > 12) order_pass<WIDE, 12, 16>(sm, xr, lz, mx, n, p);
  if (p > 16) order_pass<WIDE, 16, 20>(sm, xr, lz, mx, n, p);
  if (p > 20) order_pass<WIDE, 20, 24>(sm, xr, lz, mx, n, p);
  if (p > 24) order_pass<WIDE, 24, 28>(sm, xr, lz, mx, n, p);
  if (p > 28) order_pass<WIDE, 28, 32>(sm, xr, lz, mx, n, p);
}

}  // namespace

// x int32 [rows, n], qcoefs int32 [rows, p, t] (row o-1 is the order-o
// predictor), shifts int32 [rows, p] -> lzz int64 [rows, p], maxabs int32
// [rows, p]; wide != 0 takes the int64 MAC.  Returns the CUDA error code
// of the launch.
FLACX_API int flacx_lpc_allorder(const int32_t* x, const int32_t* qcoefs,
                                 const int32_t* shifts, long long* lzz,
                                 int32_t* maxabs, int rows, int n, int p,
                                 int t, int wide, cudaStream_t stream) {
  if (rows <= 0 || n < 1 || p < 1 || p > HALO || t < 1 || t > HALO)
    return (int)cudaErrorInvalidValue;
  if (wide)
    lpc_allorder_kernel<true><<<rows, THREADS, 0, stream>>>(
        x, qcoefs, shifts, lzz, maxabs, n, p, t);
  else
    lpc_allorder_kernel<false><<<rows, THREADS, 0, stream>>>(
        x, qcoefs, shifts, lzz, maxabs, n, p, t);
  return (int)cudaGetLastError();
}
