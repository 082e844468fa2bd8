// lpc_residual: the integer LPC residual
//   res[i] = x[i] - ((sum_j taps[j] * x[i-1-j]) >> shift),  res[i < order] = 0
// of every row, in one of two output modes:
//   stats: sum zigzag(res) (int64) and max |res| (int32); res is never
//          written (the estimate-mode order search's exact statistics);
//   zz:    zigzag(res) written out as int32 (the chosen predictor's
//          residual, ready for the Rice search and the emitter).
//
// Replaces the TPU kernels flacx/kernels/lpcres_tile.py::lpc_residual_stats
// (stats mode) and ::zigzag_residual_tiles (zz mode).
//
// The MAC is int32: exact under the static bound
// eff_bps + 1 + bitlen(sum |taps|) <= 31, which the Python wrapper checks
// (the two-limb split MAC past that bound is not ported).  It is carried
// out in unsigned arithmetic (wrap-defined); the shift is arithmetic.
//
// Bound on the card: bytes.  stats reads 4 B/sample (75.5 MB at the
// headline 1024 x 4 x 4608: 22.5 us at 3.35 TB/s); zz reads and writes
// 4 B/sample each (1024 x 2 x 4608: 75.5 MB, 22.5 us).  The MAC (12
// multiply-adds per sample at order 12) is below that.
//
// Design: one block per row; the row streams through shared memory in
// tiles with a 32-sample halo (zero before the row start, as the plain
// version's zero-filled shifts), the taps sit in shared memory, each
// thread walks its samples, and stats end in a block reduction.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 1024;
constexpr int HALO = 32;

template <bool ZZ>
__global__ void __launch_bounds__(THREADS)
lpc_residual_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ taps,
                    const int32_t* __restrict__ shift,
                    const int32_t* __restrict__ order,
                    int32_t* __restrict__ zz, long long* __restrict__ lzz,
                    int32_t* __restrict__ maxabs, int n, int ntaps) {
  constexpr int WARPS = THREADS / 32;
  __shared__ int32_t xs[HALO + TILE];
  __shared__ int32_t tp[HALO];
  __shared__ long long red_s[WARPS];
  __shared__ int red_m[WARPS];

  const int row = blockIdx.x;
  const int32_t* xr = x + (size_t)row * n;
  if (threadIdx.x < HALO)
    tp[threadIdx.x] =
        threadIdx.x < ntaps ? taps[(size_t)row * ntaps + threadIdx.x] : 0;
  const int sh = shift[row];
  const int ord = order[row];
  long long s = 0;
  int mx = 0;

  for (int t0 = 0; t0 < n; t0 += TILE) {
    for (int j = threadIdx.x; j < HALO + TILE; j += THREADS) {
      const int i = t0 - HALO + j;
      xs[j] = (i >= 0 && i < n) ? xr[i] : 0;
    }
    __syncthreads();
    const int m = min(TILE, n - t0);
    for (int j = threadIdx.x; j < m; j += THREADS) {
      const int i = t0 + j;
      const int c = HALO + j;
      uint32_t acc = 0;
#pragma unroll 4
      for (int k = 0; k < ntaps; ++k)
        acc += (uint32_t)tp[k] * (uint32_t)xs[c - 1 - k];
      int32_t res = xs[c] - ((int32_t)acc >> sh);
      if (i < ord) res = 0;
      const int32_t z = flacx::zigzag32(res);
      if (ZZ) {
        zz[(size_t)row * n + i] = z;
      } else {
        s += z;
        mx = max(mx, abs(res));
      }
    }
    __syncthreads();
  }

  if (!ZZ) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    s = flacx::warp_sum(s);
    mx = flacx::warp_max(mx);
    if (lane == 0) {
      red_s[warp] = s;
      red_m[warp] = mx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      long long ts = 0;
      int tm = 0;
      for (int w = 0; w < WARPS; ++w) {
        ts += red_s[w];
        tm = max(tm, red_m[w]);
      }
      lzz[row] = ts;
      maxabs[row] = tm;
    }
  }
}

bool bad_args(int rows, int n, int ntaps) {
  return rows <= 0 || n < 1 || ntaps < 0 || ntaps > HALO;
}

}  // namespace

// x int32 [rows, n], taps int32 [rows, ntaps], shift/order int32 [rows]
// -> lzz int64 [rows], maxabs int32 [rows].
FLACX_API int flacx_lpc_residual_stats(const int32_t* x, const int32_t* taps,
                                       const int32_t* shift,
                                       const int32_t* order, long long* lzz,
                                       int32_t* maxabs, int rows, int n,
                                       int ntaps, cudaStream_t stream) {
  if (bad_args(rows, n, ntaps)) return (int)cudaErrorInvalidValue;
  lpc_residual_kernel<false><<<rows, THREADS, 0, stream>>>(
      x, taps, shift, order, nullptr, lzz, maxabs, n, ntaps);
  return (int)cudaGetLastError();
}

// Same inputs -> zz int32 [rows, n].
FLACX_API int flacx_lpc_residual_zz(const int32_t* x, const int32_t* taps,
                                    const int32_t* shift, const int32_t* order,
                                    int32_t* zz, int rows, int n, int ntaps,
                                    cudaStream_t stream) {
  if (bad_args(rows, n, ntaps)) return (int)cudaErrorInvalidValue;
  lpc_residual_kernel<true><<<rows, THREADS, 0, stream>>>(
      x, taps, shift, order, zz, nullptr, nullptr, n, ntaps);
  return (int)cudaGetLastError();
}
