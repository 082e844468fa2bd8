// lpc_residual: the integer LPC residual
//   res[i] = x[i] - ((sum_j taps[j] * x[i-1-j]) >> shift),  res[i < order] = 0
// of every row, in one of three output modes:
//   stats: sum zigzag(res) (int64) and max |res| (int32, clamped to
//          2^31 - 1); res is never written (the estimate-mode order
//          search's exact statistics);
//   zz:    zigzag((int32) res) written out as int32 (the chosen
//          predictor's residual, ready for the Rice search and the
//          emitter);
//   res:   res written out as int32 together with the stats (the
//          estimate search where the JAX package's tiled emit does not
//          apply: the chosen LPC residual is kept, not recomputed).
//
// Replaces the TPU kernels flacx/kernels/lpcres_tile.py::lpc_residual_stats
// (stats mode) and ::zigzag_residual_tiles (zz mode), including their
// two-limb split MAC (lpcres_tile.py::_mac_rows, split=True), and
// ::lpc_residual_tiles (res mode).
//
// Two MAC widths, chosen by the wrapper from the static bound:
//   int32: exact under eff_bps + 1 + bitlen(sum |taps|) <= 31; carried out
//          in unsigned arithmetic (wrap-defined), the shift arithmetic.
//   wide:  an int64 accumulator, each product (long long)tap * x one
//          IMAD.WIDE.  Exact for every row: |x| < 2^31, T <= 32 taps of
//          precision <= 15 (|tap| <= 2^14) give |sum| < 2^50, so res, its
//          zigzag and the stats sums are exact int64 values (the stats
//          sum wraps in int64 only past 2^63, in the same modular
//          arithmetic as the plain version).  This is stronger than the
//          TPU's split MAC, which only flags the lanes it cannot hold, and
//          equals the JAX package's int64 XLA route (flacx/ops/lpc.py:
//          381-392).  zz narrows res to int32 before the zigzag, as the
//          encoder's int32 working type does: exact on every lane it
//          emits (a chosen LPC residual has max |res| < 2^30; a fixed one
//          has sum |taps| <= 15, so |res| <= 2^(eff_bps+3)).
// The res mode runs the int32 MAC only: the JAX package reaches
// lpc_residual_tiles only under its int32 gate (flacx/ops/lpc.py:342-343),
// which the wrapper asserts.
//
// Bound on the card.  int32 MAC: bytes.  stats reads 4 B/sample (75.5 MB
// at the headline 1024 x 4 x 4608: 22.5 us at 3.35 TB/s); zz and res read
// and write 4 B/sample each (zz at 1024 x 2 x 4608: 75.5 MB, 22.5 us; res
// at 256 x 4 x 1152, the file encode at block 1152: 9.4 MB, 2.8 us); the
// at most 12 multiply-adds per sample at order 12 are below that.  Wide
// MAC: operations, one IMAD.WIDE (two int32 multiply-adds' worth at 64
// per clock per SM, 132 SMs, 1.98 GHz) per sample and nonzero tap: at most
// 32 us for hi-res stats (128 x 4 x 16384 samples, every row at order 32)
// against 10 us for its 33.6 MB.
//
// Design: one block per row; the row streams through shared memory in
// tiles with a 32-sample halo (zero before the row start, as the plain
// version's zero-filled shifts), the taps sit in shared memory, each
// thread walks its samples, and stats end in a block reduction.  The MAC
// runs up to the row's last nonzero tap, not over all T: a fixed
// predictor padded to 32 taps costs its order, and a row's loop length is
// one for the whole block.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 1024;
constexpr int HALO = 32;
static_assert(HALO == 32, "the taps are loaded and scanned by warp 0");
constexpr long long INT32_MAX_LL = 2147483647LL;
// output modes (template argument of the kernel)
constexpr int STATS = 0, ZZ = 1, RES = 2;

// Sample c of the tile in the MAC width of the template: the residual
// narrowed to int32, its zigzag as the stats sum adds it, and its |res|
// as the stats max takes it (clamped to 2^31 - 1 in the wide MAC).
template <bool WIDE>
__device__ __forceinline__ void residual(const int32_t* xs, const int32_t* tp,
                                         int c, int ntaps, int sh,
                                         int32_t& narrow, long long& zz64,
                                         int& absc) {
  if (WIDE) {
    long long acc = 0;
#pragma unroll 4
    for (int k = 0; k < ntaps; ++k)
      acc += (long long)tp[k] * (long long)xs[c - 1 - k];
    const long long res = (long long)xs[c] - (acc >> sh);
    narrow = (int32_t)res;
    zz64 = (long long)(((unsigned long long)res << 1) ^
                       (unsigned long long)(res >> 63));
    const long long a = res < 0 ? -res : res;
    absc = (int)(a < INT32_MAX_LL ? a : INT32_MAX_LL);
  } else {
    uint32_t acc = 0;
#pragma unroll 4
    for (int k = 0; k < ntaps; ++k)
      acc += (uint32_t)tp[k] * (uint32_t)xs[c - 1 - k];
    const int32_t res = xs[c] - ((int32_t)acc >> sh);
    narrow = res;
    zz64 = flacx::zigzag32(res);  // signed, as the plain int32 sum takes it
    absc = abs(res);
  }
}

// MODE is STATS, ZZ or RES; `out` is the zz (ZZ) or res (RES) output.
template <int MODE, bool WIDE>
__global__ void __launch_bounds__(THREADS)
lpc_residual_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ taps,
                    const int32_t* __restrict__ shift,
                    const int32_t* __restrict__ order,
                    int32_t* __restrict__ out, long long* __restrict__ lzz,
                    int32_t* __restrict__ maxabs, int n, int ntaps) {
  static_assert(MODE != RES || !WIDE, "res mode runs the int32 MAC only");
  constexpr int WARPS = THREADS / 32;
  __shared__ int32_t xs[HALO + TILE];
  __shared__ int32_t tp[HALO];
  __shared__ long long red_s[WARPS];
  __shared__ int red_m[WARPS];
  __shared__ int nt_s;  // taps up to the row's last nonzero one

  const int row = blockIdx.x;
  const int32_t* xr = x + (size_t)row * n;
  if (threadIdx.x < HALO) {  // warp 0
    const int32_t t =
        threadIdx.x < ntaps ? taps[(size_t)row * ntaps + threadIdx.x] : 0;
    tp[threadIdx.x] = t;
    const unsigned nz = __ballot_sync(0xffffffffu, t != 0);
    if (threadIdx.x == 0) nt_s = 32 - __clz(nz);
  }
  __syncthreads();
  const int nt = nt_s;
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
      int32_t res;
      long long z;
      int a;
      residual<WIDE>(xs, tp, HALO + j, nt, sh, res, z, a);
      if (i < ord) res = 0, z = 0, a = 0;
      if (MODE == ZZ) out[(size_t)row * n + i] = flacx::zigzag32(res);
      if (MODE == RES) out[(size_t)row * n + i] = res;
      if (MODE != ZZ) {
        s += z;
        mx = max(mx, a);
      }
    }
    __syncthreads();
  }

  if (MODE != ZZ) {
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

template <int MODE>
void launch(const int32_t* x, const int32_t* taps, const int32_t* shift,
            const int32_t* order, int32_t* out, long long* lzz,
            int32_t* maxabs, int rows, int n, int ntaps, int wide,
            cudaStream_t stream) {
  if (wide)
    lpc_residual_kernel<MODE, true><<<rows, THREADS, 0, stream>>>(
        x, taps, shift, order, out, lzz, maxabs, n, ntaps);
  else
    lpc_residual_kernel<MODE, false><<<rows, THREADS, 0, stream>>>(
        x, taps, shift, order, out, lzz, maxabs, n, ntaps);
}

}  // namespace

// x int32 [rows, n], taps int32 [rows, ntaps], shift/order int32 [rows]
// -> lzz int64 [rows], maxabs int32 [rows]; wide != 0 takes the int64 MAC.
FLACX_API int flacx_lpc_residual_stats(const int32_t* x, const int32_t* taps,
                                       const int32_t* shift,
                                       const int32_t* order, long long* lzz,
                                       int32_t* maxabs, int rows, int n,
                                       int ntaps, int wide,
                                       cudaStream_t stream) {
  if (bad_args(rows, n, ntaps)) return (int)cudaErrorInvalidValue;
  launch<STATS>(x, taps, shift, order, nullptr, lzz, maxabs, rows, n, ntaps,
                wide, stream);
  return (int)cudaGetLastError();
}

// Same inputs -> zz int32 [rows, n].
FLACX_API int flacx_lpc_residual_zz(const int32_t* x, const int32_t* taps,
                                    const int32_t* shift, const int32_t* order,
                                    int32_t* zz, int rows, int n, int ntaps,
                                    int wide, cudaStream_t stream) {
  if (bad_args(rows, n, ntaps)) return (int)cudaErrorInvalidValue;
  launch<ZZ>(x, taps, shift, order, zz, nullptr, nullptr, rows, n, ntaps,
             wide, stream);
  return (int)cudaGetLastError();
}

// Same inputs -> res int32 [rows, n], lzz int64 [rows], maxabs int32
// [rows]; the int32 MAC only.
FLACX_API int flacx_lpc_residual_res(const int32_t* x, const int32_t* taps,
                                     const int32_t* shift,
                                     const int32_t* order, int32_t* res,
                                     long long* lzz, int32_t* maxabs,
                                     int rows, int n, int ntaps,
                                     cudaStream_t stream) {
  if (bad_args(rows, n, ntaps)) return (int)cudaErrorInvalidValue;
  lpc_residual_kernel<RES, false><<<rows, THREADS, 0, stream>>>(
      x, taps, shift, order, res, lzz, maxabs, n, ntaps);
  return (int)cudaGetLastError();
}
