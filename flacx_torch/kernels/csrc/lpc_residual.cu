// lpc_residual: the integer LPC residual
//   res[i] = x[i] - ((sum_j taps[j] * x[i-1-j]) >> shift),  res[i < order] = 0
// of every row, in one of three output modes:
//   stats: sum zigzag(res) (int64) and max |res| (int32, clamped to
//          2^31 - 1); res is never written (the estimate-mode order
//          search's exact statistics);
//   zz:    zigzag((int32) res) written out as int32 (the chosen
//          predictor's residual, ready for the Rice search and the
//          emitter), or zigzag(res) as int64 with no narrowing (past
//          24-bit samples, the encoder's int64 working type);
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
//   wide:  the int64 MAC's exact sum, carried out as f64 fused
//          multiply-adds (DFMA, at the full f64 rate; IMAD.WIDE was the
//          hi-res rows' limit).  Exact for every row: |x| < 2^31, T <= 32
//          taps of precision <= 15 (|tap| <= 2^14) give |sum| < 2^50, so every
//          product and partial sum is an integer f64 holds exactly, and
//          res, its zigzag and the stats sums are exact int64 values (the
//          stats sum wraps in int64 only past 2^63, in the same modular
//          arithmetic as the plain version).  This is stronger than the
//          TPU's split MAC, which only flags the lanes it cannot hold, and
//          equals the JAX package's int64 XLA route (flacx/ops/lpc.py:
//          381-392).  The bound holds at its extremes: eff_bps 32 (|x| <=
//          2^31) and precision 15 give |x| * sum |taps| <= 2^31 * 2^19 =
//          2^50 < 2^53, so each product and partial sum is an exact f64
//          integer, |res| <= 2^31 + 2^50 and its zigzag < 2^52.  The int32
//          zz narrows res to int32 before the zigzag, as the encoder's
//          int32 working type does: exact on every lane it emits (a chosen
//          LPC residual has max |res| < 2^30; a fixed one has sum |taps|
//          <= 15, so |res| <= 2^(eff_bps+3)).  The int64 zz keeps res
//          whole: zigzag(res) of the int64 MAC, exact on every lane.
// The res mode runs the int32 MAC only: the JAX package reaches
// lpc_residual_tiles only under its int32 gate (flacx/ops/lpc.py:342-343),
// which the wrapper asserts.
//
// Bound on the card.  int32 MAC: bytes.  stats reads 4 B/sample (75.5 MB
// at the headline 1024 x 4 x 4608: 22.5 us at 3.35 TB/s); zz and res read
// and write 4 B/sample each (zz at 1024 x 2 x 4608: 75.5 MB, 22.5 us; the
// int64 zz writes 8: 113 MB, 34 us; res
// at 256 x 4 x 1152, the file encode at block 1152: 9.4 MB, 2.8 us); the
// at most 12 multiply-adds per sample at order 12 are below that.  Wide
// MAC: operations, one DFMA (64 per clock per SM, 132 SMs, 1.98 GHz) per
// sample and nonzero tap: at most 16 us for hi-res stats (128 x 4 x 16384
// samples, every row at order 32) against 10 us for its 33.6 MB.
//
// Design: a grid over (segment of `seg` samples, row), seg a multiple of
// PASS = THREADS * RUN up to 2304.  Each block stages its segment in
// shared memory (all its loads in flight before the first store),
// coalesced, with a 32-sample halo before it (zero before the row start,
// as the plain version's zero-filled shifts).  Warp 0 finds the row's last
// nonzero tap (a ballot), and the block runs the MAC body of the bucket
// (0, 4, 8, 12, 16, 24 or 32 taps) that covers it: the taps sit in
// registers under a fully unrolled loop, the zero taps the bucket adds
// change no result.  Each thread computes RUN consecutive residuals a pass
// from a window of RUN + taps samples, each read once from shared memory
// (RUN odd: a warp's strided reads hit distinct banks; the wide MAC stages
// the samples as f64 too).  zz and
// res go through shared memory and leave coalesced.  The warm-up mask
// takes the row position.  Stats end in a block reduction; a row of
// several segments adds its blocks' sums by integer atomics (64-bit add,
// max) into outputs the wrapper zeroes: the same bits in any order.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int RUN = 9;                  // consecutive residuals of a thread
constexpr int PASS = THREADS * RUN;     // samples of a block's pass: 1152
// The largest segment a block takes (the wrapper's SEG_MAX): the wide
// MAC's zz block, which holds its samples as f64 too, needs 37 KB there,
// and one more pass would pass the 48 KB of static shared memory.
constexpr int SEG_MAX = 2 * PASS;
constexpr int HALO = 32;
constexpr int STAGE = (HALO + SEG_MAX + THREADS - 1) / THREADS;  // loads
constexpr long long INT32_MAX_LL = 2147483647LL;
// output modes (template argument of the kernel); ZZ64 is zz as int64
constexpr int STATS = 0, ZZ = 1, RES = 2, ZZ64 = 3;

struct Args {
  const int32_t* x;      // [rows, n]
  const int32_t* taps;   // [rows, ntaps]
  const int32_t* shift;  // [rows]
  const int32_t* order;  // [rows]
  void* out;             // [rows, n]: zz (ZZ int32, ZZ64 int64), res (RES)
  long long* lzz;        // [rows] (STATS, RES)
  int32_t* maxabs;       // [rows] (STATS, RES)
  int n, ntaps, seg, nseg;
};

// The type of a mode's output.
template <int MODE>
using Out = typename std::conditional<MODE == ZZ64, long long, int32_t>::type;

// A block's segment in shared memory: the samples with the halo, as f64
// too for the wide MAC, and the zz or res output, to leave coalesced (at
// most 46.5 KB: the wide MAC's int64 zz).
template <int MODE, bool WIDE>
struct Shared {
  double xd[WIDE ? HALO + SEG_MAX : 1];
  int32_t xs[HALO + SEG_MAX];
  Out<MODE> outs[MODE != STATS ? SEG_MAX : 1];
};

// The views of it the MAC bodies take, and the row's taps [HALO].
template <int MODE>
struct Seg {
  double* xd;
  int32_t* xs;
  Out<MODE>* outs;
  const int32_t* tp;
};

// An integer-valued f64 |d| < 2^51 as int64, exactly: added to 1.5 * 2^52
// it lands where one ulp is 1, so its bits count it up from that constant.
__device__ __forceinline__ long long exact_ll(double d) {
  return __double_as_longlong(__dadd_rn(d, 0x1.8p52)) - 0x4338000000000000LL;
}

// The residual of a sample in the MAC width of WIDE (the product sum `acc`
// exact): whole in v, narrowed to int32 in res, its zigzag as the stats
// sum adds it, and its |res| as the stats max takes it (clamped to 2^31 -
// 1 in the wide MAC).  Under the int32 MAC's bound res is whole too.
template <bool WIDE>
__device__ __forceinline__ void epilogue(int32_t x, long long acc, int sh,
                                         long long& v, int32_t& res,
                                         long long& z, int& a) {
  if (WIDE) {
    v = (long long)x - (acc >> sh);
    res = (int32_t)v;
    z = (long long)(((unsigned long long)v << 1) ^
                    (unsigned long long)(v >> 63));
    const long long av = v < 0 ? -v : v;
    a = (int)(av < INT32_MAX_LL ? av : INT32_MAX_LL);
  } else {
    res = x - ((int32_t)(uint32_t)acc >> sh);
    v = res;
    z = flacx::zigzag32(res);  // signed, as the plain int32 sum takes it
    a = abs(res);
  }
}

// The residual of the run's sample r (row position i): masked, written to
// the segment's output or added to the stats.
template <int MODE>
__device__ __forceinline__ void emit(const Seg<MODE>& sm, int c, int r,
                                     int i, int m, int ord, long long v,
                                     int32_t res, long long z, int a,
                                     long long& s, int& mx) {
  if (i < ord) v = 0, res = 0, z = 0, a = 0;
  if (MODE == ZZ) sm.outs[c + r] = flacx::zigzag32(res);
  if (MODE == ZZ64)
    sm.outs[c + r] = (long long)(((unsigned long long)v << 1) ^
                                 (unsigned long long)(v >> 63));
  if (MODE == RES) sm.outs[c + r] = res;
  if ((MODE == STATS || MODE == RES) && c + r < m) {
    s += z;
    mx = max(mx, a);
  }
}

// The residuals of every pass of the block's segment with the first NT
// taps (the rest are zero); stats into s / mx.  int32 MAC: the run's
// window of samples and the taps in registers, one IMAD a tap (wrapping
// uint32).  Wide MAC: the taps as f64 in registers, each sample of the
// window read once and fused into the run's RUN sums (one DFMA a tap);
// every product and partial sum is an integer below 2^50 (|x| < 2^31,
// |tap| <= 2^14, 32 taps), exact in f64, so the sum is the int64 MAC's.
template <int MODE, bool WIDE, int NT>
__device__ __forceinline__ void segment(const Seg<MODE>& sm, int s0, int m,
                                        int sh,
                                        int ord, long long& s, int& mx) {
  const int passes = (m + PASS - 1) / PASS;
  if (WIDE) {
    double td[NT > 0 ? NT : 1];
#pragma unroll
    for (int k = 0; k < NT; ++k) td[k] = (double)sm.tp[k];
    for (int p = 0; p < passes; ++p) {
      const int c = p * PASS + threadIdx.x * RUN;  // the run's segment index
      double acc[RUN];
#pragma unroll
      for (int r = 0; r < RUN; ++r) acc[r] = 0.0;
#pragma unroll
      for (int j = 0; j < NT + RUN - 1; ++j) {  // x[c - NT + j]
        const double v = sm.xd[HALO + c - NT + j];
#pragma unroll
        for (int r = 0; r < RUN; ++r) {
          const int k = NT + r - 1 - j;  // the tap of v for sample r
          if (k >= 0 && k < NT) acc[r] = __fma_rn(td[k], v, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RUN; ++r) {
        long long v, z;
        int32_t res;
        int a;
        epilogue<true>(sm.xs[HALO + c + r], exact_ll(acc[r]), sh, v, res, z,
                       a);
        emit<MODE>(sm, c, r, s0 + c + r, m, ord, v, res, z, a, s, mx);
      }
    }
    return;
  }
  int32_t tr[NT > 0 ? NT : 1];
#pragma unroll
  for (int k = 0; k < NT; ++k) tr[k] = sm.tp[k];
  for (int p = 0; p < passes; ++p) {
    const int c = p * PASS + threadIdx.x * RUN;  // the run's segment index
    int32_t win[NT + RUN];                       // x[c - NT .. c + RUN - 1]
#pragma unroll
    for (int k = 0; k < NT + RUN; ++k) win[k] = sm.xs[HALO + c - NT + k];
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      uint32_t acc = 0;
#pragma unroll
      for (int k = 0; k < NT; ++k)
        acc += (uint32_t)tr[k] * (uint32_t)win[NT + r - 1 - k];
      long long v, z;
      int32_t res;
      int a;
      epilogue<false>(win[NT + r], (long long)acc, sh, v, res, z, a);
      emit<MODE>(sm, c, r, s0 + c + r, m, ord, v, res, z, a, s, mx);
    }
  }
}

// MODE is STATS, ZZ, RES or ZZ64.
template <int MODE, bool WIDE>
__global__ void __launch_bounds__(THREADS) lpc_residual_kernel(Args a) {
  static_assert(MODE != RES || !WIDE, "res mode runs the int32 MAC only");
  __shared__ Shared<MODE, WIDE> seg;
  __shared__ int32_t tp[HALO];
  __shared__ long long red_s[WARPS];
  __shared__ int red_m[WARPS];
  __shared__ int nt_s;  // taps up to the row's last nonzero one

  const int row = blockIdx.x / a.nseg, sg = blockIdx.x % a.nseg;
  const int n = a.n, s0 = sg * a.seg;
  const int m = min(a.seg, n - s0);  // samples of the segment
  const int32_t* xr = a.x + (size_t)row * n;
  const Seg<MODE> sm{seg.xd, seg.xs, seg.outs, tp};
  if (threadIdx.x < HALO) {  // warp 0
    const int32_t t = threadIdx.x < a.ntaps
                          ? a.taps[(size_t)row * a.ntaps + threadIdx.x]
                          : 0;
    tp[threadIdx.x] = t;
    const unsigned nz = __ballot_sync(flacx::FULL_MASK, t != 0);
    if (threadIdx.x == 0) nt_s = 32 - __clz(nz);
  }
  {  // every load of the segment in flight before the first store
    int32_t v[STAGE];
#pragma unroll
    for (int q = 0; q < STAGE; ++q) {
      const int j = threadIdx.x + q * THREADS, i = s0 - HALO + j;
      v[q] = j < HALO + m && i >= 0 ? xr[i] : 0;
    }
#pragma unroll
    for (int q = 0; q < STAGE; ++q) {
      const int j = threadIdx.x + q * THREADS;
      if (j < HALO + m) {
        seg.xs[j] = v[q];
        if (WIDE) seg.xd[j] = (double)v[q];
      }
    }
  }
  __syncthreads();
  const int nt = nt_s, sh = a.shift[row], ord = a.order[row];
  long long s = 0;
  int mx = 0;
  if (nt == 0)
    segment<MODE, WIDE, 0>(sm, s0, m, sh, ord, s, mx);
  else if (nt <= 4)
    segment<MODE, WIDE, 4>(sm, s0, m, sh, ord, s, mx);
  else if (nt <= 8)
    segment<MODE, WIDE, 8>(sm, s0, m, sh, ord, s, mx);
  else if (nt <= 12)
    segment<MODE, WIDE, 12>(sm, s0, m, sh, ord, s, mx);
  else if (nt <= 16)
    segment<MODE, WIDE, 16>(sm, s0, m, sh, ord, s, mx);
  else if (nt <= 24)
    segment<MODE, WIDE, 24>(sm, s0, m, sh, ord, s, mx);
  else
    segment<MODE, WIDE, 32>(sm, s0, m, sh, ord, s, mx);

  if (MODE != STATS) {
    __syncthreads();
    Out<MODE>* o = static_cast<Out<MODE>*>(a.out) + (size_t)row * n + s0;
    for (int j = threadIdx.x; j < m; j += THREADS) o[j] = sm.outs[j];
  }
  if (MODE == STATS || MODE == RES) {
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
      if (a.nseg == 1) {
        a.lzz[row] = ts;
        a.maxabs[row] = tm;
      } else {
        atomicAdd(reinterpret_cast<unsigned long long*>(a.lzz + row),
                  (unsigned long long)ts);
        atomicMax(a.maxabs + row, tm);
      }
    }
  }
}

bool bad_args(int rows, int n, int ntaps, int seg) {
  return rows <= 0 || n < 1 || ntaps < 0 || ntaps > HALO || seg <= 0 ||
         seg % PASS || seg > SEG_MAX;
}

template <int MODE, bool WIDE>
void launch(const Args& a, int rows, cudaStream_t stream) {
  lpc_residual_kernel<MODE, WIDE><<<rows * a.nseg, THREADS, 0, stream>>>(a);
}

template <int MODE>
void launch(const Args& a, int rows, int wide, cudaStream_t stream) {
  if (wide)
    launch<MODE, true>(a, rows, stream);
  else
    launch<MODE, false>(a, rows, stream);
}

}  // namespace

// x int32 [rows, n], taps int32 [rows, ntaps], shift/order int32 [rows]
// -> lzz int64 [rows], maxabs int32 [rows]; wide != 0 takes the int64 MAC.
// seg: the samples of a segment (a multiple of 1152, at most 2304); past
// one segment a row, lzz and maxabs must hold zeros.
FLACX_API int flacx_lpc_residual_stats(const int32_t* x, const int32_t* taps,
                                       const int32_t* shift,
                                       const int32_t* order, long long* lzz,
                                       int32_t* maxabs, int rows, int n,
                                       int ntaps, int wide, int seg,
                                       cudaStream_t stream) {
  if (bad_args(rows, n, ntaps, seg)) return (int)cudaErrorInvalidValue;
  const Args a{x, taps, shift, order, nullptr, lzz, maxabs, n, ntaps, seg,
               (n + seg - 1) / seg};
  launch<STATS>(a, rows, wide, stream);
  return (int)cudaGetLastError();
}

// Same inputs -> zz [rows, n], int32 (the residual narrowed first), or
// int64 when out64 != 0.
FLACX_API int flacx_lpc_residual_zz(const int32_t* x, const int32_t* taps,
                                    const int32_t* shift, const int32_t* order,
                                    void* zz, int rows, int n, int ntaps,
                                    int wide, int seg, int out64,
                                    cudaStream_t stream) {
  if (bad_args(rows, n, ntaps, seg)) return (int)cudaErrorInvalidValue;
  const Args a{x,  taps,    shift, order, zz, nullptr, nullptr,
               n,  ntaps,   seg,   (n + seg - 1) / seg};
  if (out64)
    launch<ZZ64>(a, rows, wide, stream);
  else
    launch<ZZ>(a, rows, wide, stream);
  return (int)cudaGetLastError();
}

// Same inputs -> res int32 [rows, n], lzz int64 [rows], maxabs int32
// [rows] (zeros past one segment a row); the int32 MAC only.
FLACX_API int flacx_lpc_residual_res(const int32_t* x, const int32_t* taps,
                                     const int32_t* shift,
                                     const int32_t* order, int32_t* res,
                                     long long* lzz, int32_t* maxabs,
                                     int rows, int n, int ntaps, int seg,
                                     cudaStream_t stream) {
  if (bad_args(rows, n, ntaps, seg)) return (int)cudaErrorInvalidValue;
  const Args a{x, taps, shift, order, res, lzz, maxabs, n, ntaps, seg,
               (n + seg - 1) / seg};
  launch<RES, false>(a, rows, stream);
  return (int)cudaGetLastError();
}
