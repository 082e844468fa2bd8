// analysis: windowed autocorrelation (lags 0..max_lag) of every row under
// one or several windows, and the five fixed-order zigzag sums of every
// row, from ONE read of the row.
//
// Replaces the TPU kernels flacx/kernels/autocorr_tile.py::autocorr_tiled
// and flacx/kernels/zzsum_tile.py::fixed_order_sums.  Its f64 mode is the
// counterpart of the f64 analysis that the JAX package runs as XLA
// (flacx/ops/lpc.py:143-150; the TPU kernel takes f32 only).
//
// Semantics (flacx_torch.ops.lpc.autocorrelate under each window, and
// flacx_torch.ops.fixedpred.fixed_order_zz_sums), with T = float or double
// the windows' type:
//   w[i]        = T(x[i]) * window[i]                         (T, rounded)
//   autoc[l]    = sum_{i=l}^{n-2} (double) T(w[i-l] * w[i])    (f64 sums)
//   fsums[o]    = sum_{i>=o} zigzag(D^o x[i])                  (int64 sums)
// with D^o the o-th difference in int32, or in int64 on the wide route.
// Products use __fmul_rn / __dmul_rn and the f64 sums __dadd_rn, so no
// multiply is fused into an add and each product rounds exactly as the
// plain version's; the sums differ from it only in summation order, which
// is fixed: a batch gives the same bits on every run.  With fixed = 0 the
// fixed-order sums are skipped.
//
// Widths: every int32 sample, eff_bps up to 32.  T(x) is exact while
// |x| <= 2^24 (f32's integers); past that __int2float_rn rounds to
// nearest even, as Tensor.float() and the JAX package's astype round, so
// the f32 windowed values are the plain version's there too (f64 holds
// every int32).  The differences have two routes, chosen by the wrapper
// from eff_bps (analysis.diff_width): int32, exact up to eff_bps 26, since
// |D^o x| <= 2^o * 2^(eff_bps-1) = 2^(eff_bps+3) at o = 4, so |D^4 x| <=
// 2^29 and its zigzag fits int32; and int64 ("wide") past that, where
// |D^4 x| <= 2^35 at eff_bps 32 and its zigzag, 2^36, sums over any row
// in int64.  The sums are int64 on both.
//
// Bound on the card: operations.  f64: per sample and window, the window
// multiply and max_lag + 1 products and adds on the f64 pipe (64 per clock
// per SM, 132 SMs, 1.98 GHz): at the best path's 1024 frames x 4 virtual
// channels x 4608 samples, lag 12 and three windows, 0.092 ms, against
// 0.023 ms for the bytes (the row read once).  f32: the f64 adds, with
// the f32 products and the integer work at the scalar rate.  Each f32
// product widens to f64 before its add, which the f32 rows pay for.
//
// Design: a grid over (segment of `seg` samples, row), seg a multiple of
// PASS = THREADS * RUN up to 4608 (shared memory sized to the segment).
// Each block stages its segment once, coalesced, as int32 in shared memory
// with a halo of P + 4 samples before it (zero before the row start, which
// gives the i >= l rule of the sums).  Then, for each window in turn, it
// writes the windowed values w[i] into shared memory (zero from sample
// n - 1 on: the last sample takes part in no product) and each thread
// takes a run of RUN consecutive samples per pass: it reads the RUN + P
// values its run needs once, forms the RUN x (P+1) products from registers
// and keeps the P+1 sums in registers (RUN is odd, so a warp's strided
// reads hit distinct banks).  A window's sums are reduced (a butterfly in
// each warp that halves the values a lane holds at each step, then the
// warps in order) and written out before the next window starts, so the
// registers hold one window's sums at any P.  The fixed-order sums run
// with the first window, from the staged int32 samples.  A row of one
// segment writes its result; a row of several writes each segment's
// partial sums to scratch, and the row's last block (an atomic ticket
// after __threadfence) adds them in segment order: no float atomics, the
// same bits on every run.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int RUN = 9;                  // consecutive samples of a thread
constexpr int PASS = THREADS * RUN;     // samples of a block's pass: 1152
constexpr int SEG_LIMIT = 4 * PASS;     // the largest segment taken

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

struct Args {
  const int32_t* x;  // [rows, n]
  const void* win;   // [nwin, n], T
  double* autoc;     // [rows, nwin, L+1]
  long long* fsums;  // [rows, 5] (fixed only)
  double* scratch;   // [rows, nseg, nwin * (L+1) + 5] partials (nseg > 1)
  int* tickets;      // [rows] zeros (nseg > 1)
  int n, max_lag, nwin, fixed, wide, seg, nseg;
};

// Shared memory of a block: the windowed values and the samples of its
// segment, each with the halo.
template <typename T, int MAXLAG>
constexpr int smem_bytes(int seg) {
  return (MAXLAG + 4 + seg) * (int)(sizeof(T) + sizeof(int32_t));
}

// zigzag(v) of a difference as the sums add it: unsigned, < 2^30 on the
// int32 route, < 2^37 on the int64 one.
__device__ __forceinline__ long long zigzag_sum(int32_t v) {
  return (uint32_t)flacx::zigzag32(v);
}
__device__ __forceinline__ long long zigzag_sum(long long v) {
  return (long long)(((unsigned long long)v << 1) ^
                     (unsigned long long)(v >> 63));
}

// A run's fixed-order sums from x[i0 - 4 .. i0 + RUN - 1] (xs from c - 4):
// the o-th differences in D (int32, or int64 on the wide route) by the
// chain d_o[i] = d_{o-1}[i] - d_{o-1}[i-1], their zigzags added.  EDGE:
// the run meets the row's start (no D^o x[i] for i < o) or its end.
template <typename D, bool EDGE>
__device__ __forceinline__ void fixed_sums(const int32_t* xs, int i0, int n,
                                           long long (&fs)[5]) {
  D d0[RUN + 4];
#pragma unroll
  for (int k = 0; k < RUN + 4; ++k) d0[k] = xs[k];
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    const int i = i0 + r;
    if (EDGE && i >= n) break;
    const D a0 = d0[r + 4], a1 = d0[r + 3], a2 = d0[r + 2];
    const D a3 = d0[r + 1], a4 = d0[r];
    const D d10 = a0 - a1, d11 = a1 - a2, d12 = a2 - a3, d13 = a3 - a4;
    const D d20 = d10 - d11, d21 = d11 - d12, d22 = d12 - d13;
    const D d30 = d20 - d21, d31 = d21 - d22;
    const D d40 = d30 - d31;
    const D d[5] = {a0, d10, d20, d30, d40};
#pragma unroll
    for (int o = 0; o < 5; ++o)
      if (!EDGE || i >= o) fs[o] += zigzag_sum(d[o]);
  }
}

template <typename D>
__device__ __forceinline__ void fixed_run(const int32_t* xs, int i0, int n,
                                          long long (&fs)[5]) {
  if (i0 >= 4 && i0 + RUN <= n)
    fixed_sums<D, false>(xs, i0, n, fs);
  else
    fixed_sums<D, true>(xs, i0, n, fs);
}

template <typename T, int MAXLAG>
__global__ void __launch_bounds__(THREADS) analysis_kernel(Args a) {
  constexpr int HALO = MAXLAG + 4;  // >= max(MAXLAG, 4)
  constexpr int V = MAXLAG < 16 ? 16 : 32;  // lags of the butterfly
  static_assert(MAXLAG < V || MAXLAG == V, "lag 32 is summed apart");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem);                      // [HALO + seg]
  int32_t* xs = reinterpret_cast<int32_t*>(ws + HALO + a.seg);
  __shared__ double red_d[WARPS][MAXLAG + 1];
  __shared__ long long red_i[WARPS][5];
  __shared__ bool last;

  const int row = blockIdx.x / a.nseg, sg = blockIdx.x % a.nseg;
  const int n = a.n, s0 = sg * a.seg;
  const int m = min(a.seg, n - s0);              // samples of the segment
  const int passes = (m + PASS - 1) / PASS;
  const int32_t* xr = a.x + (size_t)row * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = a.nwin * (a.max_lag + 1) + 5;
  double* part =  // this segment's partials (a row of several segments)
      a.nseg > 1 ? a.scratch + ((size_t)row * a.nseg + sg) * stride : nullptr;

  for (int j = threadIdx.x; j < HALO + m; j += THREADS) {
    const int i = s0 - HALO + j;
    xs[j] = i >= 0 ? xr[i] : 0;
  }

  for (int w = 0; w < a.nwin; ++w) {
    const T* wr = static_cast<const T*>(a.win) + (size_t)w * n;
    const bool fixed = a.fixed && w == 0;
    __syncthreads();  // the staged samples; the last window's readers
    for (int j = threadIdx.x; j < HALO + passes * PASS; j += THREADS) {
      const int i = s0 - HALO + j;
      ws[j] = i >= 0 && i < n - 1 ? mul_rn(from_int<T>(xs[j]), wr[i]) : T(0);
    }
    __syncthreads();

    double acc[V], top = 0.0;  // lags 0 .. V-1 (0 past MAXLAG), lag 32
    long long fs[5];
#pragma unroll
    for (int l = 0; l < V; ++l) acc[l] = 0.0;
#pragma unroll
    for (int o = 0; o < 5; ++o) fs[o] = 0;

    for (int p = 0; p < passes; ++p) {
      const int c = HALO + p * PASS + threadIdx.x * RUN;  // the run's start
      T own[RUN];
#pragma unroll
      for (int r = 0; r < RUN; ++r) own[r] = ws[c + r];
      // each value of w[c - MAXLAG .. c + RUN - 1] read once, multiplied
      // by every sample of the run it is a lag of
#pragma unroll
      for (int k = -MAXLAG; k < RUN; ++k) {
        const T v = k < 0 ? ws[c + k] : own[k];
#pragma unroll
        for (int r = k < 0 ? 0 : k; r < RUN; ++r)
          if (r - k < V && r - k <= MAXLAG)
            acc[r - k] = __dadd_rn(acc[r - k], (double)mul_rn(v, own[r]));
          else if (r - k == MAXLAG)
            top = __dadd_rn(top, (double)mul_rn(v, own[r]));
      }
      if (fixed) {
        const int i0 = s0 + (c - HALO);  // the run's row position
        if (a.wide)
          fixed_run<long long>(xs + c - 4, i0, n, fs);
        else
          fixed_run<int32_t>(xs + c - 4, i0, n, fs);
      }
    }

    // the block's sums: a butterfly over each warp, then the warps in order
    {
      const double s = flacx::reduce_scatter<V>(acc, lane, flacx::AddRn{});
      const int lag = V == 16 ? lane >> 1 : lane;
      if ((V == 32 || !(lane & 1)) && lag <= MAXLAG) red_d[warp][lag] = s;
      if (MAXLAG == V) {
        const double v = flacx::warp_sum(top);
        if (lane == 0) red_d[warp][MAXLAG] = v;
      }
    }
    if (fixed) {
#pragma unroll
      for (int o = 0; o < 5; ++o) {
        const long long v = flacx::warp_sum(fs[o]);
        if (lane == 0) red_i[warp][o] = v;
      }
    }
    __syncthreads();
    const int t = threadIdx.x;
    if (t <= a.max_lag) {
      double s = red_d[0][t];
      for (int q = 1; q < WARPS; ++q) s = __dadd_rn(s, red_d[q][t]);
      if (a.nseg == 1)
        a.autoc[((size_t)row * a.nwin + w) * (a.max_lag + 1) + t] = s;
      else
        __stcg(part + w * (a.max_lag + 1) + t, s);
    } else if (fixed && t >= 64 && t < 69) {
      const int o = t - 64;
      long long s = 0;
      for (int q = 0; q < WARPS; ++q) s += red_i[q][o];
      if (a.nseg == 1)
        a.fsums[(size_t)row * 5 + o] = s;
      else
        __stcg(part + a.nwin * (a.max_lag + 1) + o, __longlong_as_double(s));
    }
  }
  if (a.nseg == 1) return;

  // ----- the row's last block adds the segments' partials in order -------
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.tickets + row, 1) == a.nseg - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const double* rp = a.scratch + (size_t)row * a.nseg * stride;
  const int lags = a.nwin * (a.max_lag + 1);
  for (int e = threadIdx.x; e < lags + (a.fixed ? 5 : 0); e += THREADS) {
    if (e < lags) {
      double s = __ldcg(rp + e);
      for (int q = 1; q < a.nseg; ++q)
        s = __dadd_rn(s, __ldcg(rp + q * stride + e));
      a.autoc[(size_t)row * lags + e] = s;
    } else {
      long long s = 0;
      for (int q = 0; q < a.nseg; ++q)
        s += __double_as_longlong(__ldcg(rp + q * stride + e));
      a.fsums[(size_t)row * 5 + (e - lags)] = s;
    }
  }
}

template <typename T, int MAXLAG>
int launch(const Args& a, int rows, cudaStream_t stream) {
  static int allowed[flacx::MAX_DEVICES];  // opted-in bytes, per device
  const int smem = smem_bytes<T, MAXLAG>(a.seg);
  const cudaError_t e =
      flacx::allow_smem(analysis_kernel<T, MAXLAG>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  analysis_kernel<T, MAXLAG><<<rows * a.nseg, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int rows, cudaStream_t stream) {
  return a.max_lag <= 12 ? launch<T, 12>(a, rows, stream)
                         : launch<T, 32>(a, rows, stream);
}

}  // namespace

// x int32 [rows, n], win [nwin, n] (f32, or f64 when f64 != 0) -> autoc
// f64 [rows, nwin, max_lag+1] and, when fixed != 0, fsums int64 [rows,
// 5], the differences in int64 when wide != 0.  seg:
// the samples of a segment (a multiple of 1152, at most 4608); past one
// segment a row, scratch holds rows x nseg x (nwin * (max_lag+1) + 5)
// doubles and tickets rows zeros.  Returns the CUDA error code of the
// launch.
FLACX_API int flacx_analysis(const int32_t* x, const void* win,
                             double* autoc, long long* fsums, double* scratch,
                             int* tickets, int rows, int n, int max_lag,
                             int nwin, int f64, int fixed, int wide,
                             int seg, cudaStream_t stream) {
  if (rows <= 0 || n < 2 || max_lag < 0 || max_lag > 32 || nwin < 1 ||
      (fixed && fsums == nullptr) || seg <= 0 || seg % PASS ||
      seg > SEG_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int nseg = (n + seg - 1) / seg;
  if (nseg > 1 && (!scratch || !tickets)) return (int)cudaErrorInvalidValue;
  const Args a{x,       win,  autoc, fsums, scratch, tickets, n,
               max_lag, nwin, fixed, wide,  seg,     nseg};
  return f64 ? launch<double>(a, rows, stream)
             : launch<float>(a, rows, stream);
}
