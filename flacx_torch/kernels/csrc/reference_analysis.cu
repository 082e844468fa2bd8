// reference_analysis: conformance mode's analysis (the reference encoder's
// parameter choices, reproduced bit for bit) in two kernels.
//
// reference_lpc, one block a row, P = max_order:
//   w[j]     = (double) x[j] * window[j]                        (rounded)
//   autoc[l] = ((w[0] w[l] + w[1] w[1+l]) + ...) + w[n-2-l] w[n-2],
//              added strictly left to right, l = 0..P (the reference's
//              range drops each lag's last product);
//   then the reference's Levinson-Durbin over autoc (every order from one
//   recursion: each order's run repeats the same ops over the shared
//   prefix) and its error-feedback quantization of every order, with
//   floor(log2(.)) as the JAX package computes it (flacx_torch.conformance
//   .floor_log2).  qcoefs and shift are zero where valid is false.
// abs_residual_sums, a grid over (segment, row):
//   fsum[o] = sum_{i >= o}   |x[i] - sum_j F_o[j] x[i-1-j]|            o < 5
//   lsum[o] = sum_{i >= o+1} |x[i] - (sum_j q_o[j] x[i-1-j] >> s_o)|   o < P
//   with F_o the fixed predictors; the residuals are never written.
//
// Replaces the XLA of flacx/conformance.py:325-329 (reference_lpc: the
// window product, ordered_autocorr, levinson_reference,
// quantize_reference) and :307-319, :330-333 (abs_residual_sums: the fixed
// and LPC residuals and their sums of |res|); the JAX package has no
// pallas_call there.
//
// Trouble spots:
// * FMA contraction.  nvcc contracts a*b + c into one fused multiply-add
//   by default, rounding once where the reference rounds twice.  Every f64
//   multiply, add, subtract and divide of the chain is an explicit
//   __dmul_rn / __dadd_rn / __dsub_rn / __ddiv_rn, which are never
//   contracted; the build's global flags stay as they are.
// * Order.  Each lag's sum is one chain of n - 1 dependent adds in the
//   reference's order: it cannot become a tree sum.  One thread a lag.
// * floor_log2's round-up branch (x a hair under a power of two): frexp,
//   delta = -log1p(m - 1) / ln 2 against half an ulp of the exponent, and
//   2^k from the exponent bits, exactly (the oracle's 1 << shift).
// * Sign convention.  The Levinson rows are used as they come: the
//   reference's a[1:] predicts x[i] from sum_j a[j] x[i-1-j].
// * NaN.  The JAX package's max propagates it, fmax would drop it; a row
//   that is not finite is invalid, and its coefficients are written as 0.
//
// Bound on the card.  reference_lpc: the larger of the bytes (x read once,
// the outputs written once; 37.9 MB at the headline's 2048 rows of 4608,
// 11 us at 3.35 TB/s) and the chain of n - 1 dependent f64 adds, one add
// latency each, every row's in parallel (4607 at the headline; the
// Levinson recursion's P^2 chain is not counted).  abs_residual_sums:
// operations, one multiply-add a nonzero tap of each predictor and sample
// (10 + P(P+1)/2 a sample: 88 at P = 12) and the residual's shift,
// subtract, abs and add.
//
// Design.  reference_lpc: one block of LPC_THREADS threads a row.  The
// block stages tiles of TILE windowed samples (and the MAX_ORDER after
// them, which a tile's last terms reach) in shared memory as f64, every
// thread's loads in flight before its stores; thread l <= P walks the tile
// adding w[j] * w[j+l] (w[j] a broadcast, w[j+l] consecutive across the
// lags).  Thread 0 then runs the Levinson recursion and stores each
// order's row in shared memory (over the tile); thread o quantizes order
// o.  A block holds 8.7 KB of shared memory: the headline's 2048 rows run
// in one wave.
// abs_residual_sums: the grid of lpc_residual.cu: each block stages its
// segment (up to 2304 samples) in shared memory with a 32-sample halo
// (zero before the row start); each thread takes runs of RUN consecutive
// samples a pass (RUN odd: a warp's strided reads hit distinct banks).
// For each predictor in turn (the five fixed ones, then the LPC orders)
// the taps sit in registers under a fully unrolled loop of the bucket (4,
// 8, 12, 16, 24 or 32 taps) that covers its order, the run's window of
// samples in registers too; the thread's sum of |res| is reduced in its
// warp and added into the block's shared sum of that predictor.  A row of
// several segments adds its blocks' sums by integer atomics into outputs
// the wrapper zeroes: the same bits in any order.  MAC: int32 (in
// unsigned arithmetic) under the static bound the wrapper checks
// (lpc_residual.mac_width), else int64.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int MAX_ORDER = 32;
constexpr int NLAG = MAX_ORDER + 1;
constexpr double LN2 = 0.6931471805599453;  // math.log(2.0)

// ---- reference_lpc -------------------------------------------------------

constexpr int LPC_THREADS = 64;
constexpr int TILE = 1024;
constexpr int LPC_STAGE = (TILE + MAX_ORDER + LPC_THREADS - 1) / LPC_THREADS;

// 2^e exactly, for e in [-1022, 1023].
__device__ __forceinline__ double pow2(int e) {
  return __longlong_as_double((long long)(e + 1023) << 52);
}

// floor(log2(x)) of a positive f64, as flacx_torch.conformance.floor_log2.
__device__ int floor_log2(double x) {
  int e;
  const double m = frexp(x, &e);  // x = m * 2^e, m in [0.5, 1)
  const double delta = __ddiv_rn(-log1p(__dsub_rn(m, 1.0)), LN2);
  const int fl = 31 - __clz(max(abs(e), 1));  // floor(log2(|e|))
  const bool up = e != 0 && delta < pow2(fl - 53);
  return e - 1 + (up ? 1 : 0);
}

__global__ void __launch_bounds__(LPC_THREADS)
    reference_lpc_kernel(const int32_t* __restrict__ x,
                         const double* __restrict__ window,
                         double* __restrict__ autoc,
                         int32_t* __restrict__ qcoefs,
                         int32_t* __restrict__ shift,
                         uint8_t* __restrict__ valid, int n, int p,
                         int precision) {
  // the staged tile, then (once every chain is done) the Levinson rows
  static_assert(TILE + MAX_ORDER >= MAX_ORDER * MAX_ORDER, "taps fit");
  __shared__ double ws[TILE + MAX_ORDER];
  double(*taps)[MAX_ORDER] = reinterpret_cast<double(*)[MAX_ORDER]>(ws);
  __shared__ double ac[NLAG];
  __shared__ bool vld[MAX_ORDER];
  const int row = blockIdx.x, l = threadIdx.x;
  const int32_t* xr = x + (size_t)row * n;

  // the autocorrelation: lag l's chain in thread l, tile by tile
  double acc = 0.0;
  for (int t0 = 0; t0 < n - 1; t0 += TILE) {
    int32_t xv[LPC_STAGE];
    double wv[LPC_STAGE];
#pragma unroll
    for (int q = 0; q < LPC_STAGE; ++q) {
      const int j = t0 + threadIdx.x + q * LPC_THREADS;
      xv[q] = j < n ? xr[j] : 0;
      wv[q] = j < n ? window[j] : 0.0;
    }
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int q = 0; q < LPC_STAGE; ++q) {
      const int i = threadIdx.x + q * LPC_THREADS;
      if (i < TILE + MAX_ORDER) ws[i] = __dmul_rn((double)xv[q], wv[q]);
    }
    __syncthreads();
    if (l <= p) {
      const int end = min(TILE, n - 1 - l - t0);  // terms j <= n - 2 - l
#pragma unroll 8
      for (int k = 0; k < end; ++k)
        acc = __dadd_rn(acc, __dmul_rn(ws[k], ws[k + l]));
    }
  }
  if (l <= p) {
    ac[l] = acc;
    autoc[(size_t)row * (p + 1) + l] = acc;
  }
  __syncthreads();

  // Levinson-Durbin, the reference's op order, one thread
  if (threadIdx.x == 0) {
    double a[NLAG];
    a[0] = 1.0;
    for (int j = 1; j <= p; ++j) a[j] = 0.0;
    double err = ac[0];
    bool ok = true;
    for (int k = 0; k < p; ++k) {
      ok = ok && err != 0.0;
      const double safe = err != 0.0 ? err : 1.0;
      double lam = 0.0;
      for (int j = 0; j <= k; ++j)
        lam = __dsub_rn(lam, __dmul_rn(a[j], ac[k + 1 - j]));
      lam = __ddiv_rn(lam, safe);
      for (int i = 0; i <= (k + 1) / 2; ++i) {
        const double tmp = __dadd_rn(a[k + 1 - i], __dmul_rn(lam, a[i]));
        a[i] = __dadd_rn(a[i], __dmul_rn(lam, a[k + 1 - i]));
        a[k + 1 - i] = tmp;
      }
      err = __dmul_rn(err, __dsub_rn(1.0, __dmul_rn(lam, lam)));
      bool fin = ok;
      for (int j = 0; j < p; ++j) {  // a[j > k+1] are still zero
        taps[k][j] = a[j + 1];
        fin = fin && isfinite(a[j + 1]);
      }
      vld[k] = fin;
    }
  }
  __syncthreads();

  // error-feedback quantization, one thread an order
  if (threadIdx.x < p) {
    const int o = threadIdx.x;
    const double* t = taps[o];
    double cmax = 0.0;
    bool nan = false;
    for (int j = 0; j < p; ++j) {
      const double v = fabs(t[j]);
      nan = nan || isnan(v);
      cmax = v > cmax ? v : cmax;
    }
    const bool pos = !nan && cmax > 0.0;
    int sh = min(precision - floor_log2(pos ? cmax : 1.0) - 2, 15);
    // negative shift: scale down, emit shift 0 (the oracle's fix)
    const double scale = sh >= 0 ? pow2(sh) : __ddiv_rn(1.0, pow2(-sh));
    const bool keep = vld[o] && pos;
    const double qmax = (double)((1 << (precision - 1)) - 1);
    const double qmin = -(double)(1 << (precision - 1));
    double err = 0.0;
    int32_t* qo = qcoefs + ((size_t)row * p + o) * p;
    for (int j = 0; j < p; ++j) {
      int32_t q = 0;
      if (keep && j <= o) {
        err = __dadd_rn(err, __dmul_rn(t[j], scale));
        const double qd = fmin(fmax(rint(err), qmin), qmax);  // half even
        err = __dsub_rn(err, qd);
        q = (int32_t)qd;
      }
      qo[j] = q;
    }
    shift[(size_t)row * p + o] = keep ? max(sh, 0) : 0;
    valid[(size_t)row * p + o] = vld[o];
  }
}

// ---- abs_residual_sums ---------------------------------------------------

constexpr int THREADS = 128;
constexpr int RUN = 9;                // consecutive residuals of a thread
constexpr int PASS = THREADS * RUN;   // samples of a block's pass: 1152
constexpr int SEG_MAX = 2 * PASS;     // the wrapper's SEG_MAX
constexpr int HALO = 32;
constexpr int STAGE = (HALO + SEG_MAX + THREADS - 1) / THREADS;
constexpr int NPRED = 5 + MAX_ORDER;  // the fixed predictors, then LPC

__constant__ int32_t FIXED_TAPS[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1}};

struct SumArgs {
  const int32_t* x;       // [rows, n]
  const int32_t* qcoefs;  // [rows, p, p]
  const int32_t* qshift;  // [rows, p]
  long long* fsum;        // [rows, 5]
  long long* lsum;        // [rows, p]
  int n, p, seg, nseg;
};

// The thread's sum of |res| over its runs of the segment (m samples from
// row position s0) under the NT taps tq (zero past the order), shift sh,
// residuals zero at row positions below ord.
template <bool WIDE, int NT>
__device__ __forceinline__ long long order_sum(const int32_t* xs,
                                               const int32_t* tq, int sh,
                                               int ord, int s0, int m) {
  int32_t tr[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) tr[k] = tq[k];
  long long s = 0;
  const int passes = (m + PASS - 1) / PASS;
  for (int q = 0; q < passes; ++q) {
    const int c = q * PASS + threadIdx.x * RUN;  // the run's segment index
    int32_t win[NT + RUN];                       // x[c - NT .. c + RUN - 1]
#pragma unroll
    for (int k = 0; k < NT + RUN; ++k) win[k] = xs[HALO + c - NT + k];
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      long long res;
      if (WIDE) {
        long long acc = 0;
#pragma unroll
        for (int k = 0; k < NT; ++k)
          acc += (long long)tr[k] * win[NT + r - 1 - k];
        res = (long long)win[NT + r] - (acc >> sh);
      } else {
        uint32_t acc = 0;
#pragma unroll
        for (int k = 0; k < NT; ++k)
          acc += (uint32_t)tr[k] * (uint32_t)win[NT + r - 1 - k];
        res = win[NT + r] - ((int32_t)acc >> sh);
      }
      if (c + r < m && s0 + c + r >= ord) s += res < 0 ? -res : res;
    }
  }
  return s;
}

template <bool WIDE>
__device__ long long predictor_sum(const int32_t* xs, const int32_t* tq,
                                   int nt, int sh, int ord, int s0, int m) {
  if (nt <= 4) return order_sum<WIDE, 4>(xs, tq, sh, ord, s0, m);
  if (nt <= 8) return order_sum<WIDE, 8>(xs, tq, sh, ord, s0, m);
  if (nt <= 12) return order_sum<WIDE, 12>(xs, tq, sh, ord, s0, m);
  if (nt <= 16) return order_sum<WIDE, 16>(xs, tq, sh, ord, s0, m);
  if (nt <= 24) return order_sum<WIDE, 24>(xs, tq, sh, ord, s0, m);
  return order_sum<WIDE, 32>(xs, tq, sh, ord, s0, m);
}

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
    abs_residual_sums_kernel(SumArgs a) {
  __shared__ int32_t xs[HALO + SEG_MAX];
  __shared__ int32_t tq[NPRED][MAX_ORDER];
  __shared__ int32_t sh_s[MAX_ORDER];
  __shared__ unsigned long long red[NPRED];

  const int row = blockIdx.x / a.nseg, sg = blockIdx.x % a.nseg;
  const int n = a.n, p = a.p, s0 = sg * a.seg;
  const int m = min(a.seg, n - s0);  // samples of the segment
  const int32_t* xr = a.x + (size_t)row * n;
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
      if (j < HALO + SEG_MAX) xs[j] = v[q];
    }
  }
  for (int i = threadIdx.x; i < NPRED * MAX_ORDER; i += THREADS) {
    const int o = i / MAX_ORDER, j = i % MAX_ORDER;
    int32_t v = 0;
    if (o < 5)
      v = j < 4 ? FIXED_TAPS[o][j] : 0;
    else if (o - 5 < p && j < p)
      v = a.qcoefs[((size_t)row * p + (o - 5)) * p + j];
    tq[o][j] = v;
  }
  for (int i = threadIdx.x; i < p; i += THREADS)
    sh_s[i] = a.qshift[(size_t)row * p + i];
  for (int i = threadIdx.x; i < NPRED; i += THREADS) red[i] = 0;
  __syncthreads();

  for (int o = 0; o < 5 + p; ++o) {
    const bool fixed = o < 5;
    const int ord = fixed ? o : o - 4;  // LPC predictor o - 5 has order o - 4
    const long long s = predictor_sum<WIDE>(
        xs, tq[o], fixed ? 4 : ord, fixed ? 0 : sh_s[o - 5], ord, s0, m);
    const long long w = flacx::warp_sum(s);
    if ((threadIdx.x & 31) == 0) atomicAdd(&red[o], (unsigned long long)w);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 5 + p; o += THREADS) {
    long long* out = o < 5 ? a.fsum + (size_t)row * 5 + o
                           : a.lsum + (size_t)row * p + (o - 5);
    if (a.nseg == 1)
      *out = (long long)red[o];
    else
      atomicAdd(reinterpret_cast<unsigned long long*>(out), red[o]);
  }
}

// ---- floor_log2 alone, for the card tests ------------------------------------

__global__ void floor_log2_kernel(const double* x, int32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = floor_log2(x[i]);
}

// ---- the add latency probe -------------------------------------------------

__global__ void dadd_chain_kernel(double* out, int steps) {
  double v = out[0];
  const double d = __dmul_rn(v, 0x1p-40);
#pragma unroll 16
  for (int i = 0; i < steps; ++i) v = __dadd_rn(v, d);
  out[0] = v;
}

}  // namespace

// x int32 [rows, n], window f64 [n] -> autoc f64 [rows, p+1], qcoefs int32
// [rows, p, p], shift int32 [rows, p], valid u8 [rows, p]; 1 <= p <=
// min(32, n - 1), 2 <= precision <= 15.
FLACX_API int flacx_reference_lpc(const int32_t* x, const double* window,
                                  double* autoc, int32_t* qcoefs,
                                  int32_t* shift, uint8_t* valid, int rows,
                                  int n, int p, int precision,
                                  cudaStream_t stream) {
  if (rows <= 0 || p < 1 || p > MAX_ORDER || n < p + 1 || precision < 2 ||
      precision > 15)
    return (int)cudaErrorInvalidValue;
  reference_lpc_kernel<<<rows, LPC_THREADS, 0, stream>>>(
      x, window, autoc, qcoefs, shift, valid, n, p, precision);
  return (int)cudaGetLastError();
}

// x int32 [rows, n], qcoefs int32 [rows, p, p], qshift int32 [rows, p] ->
// fsum int64 [rows, 5], lsum int64 [rows, p]; wide != 0 takes the int64
// MAC; seg: the samples of a segment (a multiple of 1152, at most 2304);
// past one segment a row, fsum and lsum must hold zeros.
FLACX_API int flacx_abs_residual_sums(const int32_t* x, const int32_t* qcoefs,
                                      const int32_t* qshift, long long* fsum,
                                      long long* lsum, int rows, int n, int p,
                                      int wide, int seg,
                                      cudaStream_t stream) {
  if (rows <= 0 || n < 1 || p < 0 || p > MAX_ORDER || seg <= 0 ||
      seg % PASS || seg > SEG_MAX)
    return (int)cudaErrorInvalidValue;
  const SumArgs a{x, qcoefs, qshift, fsum, lsum, n, p, seg,
                  (n + seg - 1) / seg};
  if (wide)
    abs_residual_sums_kernel<true><<<rows * a.nseg, THREADS, 0, stream>>>(a);
  else
    abs_residual_sums_kernel<false><<<rows * a.nseg, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// out[i] = floor_log2(x[i]) (reference_lpc's), for positive finite x.
FLACX_API int flacx_floor_log2(const double* x, int32_t* out, int n,
                               cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  floor_log2_kernel<<<(n + 255) / 256, 256, 0, stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

// One thread adds `steps` times in one dependent chain into out[0].
FLACX_API int flacx_dadd_chain(double* out, int steps, cudaStream_t stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  dadd_chain_kernel<<<1, 1, 0, stream>>>(out, steps);
  return (int)cudaGetLastError();
}
