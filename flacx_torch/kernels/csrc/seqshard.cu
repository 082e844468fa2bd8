// seqshard: the shard-local statistics of sample-axis (sequence) sharding,
// every shard of a span of a row in one launch.
//
// Replaces the shard-local bodies of the JAX package's sequence sharding,
// which it runs as XLA under shard_map (no Pallas kernel):
//   autocorr  flacx/parallel/seqshard.py:47-67  (autocorrelate_sharded)
//   fixed     flacx/parallel/seqshard.py:110-121 (fixed_order_zz_sums_sharded)
//   lpc       flacx/parallel/seqshard.py:152-167 (lpc_zz_stats_sharded)
//
// A span is `shards` contiguous shards of `local` samples of each row
// ([rows, m], m = shards * local); its first shard is shard `shard0` of
// the whole row, so sample j of shard s sits at the global index
// jg = (shard0 + s) * local + j.  Each shard takes a halo of H samples
// from its neighbour, read in place inside the span and from `halo`
// ([rows, H]) across the span's edge, or zeros where `halo` is null (the
// row's end): what the JAX package's ppermute carries is just these
// samples.  Semantics (flacx_torch.kernels.seqshard.seq_*_plain):
//   autocorr  H = max_lag <= 32, the NEXT shard's first samples; T = float
//             or double, products in T (__fmul_rn / __dmul_rn), summed in
//             f64 (__dadd_rn): out[r, s, l] = sum over the shard's jg <=
//             n - l - 2 of T(x[jg] * x[jg + l]); out f64 [rows, shards, L+1].
//   fixed     H = 4, the PREVIOUS shard's last samples; D^o x for o = 0..4
//             in the input's type (int32 or int64, wrapping), zigzag in
//             that type, summed as int64 over jg >= o; out int64
//             [rows, shards, 5].
//   lpc       H = t <= 32, the PREVIOUS shard's last samples; int32 x and
//             taps, an int64 MAC acc = sum_k taps[k] x[jg - 1 - k]
//             (wrapping), res = x - (acc >> shift), masked to jg >= order;
//             out int64 [rows, shards, 2]: sum of (res << 1) ^ (res >> 63)
//             and max |res| (unclamped, in int64; a masked sample counts 0).
// Integer sums wrap as the int64 sums of the plain version do, so every
// integer output is bit-exact; the f64 sums differ from the plain version
// only in summation order, which is fixed (the same bits on every run).
//
// Bound on the card, at the hi-res rows (256 x 16384, lag 32): autocorr
// by operations, max_lag + 1 products and f64 adds a sample, the adds at
// the f64 rate (64 per clock per SM, 0.0083 ms) and the f32 products at
// the scalar rate (0.0021 ms), against 0.0050 ms for the bytes.  fixed
// (about 35 integer operations a sample) and lpc (one 32 x 32 -> 64-bit
// multiply-add a sample and nonzero tap) by their bytes, 0.0050 ms.  The
// partial sums written are a few hundred bytes a row.
//
// Design (simple first): one block of 256 threads per (row, shard).  The
// block walks its shard in tiles of TILE samples: it stages the tile and
// its H-sample halo (after it for autocorr, before it for fixed and lpc)
// in shared memory, coalesced, each value read once from device memory,
// then thread i takes samples i, i + 256, ... of the tile and keeps its
// partial sums in registers (L + 1 doubles, 5 or 2 integers).  The lpc
// MAC runs up to the row's last nonzero tap (zero taps add nothing).
// After the last tile the block reduces its sums (shuffles in each warp,
// then the warps in order) and writes its shard's row of partials.  The
// sum over shards is the caller's (the JAX package's psum / pmax).

#include <climits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 2048;  // samples of a shard staged at a time
constexpr int MAXH = 32;    // the widest halo (lags, taps)

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

__device__ __forceinline__ double warp_sum_rn(double v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_down_sync(flacx::FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ unsigned long long warp_sum_u64(
    unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_down_sync(flacx::FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ long long warp_max_i64(long long v) {
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_down_sync(flacx::FULL_MASK, v, o));
  return v;
}

// The value at span index j of row `xr` (the span's m samples, then the
// halo hr of `h` samples after it, or `h` before it when `before`): in
// place inside the span, from the halo across its edge, zero without one.
template <typename T>
__device__ __forceinline__ T span_at(const T* xr, const T* hr, long long j,
                                     int m, int h, bool before) {
  if (j >= 0 && j < m) return xr[j];
  if (!hr) return T(0);
  return before ? hr[h + j] : hr[j - m];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
seq_autocorr_kernel(const T* __restrict__ x, const T* __restrict__ halo,
                    double* __restrict__ out, int m, int shards, int shard0,
                    int n, int L) {
  __shared__ T ext[TILE + MAXH];
  __shared__ double part[WARPS][MAXH + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x / shards, s = blockIdx.x % shards;
  const int local = m / shards;
  const T* xr = x + (long long)row * m;
  const T* hr = halo ? halo + (long long)row * L : nullptr;
  const long long g0 = (long long)(shard0 + s) * local;
  double acc[MAXH + 1];
#pragma unroll
  for (int l = 0; l <= MAXH; ++l) acc[l] = 0.0;

  for (int t0 = 0; t0 < local; t0 += TILE) {
    const int cnt = min(TILE, local - t0);
    const long long base = (long long)s * local + t0;
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < cnt + L; i += THREADS)
      ext[i] = span_at(xr, hr, base + i, m, L, false);
    __syncthreads();
    for (int i = tid; i < cnt; i += THREADS) {
      const long long last = (long long)n - 2 - (g0 + t0 + i);  // lags <= it
      const T a = ext[i];
#pragma unroll
      for (int l = 0; l <= MAXH; ++l)
        if (l <= L && l <= last)
          acc[l] = __dadd_rn(acc[l], (double)mul_rn(a, ext[i + l]));
    }
  }
#pragma unroll
  for (int l = 0; l <= MAXH; ++l) {
    if (l <= L) {
      const double v = warp_sum_rn(acc[l]);
      if (lane == 0) part[warp][l] = v;
    }
  }
  __syncthreads();
  if (tid <= L) {
    double v = part[0][tid];
    for (int w = 1; w < WARPS; ++w) v = __dadd_rn(v, part[w][tid]);
    out[((long long)row * shards + s) * (L + 1) + tid] = v;
  }
}

template <typename T, typename U>
__global__ void __launch_bounds__(THREADS)
seq_fixed_kernel(const T* __restrict__ x, const T* __restrict__ halo,
                 long long* __restrict__ out, int m, int shards, int shard0) {
  constexpr int H = 4, BITS = 8 * sizeof(T);
  __shared__ T ext[H + TILE];
  __shared__ unsigned long long part[WARPS][5];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x / shards, s = blockIdx.x % shards;
  const int local = m / shards;
  const T* xr = x + (long long)row * m;
  const T* hr = halo ? halo + (long long)row * H : nullptr;
  const long long g0 = (long long)(shard0 + s) * local;
  unsigned long long acc[5] = {0, 0, 0, 0, 0};

  for (int t0 = 0; t0 < local; t0 += TILE) {
    const int cnt = min(TILE, local - t0);
    const long long base = (long long)s * local + t0 - H;
    __syncthreads();
    for (int i = tid; i < cnt + H; i += THREADS)
      ext[i] = span_at(xr, hr, base + i, m, H, true);
    __syncthreads();
    for (int i = tid; i < cnt; i += THREADS) {
      const long long jg = g0 + t0 + i;
      U v[H + 1];  // x[jg], x[jg-1], ..., x[jg-4]
#pragma unroll
      for (int k = 0; k <= H; ++k) v[k] = (U)ext[i + H - k];
#pragma unroll
      for (int o = 0; o <= H; ++o) {
        const T d = (T)v[0];  // D^o x[jg], wrapped to the input's type
        const T zz = (T)(((U)d << 1) ^ (U)(d >> (BITS - 1)));
        if (jg >= o) acc[o] += (unsigned long long)(long long)zz;
#pragma unroll
        for (int k = 0; k < H - o; ++k) v[k] -= v[k + 1];
      }
    }
  }
#pragma unroll
  for (int o = 0; o < 5; ++o) {
    const unsigned long long v = warp_sum_u64(acc[o]);
    if (lane == 0) part[warp][o] = v;
  }
  __syncthreads();
  if (tid < 5) {
    unsigned long long v = 0;
    for (int w = 0; w < WARPS; ++w) v += part[w][tid];
    out[((long long)row * shards + s) * 5 + tid] = (long long)v;
  }
}

__global__ void __launch_bounds__(THREADS)
seq_lpc_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ halo,
               const int32_t* __restrict__ taps,
               const int32_t* __restrict__ shift,
               const int32_t* __restrict__ order, long long* __restrict__ out,
               int m, int shards, int shard0, int t) {
  __shared__ int32_t ext[MAXH + TILE];
  __shared__ int32_t tap[MAXH];
  __shared__ int ntaps;
  __shared__ unsigned long long psum[WARPS];
  __shared__ long long pmax[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x / shards, s = blockIdx.x % shards;
  const int local = m / shards;
  const int32_t* xr = x + (long long)row * m;
  const int32_t* hr = halo ? halo + (long long)row * t : nullptr;
  const long long g0 = (long long)(shard0 + s) * local;
  const int sh = shift[row];
  const long long od = order[row];
  if (warp == 0) {  // MAXH == 32: one tap a lane
    const int32_t v = lane < t ? taps[(long long)row * t + lane] : 0;
    tap[lane] = v;
    const unsigned nz = __ballot_sync(flacx::FULL_MASK, v != 0);
    if (lane == 0) ntaps = 32 - __clz(nz);  // up to the last nonzero tap
  }
  unsigned long long zsum = 0;
  long long amax = LLONG_MIN;

  for (int t0 = 0; t0 < local; t0 += TILE) {
    const int cnt = min(TILE, local - t0);
    const long long base = (long long)s * local + t0 - t;
    __syncthreads();  // also orders the taps' store before their reads
    for (int i = tid; i < cnt + t; i += THREADS)
      ext[i] = span_at(xr, hr, base + i, m, t, true);
    __syncthreads();
    const int tl = ntaps;
    for (int i = tid; i < cnt; i += THREADS) {
      const int p = t + i;  // ext index of sample jg
      unsigned long long acc = 0;
#pragma unroll 4
      for (int k = 0; k < tl; ++k)
        acc += (unsigned long long)((long long)tap[k] *
                                    (long long)ext[p - 1 - k]);
      const long long pred = (long long)acc >> sh;
      const long long res =
          (long long)((unsigned long long)(long long)ext[p] -
                      (unsigned long long)pred);
      const bool keep = g0 + t0 + i >= od;
      const unsigned long long zz =
          ((unsigned long long)res << 1) ^ (unsigned long long)(res >> 63);
      const long long mag =
          (long long)(res < 0 ? 0ull - (unsigned long long)res
                              : (unsigned long long)res);
      if (keep) zsum += zz;
      amax = max(amax, keep ? mag : 0ll);
    }
  }
  zsum = warp_sum_u64(zsum);
  amax = warp_max_i64(amax);
  if (lane == 0) {
    psum[warp] = zsum;
    pmax[warp] = amax;
  }
  __syncthreads();
  if (tid == 0) {
    unsigned long long v = 0;
    long long mx = LLONG_MIN;
    for (int w = 0; w < WARPS; ++w) {
      v += psum[w];
      mx = max(mx, pmax[w]);
    }
    out[((long long)row * shards + s) * 2] = (long long)v;
    out[((long long)row * shards + s) * 2 + 1] = mx;
  }
}

bool span_ok(int rows, int m, int shards, int shard0, int h) {
  if (rows <= 0 || m <= 0 || shards <= 0 || shard0 < 0 || m % shards)
    return false;
  const int local = m / shards;
  return local >= h && (long long)rows * shards <= 2147483647LL;
}

}  // namespace

// x [rows, m] (f32, or f64 when f64), halo [rows, max_lag] or null, out
// f64 [rows, shards, max_lag + 1]; n the whole row's length.
FLACX_API int flacx_seq_autocorr(const void* x, const void* halo,
                                 double* out, int rows, int m, int shards,
                                 int shard0, int n, int max_lag, int f64,
                                 cudaStream_t stream) {
  if (!span_ok(rows, m, shards, shard0, max_lag) || max_lag < 0 ||
      max_lag > MAXH || (long long)(shard0 + shards) * (m / shards) > n)
    return (int)cudaErrorInvalidValue;
  const int blocks = rows * shards;
  if (f64)
    seq_autocorr_kernel<double><<<blocks, THREADS, 0, stream>>>(
        static_cast<const double*>(x), static_cast<const double*>(halo),
        out, m, shards, shard0, n, max_lag);
  else
    seq_autocorr_kernel<float><<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(halo), out,
        m, shards, shard0, n, max_lag);
  return (int)cudaGetLastError();
}

// x [rows, m] int32 (int64 when i64), halo [rows, 4] or null, out int64
// [rows, shards, 5].
FLACX_API int flacx_seq_fixed(const void* x, const void* halo,
                              long long* out, int rows, int m, int shards,
                              int shard0, int i64, cudaStream_t stream) {
  if (!span_ok(rows, m, shards, shard0, 4))
    return (int)cudaErrorInvalidValue;
  const int blocks = rows * shards;
  if (i64)
    seq_fixed_kernel<long long, unsigned long long>
        <<<blocks, THREADS, 0, stream>>>(
            static_cast<const long long*>(x),
            static_cast<const long long*>(halo), out, m, shards, shard0);
  else
    seq_fixed_kernel<int32_t, uint32_t><<<blocks, THREADS, 0, stream>>>(
        static_cast<const int32_t*>(x), static_cast<const int32_t*>(halo),
        out, m, shards, shard0);
  return (int)cudaGetLastError();
}

// x [rows, m] int32, halo [rows, t] or null, taps [rows, t], shift and
// order [rows] int32, out int64 [rows, shards, 2].
FLACX_API int flacx_seq_lpc(const int32_t* x, const int32_t* halo,
                            const int32_t* taps, const int32_t* shift,
                            const int32_t* order, long long* out, int rows,
                            int m, int shards, int shard0, int t,
                            cudaStream_t stream) {
  if (!span_ok(rows, m, shards, shard0, t) || t < 1 || t > MAXH)
    return (int)cudaErrorInvalidValue;
  seq_lpc_kernel<<<rows * shards, THREADS, 0, stream>>>(
      x, halo, taps, shift, order, out, m, shards, shard0, t);
  return (int)cudaGetLastError();
}
