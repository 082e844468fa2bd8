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
//             f64: out[r, s, l] = sum over the shard's jg <= n - l - 2 of
//             T(x[jg] * x[jg + l]); out f64 [rows, shards, L+1].
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
// only in summation order and, for f32 products, by the split below
// (fixed: the same bits on every run and card).
//
// Bound on the card, at the hi-res rows (256 x 16384, lag 32): autocorr
// by operations, max_lag + 1 products and f64 adds a sample, the exact
// f64 sums of f32 rows as multiply-adds at the f64 tensor-core rate (128
// per clock per SM, 0.0041 ms; f64 rows at the f64 rate, 64, 0.0083 ms)
// and the f32 products at the scalar rate (0.0021 ms), against 0.0050 ms
// for the bytes (the split sum's f32 error terms are not in the bound):
// 0.0062 ms.  fixed (about 35 integer operations a sample) and lpc (one
// 32 x 32 -> 64-bit multiply-add a sample and nonzero tap, counted as
// 8-bit limb products at the int8 tensor rate) by their bytes, 0.0050 ms.
// The partial sums written are a few hundred bytes a row.
//
// Design.  A block of P <= 4 warps a (row, shard); warp w takes a
// contiguous part of the shard of about four tiles (P and the part from
// the wrapper's `local` alone, so the f64 sums come out the same on every
// card) and walks it in tiles of TILE = 32 x RUN samples.  A tile and its
// halo (after it for autocorr, before it for fixed and lpc) are read from
// device memory by coalesced loads into registers one tile ahead, then
// stored to the warp's shared slots with one pad slot after every RUN, so
// lane i's run of RUN consecutive samples and its halo start at slot 9i:
// the lane's loads meet 32 distinct banks.  Each lane reads every value of
// its run and halo once and keeps the window in registers; only a part's
// last tile can be cut short, and only it runs a masked body:
//   autocorr  f32 products without a conversion each.  The rounding error
//             of an f32 product is exact in f32, e = fma(a, b, -fl(a b)),
//             so sum fl(a b) = sum a b - sum e exactly.  The first sum is
//             a GEMM on the f64 tensor cores (mma.sync m8n8k4, the
//             samples widened once each at staging: exact products): a
//             tile's M[a][c] = sum over its 32 runs k of x[8k + a] x[8k
//             + c] (a < 8, c < 40), and lag l's sum is sum_a M[a][a + l].
//             The second is each lane's f32 sum of its run's errors by
//             lag, folded into f64 every 64 samples of a lane after the
//             warp's 32 lane sums are added in f32 (a butterfly): under
//             (64 + 5) 2^-48 of the sum of |products| a fold.  f64 input:
//             a lane's run against the window, rounded __dmul_rn
//             products, __dadd_rn sums, 33 accumulators a lane.  The
//             n - l - 2 limit zeroes every value past global index n - 2
//             as it is staged.
//   fixed     the difference triangle of the run's first sample from the
//             4 samples before it, then D^1..D^4 carried along the run:
//             four subtractions a sample, in the input's type.
//   lpc       the taps in registers, the MAC in a compile-time bucket of
//             4, 8, 12, 16, 24 or 32 taps (the warp picks the bucket
//             holding the row's last nonzero tap; only the MAC is
//             instantiated per bucket), the int64 MAC of the run's RUN
//             residuals as the window passes: one mad.wide.s32 (32 x 32
//             -> 64 bits, added in 64) a (sample, tap).
// Each warp reduces its lanes' sums by a butterfly (a fixed order, no
// barrier), the block adds its warps' sums in warp order after one
// barrier, and writes its shard's partials.  The sum over shards is the
// caller's (the JAX package's psum / pmax).  Shared memory is static
// (under 17 KB a block), so no opt-in.

#include <climits>

#include "common.cuh"

namespace {

constexpr int RUN = 8;                // samples of a tile a lane takes
constexpr int TILE = 32 * RUN;        // samples of a tile
constexpr int MAXH = 32;              // the widest halo (lags, taps)
constexpr int MAXWARPS = 4;           // parts of a shard at most
constexpr int FLUSH_TILES = 64 / RUN; // tiles between f32 error folds

// Shared slots of a tile of TILE + H values: one pad after every RUN.
template <int H>
__host__ __device__ constexpr int slots() {
  return TILE + H + (TILE + H) / RUN + 1;
}

// The slot of lane `lane`'s value `c` (c >= 0 counted from the first value
// of its run's window): (RUN i + c) + (RUN i + c) / RUN.
__device__ __forceinline__ int slot(int lane, int c) {
  return (RUN + 1) * lane + c + c / RUN;
}

// The value at span index j of row `xr` (the span's m samples; `hr` the
// halo of `h` samples after it, or before it when `before`): in place
// inside the span, from the halo across its edge, zero past the halo.
template <typename T>
__device__ __forceinline__ T span_at(const T* __restrict__ xr,
                                     const T* __restrict__ hr, long long j,
                                     int m, int h, bool before) {
  if (j >= 0 && j < m) return xr[j];
  if (!hr) return T(0);
  if (before) return j >= -h ? hr[h + j] : T(0);
  return j - m < h ? hr[j - m] : T(0);
}

// A warp's tile in flight: the TILE + H values from span index `first`
// (the tile's first sample, less H when the halo is BEHIND), Q a lane.
template <typename T, int H>
struct Tile {
  static constexpr int N = TILE + H;
  static constexpr int Q = (N + 31) / 32;
  T v[Q];

  __device__ __forceinline__ void fetch(const T* __restrict__ xr,
                                        const T* __restrict__ hr, int h,
                                        long long first, int m, bool before,
                                        int lane) {
    if (first >= 0 && first + N <= m) {  // inside the span: plain loads
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int u = lane + 32 * q;
        v[q] = u < N ? xr[first + u] : T(0);
      }
    } else {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int u = lane + 32 * q;
        v[q] = u < N ? span_at(xr, hr, first + u, m, h, before) : T(0);
      }
    }
  }
};

// ---- autocorr --------------------------------------------------------

// A warp's shared slots for autocorr: the values in T and, for f32, the
// same widened to f64 once at staging.
template <typename T>
struct AutocSlots {
  T v[slots<MAXH>()];
  double w[sizeof(T) == 4 ? slots<MAXH>() : 1];
};

// D += A B on the f64 tensor cores, m8n8k4: a lane holds A[lane / 4][lane
// % 4], B[lane % 4][lane / 4] and D[lane / 4][2 (lane % 4) + i].
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// f32 samples, one staged tile.  The exact products on the tensor cores:
// M[a][c] += sum over the tile's 32 runs k of x[8k + a] x[8k + c] (a < 8,
// c < 40; the run's samples zero past the tile's first `cnt` when MASKED),
// so lag l's exact sum is sum_a M[a][a + l].  Then each lane's f32
// rounding errors e = fma(a, b, -fl(a b)) of its run's products, summed
// in f32 by lag.
template <bool MASKED>
__device__ __forceinline__ void autoc_tile_f32(const AutocSlots<float>& sw,
                                               int lane, int cnt,
                                               double (&m)[5][2],
                                               float (&err)[MAXH + 1]) {
  const int k = lane & 3, a = lane >> 2;
#pragma unroll
  for (int k0 = 0; k0 < 32; k0 += 4) {
    double av = sw.w[slot(k0 + k, a)];
    if (MASKED && RUN * (k0 + k) + a >= cnt) av = 0.0;
#pragma unroll
    for (int n0 = 0; n0 < 5; ++n0)
      dmma(m[n0], av, sw.w[slot(k0 + k, 8 * n0 + a)]);
  }
  float av[RUN];
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    av[r] = sw.v[slot(lane, r)];
    if (MASKED && RUN * lane + r >= cnt) av[r] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < RUN + MAXH; ++c) {
    const float b = sw.v[slot(lane, c)];
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      const int l = c - r;
      if (l >= 0 && l <= MAXH)
        err[l] = __fadd_rn(err[l], __fmaf_rn(av[r], b, -__fmul_rn(av[r], b)));
    }
  }
}

// f64 samples: a lane's run against each value of the window, rounded
// products and sums, 33 accumulators.
template <bool MASKED>
__device__ __forceinline__ void autoc_tile_f64(const AutocSlots<double>& sw,
                                               int lane, int cnt,
                                               double (&acc)[MAXH + 1]) {
  double av[RUN];
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    av[r] = sw.v[slot(lane, r)];
    if (MASKED && RUN * lane + r >= cnt) av[r] = 0.0;
  }
#pragma unroll
  for (int c = 0; c < RUN + MAXH; ++c) {
    const double b = sw.v[slot(lane, c)];
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      const int l = c - r;
      if (l >= 0 && l <= MAXH) acc[l] = __dadd_rn(acc[l], __dmul_rn(av[r], b));
    }
  }
}

// The f32 error sums of the warp folded into f64 and zeroed: each lane
// takes lag `lane`'s (lag 32 every lane), summed over the lanes in f32.
__device__ __forceinline__ void fold_errors(float (&err)[MAXH + 1], int lane,
                                            double& mine, double& last) {
  float lo[32];
#pragma unroll
  for (int l = 0; l < 32; ++l) lo[l] = err[l];
  mine = __dadd_rn(mine,
                   (double)flacx::reduce_scatter<32>(lo, lane, flacx::Add{}));
  last = __dadd_rn(last, (double)flacx::warp_all(err[MAXH], flacx::Add{}));
#pragma unroll
  for (int l = 0; l <= MAXH; ++l) err[l] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(32 * MAXWARPS)
seq_autocorr_kernel(const T* __restrict__ x, const T* __restrict__ halo,
                    double* __restrict__ out, int m, int shards, int shard0,
                    int n, int L, int per) {
  constexpr bool F32 = sizeof(T) == 4;
  __shared__ AutocSlots<T> sl[MAXWARPS];
  __shared__ double part[MAXWARPS][MAXH + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x / shards, s = blockIdx.x % shards;
  const int local = m / shards;
  const T* xr = x + (long long)row * m;
  const T* hr = halo ? halo + (long long)row * L : nullptr;
  // global index of span index 0; values past n - 2 count zero
  const long long gspan = (long long)shard0 * local;
  const int start = min(warp * per, local), end = min(start + per, local);
  AutocSlots<T>& sw = sl[warp];

  double mm[5][2] = {};            // f32: the tensor cores' M fragments
  float err[MAXH + 1] = {};        // f32: the lane's error sums by lag
  double emine = 0.0, elast = 0.0;  // f32: the folded errors
  double acc[F32 ? 1 : MAXH + 1] = {};  // f64: the lane's sums by lag
  Tile<T, MAXH> next;
  const long long j_first = (long long)s * local + start;
  if (start < end) next.fetch(xr, hr, L, j_first, m, false, lane);
  int tiles = 0;
  for (int t0 = start; t0 < end; t0 += TILE) {
    const long long j0 = (long long)s * local + t0;
    __syncwarp();  // the previous tile's reads are done
#pragma unroll
    for (int q = 0; q < Tile<T, MAXH>::Q; ++q) {
      const int u = lane + 32 * q;
      if (u < Tile<T, MAXH>::N) {
        const T v = gspan + j0 + u <= (long long)n - 2 ? next.v[q] : T(0);
        sw.v[u + u / RUN] = v;
        if (F32) sw.w[u + u / RUN] = (double)v;
      }
    }
    __syncwarp();
    if (t0 + TILE < end)
      next.fetch(xr, hr, L, j0 + TILE, m, false, lane);
    const int cnt = min(TILE, end - t0);
    if constexpr (F32) {
      if (cnt == TILE)  // warp-uniform: only a part's last tile is cut
        autoc_tile_f32<false>(sw, lane, cnt, mm, err);
      else
        autoc_tile_f32<true>(sw, lane, cnt, mm, err);
      if (++tiles == FLUSH_TILES) {
        fold_errors(err, lane, emine, elast);
        tiles = 0;
      }
    } else {
      if (cnt == TILE)
        autoc_tile_f64<false>(sw, lane, cnt, acc);
      else
        autoc_tile_f64<true>(sw, lane, cnt, acc);
    }
  }

  if constexpr (F32) {
    fold_errors(err, lane, emine, elast);
    // lag l's exact sum: sum_a M[a][a + l], M through the warp's slots
    __syncwarp();
    double* mw = sw.w;  // M[a][c] at 40 a + c
#pragma unroll
    for (int n0 = 0; n0 < 5; ++n0) {
      mw[40 * (lane >> 2) + 8 * n0 + 2 * (lane & 3)] = mm[n0][0];
      mw[40 * (lane >> 2) + 8 * n0 + 2 * (lane & 3) + 1] = mm[n0][1];
    }
    __syncwarp();
    double ex = 0.0, ex32 = 0.0;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      ex = __dadd_rn(ex, mw[40 * a + a + lane]);
      ex32 = __dadd_rn(ex32, mw[40 * a + a + MAXH]);
    }
    part[warp][lane] = __dadd_rn(ex, -emine);
    if (lane == 0) part[warp][MAXH] = __dadd_rn(ex32, -elast);
  } else {
    // lags 0..31 a lane by the butterfly, lag 32 in every lane
    double lo[32];
#pragma unroll
    for (int l = 0; l < 32; ++l) lo[l] = acc[l];
    part[warp][lane] = flacx::reduce_scatter<32>(lo, lane, flacx::AddRn{});
    const double l32 = flacx::warp_all(acc[MAXH], flacx::AddRn{});
    if (lane == 0) part[warp][MAXH] = l32;
  }
  __syncthreads();
  if (warp == 0) {
    for (int l = lane; l <= L; l += 32) {
      double v = part[0][l];
      for (int w = 1; w < warps; ++w) v = __dadd_rn(v, part[w][l]);
      out[((long long)row * shards + s) * (L + 1) + l] = v;
    }
  }
}

// ---- fixed -----------------------------------------------------------

// zigzag of d in T (wrapping), summed as the int64 of that T value
template <typename T, typename U>
__device__ __forceinline__ unsigned long long zz_term(U d) {
  constexpr int BITS = 8 * sizeof(T);
  const T t = (T)d;
  return (unsigned long long)(long long)(T)(((U)t << 1) ^
                                            (U)(t >> (BITS - 1)));
}

// A lane's run of a staged tile: the triangle at the sample before the
// run (D^0..D^3 from the 4 samples before it), then D^1..D^4 carried along
// the run.  MASKED: only the run's first `in` samples count, and order o
// only at global indices jg0 + r >= o.
template <typename T, typename U, bool MASKED>
__device__ __forceinline__ void fixed_run(const T* sw, int lane, int in,
                                          long long jg0,
                                          unsigned long long (&acc)[8]) {
  constexpr int H = 4;
  U p[H];
#pragma unroll
  for (int k = 0; k < H; ++k) p[k] = (U)sw[slot(lane, k)];  // x[-4..-1]
  U d[H];
  d[0] = p[3];
  const U e1 = p[2] - p[1], e0 = p[1] - p[0];
  d[1] = p[3] - p[2];
  d[2] = d[1] - e1;
  d[3] = d[2] - (e1 - e0);
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    U v[H + 1];
    v[0] = (U)sw[slot(lane, H + r)];
#pragma unroll
    for (int o = 1; o <= H; ++o) v[o] = v[o - 1] - d[o - 1];
#pragma unroll
    for (int o = 0; o < H; ++o) d[o] = v[o];
#pragma unroll
    for (int o = 0; o <= H; ++o) {
      const unsigned long long z = zz_term<T, U>(v[o]);
      if (MASKED)
        acc[o] += r < in && jg0 + r >= o ? z : 0ull;
      else
        acc[o] += z;
    }
  }
}

template <typename T, typename U>
__global__ void __launch_bounds__(32 * MAXWARPS)
seq_fixed_kernel(const T* __restrict__ x, const T* __restrict__ halo,
                 long long* __restrict__ out, int m, int shards, int shard0,
                 int per) {
  constexpr int H = 4;
  __shared__ T sl[MAXWARPS][slots<H>()];
  __shared__ unsigned long long part[MAXWARPS][8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x / shards, s = blockIdx.x % shards;
  const int local = m / shards;
  const T* xr = x + (long long)row * m;
  const T* hr = halo ? halo + (long long)row * H : nullptr;
  const long long g0 = (long long)(shard0 + s) * local;  // shard's jg
  const int start = min(warp * per, local), end = min(start + per, local);
  T* sw = sl[warp];
  unsigned long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};

  Tile<T, H> next;
  if (start < end)
    next.fetch(xr, hr, H, (long long)s * local + start - H, m, true, lane);
  for (int t0 = start; t0 < end; t0 += TILE) {
    __syncwarp();
#pragma unroll
    for (int q = 0; q < Tile<T, H>::Q; ++q) {
      const int u = lane + 32 * q;
      if (u < Tile<T, H>::N) sw[u + u / RUN] = next.v[q];
    }
    __syncwarp();
    if (t0 + TILE < end)
      next.fetch(xr, hr, H, (long long)s * local + t0 + TILE - H, m, true,
                 lane);
    const int cnt = min(TILE, end - t0);
    if (cnt == TILE && g0 + t0 >= H)  // no mask in the tile (warp-uniform)
      fixed_run<T, U, false>(sw, lane, 0, 0, acc);
    else
      fixed_run<T, U, true>(sw, lane, cnt - RUN * lane,
                            g0 + t0 + RUN * lane, acc);
  }
  const unsigned long long mine =
      flacx::reduce_scatter<8>(acc, lane, flacx::Add{});
  if ((lane & 3) == 0) part[warp][lane >> 2] = mine;
  __syncthreads();
  if (warp == 0 && lane < 5) {
    unsigned long long v = 0;
    for (int w = 0; w < warps; ++w) v += part[w][lane];
    out[((long long)row * shards + s) * 5 + lane] = (long long)v;
  }
}

// ---- lpc -------------------------------------------------------------

struct LpcArgs {
  const int32_t* x;
  const int32_t* halo;
  const int32_t* taps;
  const int32_t* shift;
  const int32_t* order;
  long long* out;
  int m, shards, shard0, t, per;
};

// a * b + c: a 32 x 32 -> 64-bit product added in 64 bits (wrapping),
// one IMAD.WIDE
__device__ __forceinline__ long long mad_wide(int32_t a, int32_t b,
                                              long long c) {
  long long d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// acc[r] += sum_k tp[k] x[r - 1 - k] over the bucket's TB taps (taps past
// the row's last nonzero one are zero); value c of the lane's window is
// x[c - MAXH] counted from its run's first sample.
template <int TB>
__device__ __forceinline__ void lpc_mac(const int32_t* sw, int lane,
                                        const int32_t (&tp)[MAXH],
                                        long long (&acc)[RUN]) {
#pragma unroll
  for (int c = MAXH - TB; c < MAXH + RUN - 1; ++c) {
    const int32_t v = sw[slot(lane, c)];
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      const int k = r - 1 - (c - MAXH);
      if (k >= 0 && k < TB) acc[r] = mad_wide(tp[k], v, acc[r]);
    }
  }
}

__global__ void __launch_bounds__(32 * MAXWARPS)
seq_lpc_kernel(const LpcArgs a) {
  __shared__ int32_t sl[MAXWARPS][slots<MAXH>()];
  __shared__ unsigned long long psum[MAXWARPS];
  __shared__ long long pmax[MAXWARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x / a.shards, s = blockIdx.x % a.shards;
  const int local = a.m / a.shards;
  const int start = min(warp * a.per, local),
            end = min(start + a.per, local);
  const int32_t* xr = a.x + (long long)row * a.m;
  const int32_t* hr = a.halo ? a.halo + (long long)row * a.t : nullptr;
  const long long g0 = (long long)(a.shard0 + s) * local;
  const int sh = a.shift[row];
  const long long od = a.order[row];
  int32_t tp[MAXH];  // the taps in registers, zero past t
#pragma unroll
  for (int k = 0; k < MAXH; ++k)
    tp[k] = k < a.t ? a.taps[(long long)row * a.t + k] : 0;
  // the MAC runs up to the row's last nonzero tap, in a bucket of 4 to 32
  const int32_t tv = lane < a.t ? a.taps[(long long)row * a.t + lane] : 0;
  const int ntaps = 32 - __clz(__ballot_sync(flacx::FULL_MASK, tv != 0));
  int32_t* sw = sl[warp];
  unsigned long long zsum = 0;
  long long amax = LLONG_MIN;

  Tile<int32_t, MAXH> next;
  if (start < end)
    next.fetch(xr, hr, a.t, (long long)s * local + start - MAXH, a.m, true,
               lane);
  for (int t0 = start; t0 < end; t0 += TILE) {
    __syncwarp();
#pragma unroll
    for (int q = 0; q < Tile<int32_t, MAXH>::Q; ++q) {
      const int u = lane + 32 * q;
      if (u < Tile<int32_t, MAXH>::N) sw[u + u / RUN] = next.v[q];
    }
    __syncwarp();
    if (t0 + TILE < end)
      next.fetch(xr, hr, a.t, (long long)s * local + t0 + TILE - MAXH, a.m,
                 true, lane);
    long long acc[RUN];
#pragma unroll
    for (int r = 0; r < RUN; ++r) acc[r] = 0;
    if (ntaps <= 4)
      lpc_mac<4>(sw, lane, tp, acc);
    else if (ntaps <= 8)
      lpc_mac<8>(sw, lane, tp, acc);
    else if (ntaps <= 12)
      lpc_mac<12>(sw, lane, tp, acc);
    else if (ntaps <= 16)
      lpc_mac<16>(sw, lane, tp, acc);
    else if (ntaps <= 24)
      lpc_mac<24>(sw, lane, tp, acc);
    else
      lpc_mac<32>(sw, lane, tp, acc);
    const int in = min(TILE, end - t0) - RUN * lane;  // the run's samples
    const long long jg = g0 + t0 + RUN * lane;
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      const long long pred = acc[r] >> sh;
      const long long res =
          (long long)((unsigned long long)(long long)sw[slot(lane, MAXH + r)] -
                      (unsigned long long)pred);
      const bool keep = r < in && jg + r >= od;
      const unsigned long long zz =
          ((unsigned long long)res << 1) ^ (unsigned long long)(res >> 63);
      const long long mag =
          (long long)(res < 0 ? 0ull - (unsigned long long)res
                              : (unsigned long long)res);
      zsum += keep ? zz : 0ull;
      amax = max(amax, keep ? mag : 0ll);
    }
  }
  zsum = flacx::warp_all(zsum, flacx::Add{});
  amax = flacx::warp_all(amax, flacx::Max{});
  if (lane == 0) {
    psum[warp] = zsum;
    pmax[warp] = amax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long v = 0;
    long long mx = LLONG_MIN;
    for (int w = 0; w < warps; ++w) {
      v += psum[w];
      mx = max(mx, pmax[w]);
    }
    a.out[((long long)row * a.shards + s) * 2] = (long long)v;
    a.out[((long long)row * a.shards + s) * 2 + 1] = mx;
  }
}

bool span_ok(int rows, int m, int shards, int shard0, int h) {
  if (rows <= 0 || m <= 0 || shards <= 0 || shard0 < 0 || m % shards)
    return false;
  const int local = m / shards;
  return local >= h && (long long)rows * shards <= 2147483647LL;
}

// Warps a (row, shard) and the samples each takes: about four tiles a
// warp, at most MAXWARPS warps (then more); from `local` alone.
void parts(int local, int& warps, int& per) {
  warps = min(MAXWARPS, max(1, (local + 4 * TILE - 1) / (4 * TILE)));
  const int each = (local + warps - 1) / warps;
  per = (each + TILE - 1) / TILE * TILE;
  warps = (local + per - 1) / per;
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
  int warps, per;
  parts(m / shards, warps, per);
  const int blocks = rows * shards;
  if (f64)
    seq_autocorr_kernel<double><<<blocks, 32 * warps, 0, stream>>>(
        static_cast<const double*>(x), static_cast<const double*>(halo),
        out, m, shards, shard0, n, max_lag, per);
  else
    seq_autocorr_kernel<float><<<blocks, 32 * warps, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(halo), out,
        m, shards, shard0, n, max_lag, per);
  return (int)cudaGetLastError();
}

// x [rows, m] int32 (int64 when i64), halo [rows, 4] or null, out int64
// [rows, shards, 5].
FLACX_API int flacx_seq_fixed(const void* x, const void* halo,
                              long long* out, int rows, int m, int shards,
                              int shard0, int i64, cudaStream_t stream) {
  if (!span_ok(rows, m, shards, shard0, 4))
    return (int)cudaErrorInvalidValue;
  int warps, per;
  parts(m / shards, warps, per);
  const int blocks = rows * shards;
  if (i64)
    seq_fixed_kernel<long long, unsigned long long>
        <<<blocks, 32 * warps, 0, stream>>>(
            static_cast<const long long*>(x),
            static_cast<const long long*>(halo), out, m, shards, shard0,
            per);
  else
    seq_fixed_kernel<int32_t, uint32_t><<<blocks, 32 * warps, 0, stream>>>(
        static_cast<const int32_t*>(x), static_cast<const int32_t*>(halo),
        out, m, shards, shard0, per);
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
  int warps, per;
  parts(m / shards, warps, per);
  const LpcArgs a{x, halo, taps, shift, order, out, m, shards, shard0, t,
                  per};
  seq_lpc_kernel<<<rows * shards, 32 * warps, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
