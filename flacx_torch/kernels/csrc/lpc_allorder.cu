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
// The MACs run on the tensor cores, exact in integers.  All orders'
// predictions of a block of 16 samples are one small integer product,
//   C[s][o] = sum_j x[s-1-j] * q[o][j],
// with the samples on M (16), the orders on N (8 a tile) and the taps on K
// (32): mma.sync m16n8k32 with s32 accumulators over 8-bit operands.
// Orders come in tiles of 8; a last tile of at most 4 orders, all <= 16
// (P = 12: orders 9..12), is packed: its columns 4..7 hold the same orders
// with the taps moved 16 deeper, so one MMA on a block predicts those
// orders for it and for the block before.  At P = 12 a pair of blocks
// takes 3 MMA tiles, 384 values, none of them padding.
// Both operands are split into 8-bit limbs:
//   samples: the bytes of the int32, the low ones u8 and the top one s8;
//            3 limbs up to eff_bps 24 (16-bit stereo has 17), 4 past it;
//   taps:    lo = (int8)(q & 0xff) and hi = (q - lo) >> 8, both s8 (exact
//            for |q| <= 2^14, precision 15); a row whose taps all lie in
//            [-128, 127] (precision <= 8: 5 is encode --best's) has hi = 0
//            and skips the hi products (decided on the card, per row).
// Each limb product sums at most 32 terms of |a*b| <= 255 * 128, and the
// products of one shift (lo x limb l and hi x limb l-1) share an
// accumulator: at most 64 terms, < 2^21, so every accumulator is exact in
// int32.  They are combined with shifts of 8 bits: in uint32 (wrap-
// defined) under the int32 bound eff_bps + 1 + bitlen(sum|taps|) <= 31,
// which equals the plain version's int32 MAC there (products at shift 32
// vanish mod 2^32); in int64 past it ("wide": 24-bit stereo, eff_bps 25),
// where |x| < 2^31 and 32 taps of precision <= 15 give |sum| < 2^50, so
// every order's res, its zigzag and the sums are exact int64 values on
// every lane, those with |res| >= 2^31 included; max |res| clamps to
// 2^31 - 1.  The wrapper picks the sample limbs from eff_bps and the MAC
// width from the static bound; x must lie within eff_bps bits.
//
// Bound on the card: the larger of the bytes (the row read once, the P
// sums and maxima written once; 75.5 MB for 1024 frames x 4 virtual
// channels x 4608 samples, 0.023 ms at 3.35 TB/s) and the operations:
// the MACs of every order's nonzero taps times the limb products, at the
// int8 tensor rate (1979 TOP/s), plus the epilogue of 8 scalar operations
// per (sample, order) at 67 TOP/s (16 in the wide mode's int64).  At P =
// 12 the epilogue dominates: 0.030 ms for that batch.
//
// Design: one block per row, 8 warps.  The row streams through shared
// memory in chunks of 2048 samples with a halo of 32 previous samples
// (zero before the row start), as int32 and as limb planes (pl[w] holds
// limb l of samples 4w..4w+3 in its word l).  Each thread keeps its B
// fragments (the taps of column g of every order tile, both limbs) in
// registers for the whole row.  A warp walks a contiguous run of sample
// blocks: an A fragment register is 4 consecutive samples of one limb in
// reverse order, one prmt of two aligned plane words, and half of a
// block's A registers are the previous block's.  The epilogue runs on the
// accumulator fragment (two samples x two orders a thread): limb combine,
// shift, res = x - pred, the warmup and tail mask (only in edge steps),
// zigzag, a 64-bit sum and the max zigzag (max |res| = (max zz + 1) >> 1).
// Lanes of one order reduce with shuffles, then shared-memory atomics.
// One pass over all orders in both widths.
//
// What limits it: the epilogue, about 9 scalar operations per (sample,
// order): 108 a sample at P = 12, against 78 multiply-adds and the same
// epilogue on the CUDA cores before.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 2048;  // samples of the row in shared memory at a time
constexpr int HALO = 32;     // samples before a chunk; the largest order

struct Smem {
  uint4 pl[(HALO + CHUNK) / 4];  // limb planes of xs
  int32_t xs[HALO + CHUNK];
  unsigned long long red_s[HALO];
  unsigned long long red_m[HALO];  // max zigzag
};

__device__ __forceinline__ uint32_t limb(const uint4& w, int l) {
  return l == 0 ? w.x : l == 1 ? w.y : l == 2 ? w.z : w.w;
}

// d = c + A * B: A 16 x 32 samples of one limb (u8, or s8 for the top limb
// AS), B 32 x 8 taps of one limb (s8).
template <bool AS>
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2], int c0, int c1,
                                    int c2, int c3) {
  if constexpr (AS)
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "r"(c0), "r"(c1), "r"(c2), "r"(c3));
  else
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "r"(c0), "r"(c1), "r"(c2), "r"(c3));
}

// The prediction of one order tile, c = the sum over shifts 8 s of the
// limb products there (lo x limb s, plus hi x limb s - 1 where the row has
// hi taps), each exact in int32, combined as they come: in uint32 (shift
// 32 vanishes) or in int64 (WIDE).  L sample limbs; TW: the row has hi
// taps.
template <bool WIDE>
using Pred = std::conditional_t<WIDE, long long, uint32_t>;

template <bool WIDE, int L, bool TW>
__device__ __forceinline__ void tile_predict(Pred<WIDE> (&c)[4],
                                             const uint32_t (&a)[4][4],
                                             const uint32_t (&b)[2][2]) {
  constexpr int limbs = L;
  constexpr bool two = TW;
#pragma unroll
  for (int s = 0; s < (WIDE ? 5 : 4); ++s) {
    int t[4];
    const bool lo = s < limbs, hi = two && s >= 1 && s <= limbs;
    if (lo) {
      if (s == limbs - 1)
        mma<true>(t, a[s], b[0], 0, 0, 0, 0);
      else
        mma<false>(t, a[s], b[0], 0, 0, 0, 0);
    }
    if (hi) {
      const int c0 = lo ? t[0] : 0, c1 = lo ? t[1] : 0;
      const int c2 = lo ? t[2] : 0, c3 = lo ? t[3] : 0;
      if (s - 1 == limbs - 1)
        mma<true>(t, a[s - 1], b[1], c0, c1, c2, c3);
      else
        mma<false>(t, a[s - 1], b[1], c0, c1, c2, c3);
    }
    if (lo || hi) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (WIDE)
          c[e] = (s ? c[e] : 0) + (long long)t[e] * (1LL << (8 * s));
        else
          c[e] = (s ? c[e] : 0u) + ((uint32_t)t[e] << (8 * s));
      }
    }
  }
}

// The per-thread sums of an order: Σ zigzag and the max zigzag.  NARROW:
// every zigzag is under 2^26, so a chunk's sum (32 values an order and
// thread) fits a uint32.
template <bool WIDE, bool NARROW = false>
struct OrderStats {
  std::conditional_t<NARROW, uint32_t, unsigned long long> s = 0;
  std::conditional_t<WIDE, unsigned long long, uint32_t> m = 0;
};

// Order index of C column c of tile tt (tiles of 8; the packed tile nf
// holds orders 8 nf .. 8 nf + 3 twice).
__device__ __forceinline__ int column_order(int tt, int c, int nf,
                                            bool pack) {
  return pack && tt == nf ? 8 * nf + (c & 3) : 8 * tt + c;
}

struct Columns {
  int o[2];
};

// The order indices of a thread's C columns 2 tg, 2 tg + 1 in tile tt.
__device__ __forceinline__ Columns columns(int tt, int tg, int nf,
                                           bool pack) {
  return {{column_order(tt, 2 * tg, nf, pack),
           column_order(tt, 2 * tg + 1, nf, pack)}};
}

// Folds the prediction fragment of one order tile into the thread's two
// orders (columns 2 tg, 2 tg + 1): samples x0 (row g) and x1 (row g + 8)
// at i0, i0 + 8; o[k] the order index of column k.
template <bool WIDE, bool EDGE, bool NARROW>
__device__ __forceinline__ void fold(const Pred<WIDE> (&c)[4], int x0,
                                     int x1, const int (&sh)[2],
                                     OrderStats<WIDE, NARROW> (&st)[2],
                                     int i0, int n, Columns col) {
  const int* o = col.o;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if constexpr (WIDE) {
      unsigned long long zs = 0, zm = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        long long r = (long long)(h ? x1 : x0) - (c[2 * h + k] >> sh[k]);
        if (EDGE) {
          const int i = i0 + 8 * h;
          if (i <= o[k] || i >= n) r = 0;
        }
        const unsigned long long z =
            ((unsigned long long)r << 1) ^ (unsigned long long)(r >> 63);
        zs += z;
        zm = max(zm, z);
      }
      st[k].s += zs;
      st[k].m = max(st[k].m, zm);
    } else {
      uint32_t z[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int32_t r = (h ? x1 : x0) - ((int32_t)c[2 * h + k] >> sh[k]);
        if (EDGE) {
          const int i = i0 + 8 * h;
          if (i <= o[k] || i >= n) r = 0;
        }
        // |r| < 2^30 under the bound: z < 2^31, the pair < 2^32
        z[h] = 2u * (uint32_t)abs(r) + (uint32_t)(r >> 31);
      }
      st[k].s += z[0] + z[1];
      st[k].m = max(st[k].m, max(z[0], z[1]));
    }
  }
}

// NT: order tiles held (2 for P <= 16, 4 past it); WIDE: the int64 combine
// and epilogue; L sample limbs; TW: the row has hi taps; NARROW: 32-bit
// sums within a chunk (OrderStats), added to sm.red_s chunk by chunk; the
// rest reaches sm.red_s / sm.red_m at the row's end.
template <bool WIDE, int NT, int L, bool TW, bool NARROW>
__device__ __forceinline__ void row_stats(Smem& sm, const int32_t* xr, int n,
                                          int p,
                                          const uint32_t (&b)[NT][2][2],
                                          const int (&sh)[NT][2], int nf,
                                          bool pack, int nt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  OrderStats<WIDE, NARROW> st[NT][2];
  // lanes of one column (g = 0..7) hold the same order: shuffles, then
  // shared-memory atomics (the packed tile's columns k and k + 4 meet there
  // too); the sums of a narrow chunk, or everything at the row's end
  auto flush = [&](bool maxima) {
#pragma unroll
    for (int tt = 0; tt < NT; ++tt) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        unsigned long long s = st[tt][k].s;  // 8 lanes' chunk sums
        auto m = st[tt][k].m;
#pragma unroll
        for (int d = 4; d < 32; d <<= 1) {
          s += __shfl_xor_sync(flacx::FULL_MASK, s, d);
          if (maxima) m = max(m, __shfl_xor_sync(flacx::FULL_MASK, m, d));
        }
        const int o = column_order(tt, 2 * tg + k, nf, pack);
        if (g == 0 && tt < nt && o < p) {
          atomicAdd(&sm.red_s[o], s);
          if (maxima) atomicMax(&sm.red_m[o], (unsigned long long)m);
        }
        st[tt][k].s = 0;
      }
    }
  };
  // an A register's 4 bytes start at u = HALO + block + g - 4 - 4 tg (its
  // lowest sample), so their offset in the aligned word is g & 3; prmt
  // reverses them
  const int off = g & 3;
  const uint32_t sel = (off + 3) | (off + 2) << 4 | (off + 1) << 8 | off << 12;
  const bool vec = (n & 3) == 0;

  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int steps = (min(CHUNK, n - c0) + 31) >> 5;  // pairs of blocks
    const int quads = HALO / 4 + 8 * steps;
    for (int qd = threadIdx.x; qd < quads; qd += THREADS) {
      const int i0 = c0 - HALO + 4 * qd;
      int4 v;
      if (vec && i0 >= 0 && i0 + 4 <= n) {
        v = *reinterpret_cast<const int4*>(xr + i0);
      } else {
        v.x = (i0 >= 0 && i0 < n) ? xr[i0] : 0;
        v.y = (i0 + 1 >= 0 && i0 + 1 < n) ? xr[i0 + 1] : 0;
        v.z = (i0 + 2 >= 0 && i0 + 2 < n) ? xr[i0 + 2] : 0;
        v.w = (i0 + 3 >= 0 && i0 + 3 < n) ? xr[i0 + 3] : 0;
      }
      reinterpret_cast<int4*>(sm.xs)[qd] = v;
      // transpose the 4 x 4 bytes: word l = byte l of the four samples
      const uint32_t ab_lo = __byte_perm(v.x, v.y, 0x5140);
      const uint32_t ab_hi = __byte_perm(v.x, v.y, 0x7362);
      const uint32_t cd_lo = __byte_perm(v.z, v.w, 0x5140);
      const uint32_t cd_hi = __byte_perm(v.z, v.w, 0x7362);
      sm.pl[qd] = make_uint4(__byte_perm(ab_lo, cd_lo, 0x5410),
                             __byte_perm(ab_lo, cd_lo, 0x7632),
                             __byte_perm(ab_hi, cd_hi, 0x5410),
                             __byte_perm(ab_hi, cd_hi, 0x7632));
    }
    __syncthreads();

    // a warp walks steps [s_lo, s_hi), contiguous, so each block inherits
    // half of its A registers from the block before
    const int per = (steps + WARPS - 1) / WARPS;
    const int s_lo = warp * per, s_hi = min(steps, s_lo + per);
    uint32_t a[4][4];
    if (s_lo < s_hi) {  // registers 0 and 1 of the block before the first
      const int wa = (HALO + 32 * s_lo - 16 + g - 4 - 4 * tg) >> 2;
      const uint4 w0 = sm.pl[wa], w1 = sm.pl[wa + 1];
      const uint4 w2 = sm.pl[wa + 2], w3 = sm.pl[wa + 3];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        a[l][0] = __byte_perm(limb(w0, l), limb(w1, l), sel);
        a[l][1] = __byte_perm(limb(w2, l), limb(w3, l), sel);
      }
    }
    for (int stp = s_lo; stp < s_hi; ++stp) {
      const int gs = c0 + 32 * stp;  // the step's first sample
      const bool edge = gs < HALO || gs + 32 > n;
      int xb0 = 0, xb1 = 0;
#pragma unroll
      for (int blk = 0; blk < 2; ++blk) {
        const int s0 = 32 * stp + 16 * blk;
        const int wa = (HALO + s0 + g - 4 - 4 * tg) >> 2;
        const uint4 w0 = sm.pl[wa], w1 = sm.pl[wa + 1];
        const uint4 w2 = sm.pl[wa + 2], w3 = sm.pl[wa + 3];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          a[l][2] = a[l][0];  // taps 16.. of rows g, g + 8: 16 samples back
          a[l][3] = a[l][1];
          a[l][0] = __byte_perm(limb(w0, l), limb(w1, l), sel);
          a[l][1] = __byte_perm(limb(w2, l), limb(w3, l), sel);
        }
        const int x0 = sm.xs[HALO + s0 + g], x1 = sm.xs[HALO + s0 + g + 8];
        const int i0 = c0 + s0 + g;
#pragma unroll
        for (int tt = 0; tt < NT; ++tt) {
          if (tt < nt && !(pack && tt == nf)) {
            Pred<WIDE> c[4];
            tile_predict<WIDE, L, TW>(c, a, b[tt]);
            if (edge)
              fold<WIDE, true, NARROW>(c, x0, x1, sh[tt], st[tt], i0, n,
                                       columns(tt, tg, nf, pack));
            else
              fold<WIDE, false, NARROW>(c, x0, x1, sh[tt], st[tt], i0, n,
                                        {0, 0});
          }
        }
        if (blk == 0) {
          xb0 = x0;
          xb1 = x1;
        } else if (pack) {
          // the packed tile on the second block: columns 0..3 predict its
          // samples, columns 4..7 (tg >= 2) the first block's
          const bool back = tg >= 2;
          const int y0 = back ? xb0 : x0, y1 = back ? xb1 : x1;
          const int j0 = back ? i0 - 16 : i0;
#pragma unroll
          for (int tt = 0; tt < NT; ++tt) {
            if (tt == nf) {
              Pred<WIDE> c[4];
              tile_predict<WIDE, L, TW>(c, a, b[tt]);
              if (edge)
                fold<WIDE, true, NARROW>(c, y0, y1, sh[tt], st[tt], j0, n,
                                         columns(tt, tg, nf, pack));
              else
                fold<WIDE, false, NARROW>(c, y0, y1, sh[tt], st[tt], j0, n,
                                          {0, 0});
            }
          }
        }
      }
    }
    if constexpr (NARROW) flush(false);
    __syncthreads();  // xs and pl are refilled by the next chunk
  }
  flush(true);
}

// L sample limbs; the 16-bit main path (int32, P <= 16, 3 limbs) runs 3
// blocks an SM, the others 2 (P <= 16) or 1.
template <bool WIDE, int NT, int L>
__global__ void __launch_bounds__(THREADS,
                                  !WIDE && NT == 2 && L == 3 ? 3
                                                             : NT == 2 ? 2 : 1)
lpc_allorder_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ qcoefs,
                    const int32_t* __restrict__ shifts,
                    long long* __restrict__ lzz, int32_t* __restrict__ maxabs,
                    int n, int p, int t, int narrow) {
  __shared__ Smem sm;
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  // order tiles: nf of 8 orders, then the rest; a rest of at most 4
  // orders, all <= 16, is packed
  const int nf = p >> 3, rest = p & 7;
  const bool pack = rest > 0 && rest <= 4 && p <= 16;
  const int nt = nf + (rest > 0);

  // B fragments: column g of every tile, taps 4 tg .. 4 tg + 3 (register
  // 0) and 16 + 4 tg .. (register 1), both tap limbs; the shifts of the
  // thread's C columns 2 tg, 2 tg + 1
  uint32_t b[NT][2][2];
  int sh[NT][2];
  bool hi_used = false;
#pragma unroll
  for (int tt = 0; tt < NT; ++tt) {
    const bool packed = pack && tt == nf;
    const int o = column_order(tt, g, nf, pack);
    const int delay = packed && g >= 4 ? 16 : 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 16 * r + 4 * tg + i - delay;
        const int q = (tt < nt && o < p && j >= 0 && j <= o && j < t)
                          ? qcoefs[((size_t)row * p + o) * t + j]
                          : 0;
        const int ql = (int)(int8_t)(q & 0xff);
        const int qh = (q - ql) >> 8;
        hi_used |= qh != 0;
        lo |= (uint32_t)(ql & 0xff) << (8 * i);
        hi |= (uint32_t)(qh & 0xff) << (8 * i);
      }
      b[tt][0][r] = lo;
      b[tt][1][r] = hi;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int oo = column_order(tt, 2 * tg + k, nf, pack);
      sh[tt][k] = (tt < nt && oo < p) ? shifts[(size_t)row * p + oo] : 0;
    }
  }
  if (threadIdx.x < HALO) {
    sm.red_s[threadIdx.x] = 0;
    sm.red_m[threadIdx.x] = 0;
  }
  const bool two = __syncthreads_or(hi_used);

  const int32_t* xr = x + (size_t)row * n;
  if (two)
    row_stats<WIDE, NT, L, true, false>(sm, xr, n, p, b, sh, nf, pack, nt);
  else if (!WIDE && L == 3 && narrow)  // encode --best at 16 bits
    row_stats<WIDE, NT, L, false, !WIDE && L == 3>(sm, xr, n, p, b, sh, nf,
                                                   pack, nt);
  else
    row_stats<WIDE, NT, L, false, false>(sm, xr, n, p, b, sh, nf, pack, nt);
  __syncthreads();
  if (threadIdx.x < p) {
    const unsigned long long a = (sm.red_m[threadIdx.x] + 1) >> 1;
    lzz[(size_t)row * p + threadIdx.x] = (long long)sm.red_s[threadIdx.x];
    maxabs[(size_t)row * p + threadIdx.x] =
        (int32_t)(a < 0x7fffffffull ? a : 0x7fffffffull);
  }
}

template <bool WIDE, int L>
void launch(const int32_t* x, const int32_t* qcoefs, const int32_t* shifts,
            long long* lzz, int32_t* maxabs, int rows, int n, int p, int t,
            int narrow, cudaStream_t stream) {
  if (p > 16)
    lpc_allorder_kernel<WIDE, 4, L><<<rows, THREADS, 0, stream>>>(
        x, qcoefs, shifts, lzz, maxabs, n, p, t, narrow);
  else
    lpc_allorder_kernel<WIDE, 2, L><<<rows, THREADS, 0, stream>>>(
        x, qcoefs, shifts, lzz, maxabs, n, p, t, narrow);
}

}  // namespace

// x int32 [rows, n], qcoefs int32 [rows, p, t] (row o-1 is the order-o
// predictor), shifts int32 [rows, p] -> lzz int64 [rows, p], maxabs int32
// [rows, p]; wide != 0 takes the int64 combine, limbs (3 or 4) the sample
// limbs; narrow != 0 promises eff_bps + bitlen(sum |taps|) <= 25 (every
// zigzag under 2^26).  Returns the CUDA error code of the launch.
FLACX_API int flacx_lpc_allorder(const int32_t* x, const int32_t* qcoefs,
                                 const int32_t* shifts, long long* lzz,
                                 int32_t* maxabs, int rows, int n, int p,
                                 int t, int wide, int limbs, int narrow,
                                 cudaStream_t stream) {
  if (rows <= 0 || n < 1 || p < 1 || p > HALO || t < 1 || t > HALO ||
      limbs < 3 || limbs > 4)
    return (int)cudaErrorInvalidValue;
  auto go = wide ? (limbs == 4 ? launch<true, 4> : launch<true, 3>)
                 : (limbs == 4 ? launch<false, 4> : launch<false, 3>);
  go(x, qcoefs, shifts, lzz, maxabs, rows, n, p, t, narrow, stream);
  return (int)cudaGetLastError();
}
