// reference_analysis: conformance mode's analysis (the reference encoder's
// parameter choices, reproduced bit for bit) in two kernels.
//
// reference_lpc, every row:
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
//   fsum[o] = sum_{i >= o}   |D^o x[i]|                               o < 5
//   lsum[o] = sum_{i >= o+1} |x[i] - (sum_j q_o[j] x[i-1-j] >> s_o)|   o < P
//   with D^o the o-th difference (the fixed predictor of order o); the
//   residuals are never written.
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
//   reference's order: it cannot become a tree sum.
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
// operations: the LPC MACs as 8-bit limb products at the int8 tensor rate,
// the fixed differences and the epilogue's four operations a residual
// (shift, subtract, abs, add) at the scalar rate.
//
// Design, reference_lpc.  Each chain is n - 1 dependent adds, so a warp's
// time is its instruction stream's; the f64 pipe issues a warp
// instruction whatever its active mask (16 lanes a clock an SM
// sub-partition).  Two lane layouts, picked at launch from the rows
// against the SMs.  Packed, where the rows fill the card: lane 0 of a row
// walks lag 0, lane k >= 1 lags 2k - 1 and 2k (two independent chains
// sharing w[j]); a row takes LPR = 1 + ceil(P/2) lanes (7 at P = 12), a
// chain warp up to 32 / LPR rows (4), a block 1-4 chain warps (fewer where
// the blocks would not reach every SM).  One lag a lane, where the rows
// would give an SM at most two chain warps: a block a row, chain warp w
// lags 32 w .. 32 w + 31 (two at P = 32), half the f64 instructions a step.
// A lane walks its chains U = 8 steps a group: w[j0..j0+7] (a broadcast)
// and w[j0+c..j0+c+7] (c = 2k, or the lag), four 16-byte loads each (eight
// 8-byte ones for an odd lag), lag 2k - 1's first term from the previous
// group's last value; the products of a group are formed between the adds
// of the group before and its samples load two groups ahead.  (Every lane
// value costs the shared-memory crossbar the same, broadcast or not: four
// warps an SM make the loads, not the adds, the limit.)  The windowed rows
// live in rings of three tiles of T samples a row (T = 256 at P = 12, 512
// one lag a lane), w[n-1] and past it stored as 0 (adding w[j] * 0 = +-0
// to a sum that is never -0 leaves it as it is, so every chain runs the
// same tiles), slot 0's head mirrored past the last slot so the loads need
// no mask.  A block's last warp windows its rows: tiles 0 and 1 before the
// chains start, then tile t + 2 while the chain warps walk tile t, into
// the slot tile t - 1 held, one block barrier a tile; it loads the raw
// samples of eight rows before it uses the first (one rounded __dmul_rn a
// sample, the int-to-double conversion as an exact full-rate add), and
// its load latency stalls no chain.  (Chain warps that fetched and
// windowed their own next tile lost 4-10 cycles a step to it, and a
// windowing warp with one load in flight at a time could not keep up with
// 16 rows.)  Levinson then runs on a row's lanes (one lag a lane: warp
// 0's), every row of the warp at once, its arrays in the row's ring: for
// each order lane 0 forms the rounded products a[j] * autoc[k+1-j] and
// subtracts them in the reference's order, divides, updates the error and
// hands lambda to the row's lanes by a shuffle, and lane i updates a[i]
// and a[k+1-i] from their old values (the reference's symmetric loop
// touches each pair once).  Quantization runs one lane an order; the
// outputs leave through shared memory, coalesced.
//
// Design, abs_residual_sums.  One block of 8 warps a segment of up to 2304
// samples of a row, staged in shared memory with a 32-sample halo (zero
// before the row start) as int32 and as limb planes (pl[w] holds limb l
// of samples 4w..4w+3 in its word l).  The LPC predictions of every order
// run on the tensor cores as lpc_allorder's: mma.sync m16n8k32 with s32
// accumulators over 8-bit limbs, the samples of a 16-sample block on M,
// the orders on N in tiles of 8 (a last tile of at most 4 orders, all <=
// 16, packed with the taps moved 16 deeper, so one MMA serves two blocks),
// the taps on K (m16n8k16 for a tile of orders <= 16: half the products,
// and no A registers of the block before); samples split into L bytes (2
// up to eff_bps 16, 3 up to 24, 4 past it; the low ones u8, the top one
// s8), taps into lo = (int8)(q
// & 0xff) and hi = (q - lo) >> 8, the hi products skipped by a block whose
// taps all lie in [-128, 127].  Each limb product sums at most 32 terms of
// |a*b| <= 255 * 128, and the products of one shift share an accumulator
// (at most 64 terms, < 2^21): exact in int32.  They are combined with
// shifts of 8 bits, in uint32 under lpc_residual.mac_width's int32 bound
// (products at shift 32 vanish mod 2^32; the sum equals the plain
// version's int64 MAC there) and in int64 past it (and with four sample
// limbs).  The tile layout (tiles used, last one packed) and the edge
// masks are template parameters, so a step is one straight run of code
// (taken at run time they cost 8-75% and spill more; the instantiations
// cost about 11 s of build).  The epilogue runs on
// the accumulator fragment (two samples x two orders a thread): shift,
// then |x - pred| added by one sad (|a - b| + c) into a step's 32-bit sums
// (four values under 2^30) that join 64-bit ones; the warm-up and tail
// masks run only in edge steps.  The fixed orders are differences: each
// thread takes runs of 8 consecutive samples and the 4 before them, forms
// D^1..D^4 by successive subtraction (int32 up to eff_bps 26, where |D^4
// x| < 2^30 and a run's sums fit 32 bits; int64 past it) and adds their
// magnitudes.  The sums stay in registers over the segment; a warp reduces
// them once by shuffles into its own shared slot, since sm_90 runs a
// 64-bit shared atomicAdd as a compare-and-swap loop, and the block adds
// the warps' slots; a row of several segments adds its blocks' sums by
// 64-bit global atomics into outputs the wrapper zeroes.

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAX_ORDER = 32;
constexpr double LN2 = 0.6931471805599453;  // math.log(2.0)

// ---- reference_lpc -------------------------------------------------------

constexpr int LPC_WARPS = 4;  // chain warps of a block at most
constexpr int LPC_THREADS = 32 * (LPC_WARPS + 1);  // and the windowing warp
constexpr int U = 8;      // chain steps of a group
constexpr int SLOTS = 3;  // tiles of a row's ring

// The work split of one launch (flacx_reference_lpc fills it in).
struct LpcShape {
  int lpr;     // lanes a row (packed: lane 0 lag 0, lane k >= 1 lags 2k - 1,
               // 2k; the Levinson lanes of a row in both layouts)
  int rpw;     // rows a chain warp (one lag a lane: 1)
  int tile;    // samples of a tile: 128, 256 or 512
  int stride;  // doubles of a row's ring (and of its Levinson arrays)
  int mirror;  // samples of slot 0's head copied past the ring's last slot
  int vec;     // x's rows and the window are 16-byte aligned
};

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

// Raw samples j..j+3 of the block's rows r0 .. r0 + 7 (zero past nb and past
// n), every load issued before the first is used.
template <bool VEC>
__device__ __forceinline__ void raw_batch(int4 (&v)[8],
                                          const int32_t* __restrict__ x,
                                          int rowb, int nb, int r0, int n,
                                          int j) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + i;
    const int32_t* g = x + (size_t)(rowb + (r < nb ? r : 0)) * n + j;
    if constexpr (VEC) {
      v[i] = r < nb ? __ldg(reinterpret_cast<const int4*>(g))
                    : make_int4(0, 0, 0, 0);
    } else {
      v[i].x = r < nb && j < n ? __ldg(g) : 0;
      v[i].y = r < nb && j + 1 < n ? __ldg(g + 1) : 0;
      v[i].z = r < nb && j + 2 < n ? __ldg(g + 2) : 0;
      v[i].w = r < nb && j + 3 < n ? __ldg(g + 3) : 0;
    }
  }
}

// ONE: one lag a lane, a block a row, chain warp w its lags 32 w .. 32 w +
// 31; else packed, chain warp w the block's rows rpw w .., two lags a lane.
// The block's last warp windows the rows into their rings.
template <bool ONE>
__global__ void __launch_bounds__(LPC_THREADS)
    reference_lpc_kernel(const int32_t* __restrict__ x,
                         const double* __restrict__ window,
                         double* __restrict__ autoc,
                         int32_t* __restrict__ qcoefs,
                         int32_t* __restrict__ shift,
                         uint8_t* __restrict__ valid, int rows, int n, int p,
                         int precision, LpcShape sp) {
  extern __shared__ double smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chains = (blockDim.x >> 5) - 1;  // the chain warps
  const int lpr = sp.lpr, rpw = sp.rpw, T = sp.tile, S = sp.stride;
  const int brows = ONE ? 1 : chains * rpw;  // rings of the block
  const int rowb = blockIdx.x * brows;       // the block's first row
  const int nb = min(brows, rows - rowb);    // rows that exist
  const int ntile = (n - 2 + T) / T;         // tiles of the terms j <= n - 2

  if (warp == chains) {
    // The windowing warp: tile t of every ring into slot t % SLOTS (rows
    // past nb as zeros; w[n-1] and past it 0; slot 0's head mirrored past
    // the last slot), tiles 0 and 1 before the chains start and tile t + 2
    // while they walk tile t, into the slot tile t - 1 held.  (double) x
    // exactly as (2^52 + 2^51 + 2^31 + x) less the constant: a full-rate
    // add where the int-to-double conversion is quarter rate.
    for (int t = 0; t <= ntile; ++t) {
      double* base = smem + (t % SLOTS) * T;
      for (int s = 4 * lane; s < T; s += 128) {
        const int j = t * T + s;
        double w[4];
        const bool vec = sp.vec && j + 3 < n;
        if (vec) {
          const double2 w0 = __ldg(reinterpret_cast<const double2*>(window + j));
          const double2 w1 =
              __ldg(reinterpret_cast<const double2*>(window + j + 2));
          w[0] = w0.x;
          w[1] = w0.y;
          w[2] = w1.x;
          w[3] = w1.y;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) w[q] = j + q < n ? window[j + q] : 0.0;
        }
        for (int r0 = 0; r0 < brows; r0 += 8) {
          int4 v[8];
          if (vec)
            raw_batch<true>(v, x, rowb, nb, r0, n, j);
          else
            raw_batch<false>(v, x, rowb, nb, r0, n, j);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (r0 + i >= brows) break;
            const int xs[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
            double out[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const double xd = __dsub_rn(
                  __hiloint2double(0x43380000, xs[q] ^ (int)0x80000000),
                  0x1.8p52 + 0x1p31);
              out[q] = j + q < n - 1 ? __dmul_rn(xd, w[q]) : 0.0;
            }
            double2* d = reinterpret_cast<double2*>(base + (r0 + i) * S + s);
            d[0] = make_double2(out[0], out[1]);
            d[1] = make_double2(out[2], out[3]);
            if (t % SLOTS == 0 && s < sp.mirror) {
              d[SLOTS * T / 2] = make_double2(out[0], out[1]);
              d[SLOTS * T / 2 + 1] = make_double2(out[2], out[3]);
            }
          }
        }
      }
      if (t >= 1) __syncthreads();  // tiles t - 1 and t are windowed
    }
    if constexpr (ONE) {  // the chain warps' hand-over to warp 0
      __syncthreads();
      __syncthreads();
    }
    return;
  }

  // the lane's ring row rl (one lag a lane: the block's row), its pair k
  // (packed) or lag, the offset of its c samples; lanes past the warp's
  // rows mirror its last lane, lanes past P the lag P (their loads are
  // broadcasts, their results never stored)
  bool active = ONE ? 32 * warp + lane <= p : lane < rpw * lpr;
  const int ln = active || ONE ? lane : rpw * lpr - 1;
  int rl = ONE ? 0 : ln / lpr, k = ln - rl * lpr;
  const int coff = ONE ? min(32 * warp + lane, p) : 2 * k;
  const double* rr = smem + (ONE ? 0 : warp * rpw + rl) * S;
  const bool walk = ONE || warp * rpw < nb;  // the warp has rows

  // a group's samples at ring position g: a = w[g..g+7], c = w[g + coff
  // ..] (16-byte loads; one lag a lane, an odd lag's are 8-byte ones)
  auto load = [&](const double* g, double (&a)[U], double (&c)[U]) {
#pragma unroll
    for (int q = 0; q < U; q += 2) {
      const double2 va = *reinterpret_cast<const double2*>(g + q);
      a[q] = va.x;
      a[q + 1] = va.y;
      if constexpr (ONE) {
        c[q] = g[coff + q];
        c[q + 1] = g[coff + q + 1];
      } else {
        const double2 vc = *reinterpret_cast<const double2*>(g + coff + q);
        c[q] = vc.x;
        c[q + 1] = vc.y;
      }
    }
  };
  // the products of a group: lag coff from a[u] c[u], packed also lag 2k
  // - 1 from a[u] c[u - 1], c[-1] the previous group's last value (carry)
  double acc0 = 0.0, acc1 = 0.0;  // lag 2k - 1 (none for k = 0), lag coff
  double carry = 0.0;             // w[gp + 2k - 1] of the group formed next
  double p0[U], p1[U], a0[U], c0[U], a1[U], c1[U];
  auto form = [&](const double (&a)[U], const double (&c)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if constexpr (!ONE) p0[u] = __dmul_rn(a[u], u ? c[u - 1] : carry);
      p1[u] = __dmul_rn(a[u], c[u]);
    }
    carry = c[U - 1];
  };
  // one group at ring position gp: add its products (formed a group ago),
  // form the next group's from a, c (loaded two groups ago) between the
  // adds, and load the samples of the group after that into an, cn
  auto group = [&](const double* gp, double (&a)[U], double (&c)[U],
                   double (&an)[U], double (&cn)[U]) {
    load(gp + 2 * U, an, cn);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if constexpr (!ONE) acc0 = __dadd_rn(acc0, p0[u]);
      acc1 = __dadd_rn(acc1, p1[u]);
      if constexpr (!ONE) p0[u] = __dmul_rn(a[u], u ? c[u - 1] : carry);
      p1[u] = __dmul_rn(a[u], c[u]);
    }
    carry = c[U - 1];
  };

  // the chains, tile by tile (a tile's last groups read the next tile's
  // head, past the last slot from the mirror)
  for (int t = 0; t < ntile; ++t) {
    __syncthreads();  // tiles t and t + 1 are windowed
    if (!walk) continue;
    const double* gp = rr + (t % SLOTS) * T;
    if (t == 0) {  // group 0's products, group 1's samples
      load(gp, a0, c0);
      carry = !ONE && k > 0 ? gp[2 * k - 1] : 0.0;
      form(a0, c0);
      load(gp + U, a0, c0);
    }
#pragma unroll 4
    for (int i = 0; i < T / U; i += 2) {
      group(gp + i * U, a0, c0, a1, c1);
      group(gp + (i + 1) * U, a1, c1, a0, c0);
    }
  }
  if constexpr (ONE) {
    // every chain warp is done with the ring; its space takes the Levinson
    // arrays, and warp 0's lanes 0..lpr - 1 run the rest
    __syncthreads();
    if (active) smem[coff] = acc1;
    __syncthreads();
    if (warp > 0) return;
    active = lane < lpr;
    rl = 0;
    k = lane;
  } else if (!walk) {
    return;
  }
  // the warp's rows: their rings' space takes their Levinson arrays
  double* ws = smem + (ONE ? 0 : warp * rpw) * S;
  const int row0 = rowb + (ONE ? 0 : warp * rpw);
  const int nrow = ONE ? 1 : min(rpw, nb - warp * rpw);
  __syncwarp();

  // a row's arrays: autoc, a, the taps of every order [p][p], the
  // quantized taps [p][p], shifts and valid flags
  const int nl = p + 1;
  const int rs = 2 * nl + p * p + (p * p + 2 * p + 1) / 2;
  double* sac = ws + rl * rs;
  double* sa = sac + nl;
  double* staps = sa + nl;
  int32_t* sq = reinterpret_cast<int32_t*>(staps + p * p);
  int32_t* ssh = sq + p * p;
  int32_t* svl = ssh + p;
  if (active) {
    if (!ONE && k > 0) sac[2 * k - 1] = acc0;
    if (!ONE && 2 * k <= p) sac[2 * k] = acc1;
    for (int j = k; j <= p; j += lpr) sa[j] = j == 0 ? 1.0 : 0.0;
  }
  __syncwarp();

  // Levinson-Durbin, the reference's op order, a row's lanes: lane 0
  // forms and subtracts the products in order, divides, updates the error
  // and hands lambda to the row's lanes; lane i updates the pair (i,
  // kk + 1 - i) from its old values
  double err = sac[0];
  bool ok = true;
  for (int kk = 0; kk < p; ++kk) {
    double lam = 0.0;
    if (active && k == 0) {
      ok = ok && err != 0.0;
      const double safe = err != 0.0 ? err : 1.0;
#pragma unroll 8
      for (int j = 0; j <= kk; ++j)
        lam = __dsub_rn(lam, __dmul_rn(sa[j], sac[kk + 1 - j]));
      lam = __ddiv_rn(lam, safe);
      err = __dmul_rn(err, __dsub_rn(1.0, __dmul_rn(lam, lam)));
      svl[kk] = ok;
    }
    lam = __shfl_sync(flacx::FULL_MASK, lam, rl * lpr);
    const int m = kk + 1 - k;
    const bool upd = active && k <= (kk + 1) / 2;
    double ni = 0.0, nm = 0.0;
    if (upd) {
      const double ai = sa[k], am = sa[m];
      ni = __dadd_rn(ai, __dmul_rn(lam, am));
      nm = __dadd_rn(am, __dmul_rn(lam, ai));
    }
    __syncwarp();
    if (upd) {  // a[j > kk + 1] are still zero: order kk + 1's taps a[1:]
      sa[k] = ni;
      sa[m] = nm;
      if (k > 0) staps[kk * p + k - 1] = ni;
      staps[kk * p + m - 1] = nm;
    }
    __syncwarp();
  }

  // error-feedback quantization, one lane an order (taps past it are 0)
  if (active) {
    const double qmax = (double)((1 << (precision - 1)) - 1);
    const double qmin = -(double)(1 << (precision - 1));
    for (int o = k; o < p; o += lpr) {
      const double* t = staps + o * p;
      double cmax = 0.0;
      bool nan = false, fin = true;
      for (int j = 0; j <= o; ++j) {
        const double v = fabs(t[j]);
        nan = nan || isnan(v);
        fin = fin && isfinite(t[j]);
        cmax = v > cmax ? v : cmax;
      }
      const bool vld = svl[o] && fin;
      const bool pos = !nan && cmax > 0.0;
      const int sh = min(precision - floor_log2(pos ? cmax : 1.0) - 2, 15);
      // negative shift: scale down, emit shift 0 (the oracle's fix)
      const double scale = sh >= 0 ? pow2(sh) : __ddiv_rn(1.0, pow2(-sh));
      const bool keep = vld && pos;
      double e = 0.0;
      for (int j = 0; j <= o; ++j) {
        int32_t q = 0;
        if (keep) {
          e = __dadd_rn(e, __dmul_rn(t[j], scale));
          const double qd = fmin(fmax(rint(e), qmin), qmax);  // half even
          e = __dsub_rn(e, qd);
          q = (int32_t)qd;
        }
        sq[o * p + j] = q;
      }
      ssh[o] = keep ? max(sh, 0) : 0;
      svl[o] = vld;
    }
  }
  __syncwarp();

  // the warp's rows are contiguous in every output
  for (int e = lane; e < nrow * nl; e += 32) {
    const int r = e / nl;
    autoc[(size_t)row0 * nl + e] = ws[r * rs + e - r * nl];
  }
  const int pp = p * p;
  for (int e = lane; e < nrow * pp; e += 32) {
    const int r = e / pp, f = e - r * pp, o = f / p;
    const int32_t* q =
        reinterpret_cast<const int32_t*>(ws + r * rs + 2 * nl + pp);
    qcoefs[(size_t)row0 * pp + e] = f - o * p <= o ? q[f] : 0;
  }
  for (int e = lane; e < nrow * p; e += 32) {
    const int r = e / p;
    const int32_t* h =
        reinterpret_cast<const int32_t*>(ws + r * rs + 2 * nl + pp) + pp;
    shift[(size_t)row0 * p + e] = h[e - r * p];
    valid[(size_t)row0 * p + e] = h[p + e - r * p] ? 1 : 0;
  }
}

// ---- abs_residual_sums ---------------------------------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SEG_MAX = 2304;  // the wrapper's SEG_MAX
constexpr int HALO = 32;       // samples before a segment: the largest order
constexpr int RUN = 8;         // samples of a thread's run of differences

struct Smem {
  uint4 pl[(HALO + SEG_MAX) / 4];  // limb planes of xs
  int32_t xs[HALO + SEG_MAX];
  // each warp's sums: fixed orders 0..4, then LPC (a slot a warp, so no
  // 64-bit shared atomic, which sm_90 runs as a compare-and-swap loop)
  unsigned long long red[WARPS][5 + MAX_ORDER];
};

struct SumArgs {
  const int32_t* x;       // [rows, n]
  const int32_t* qcoefs;  // [rows, p, p]
  const int32_t* qshift;  // [rows, p]
  long long* fsum;        // [rows, 5]
  long long* lsum;        // [rows, p]
  int n, p, seg, nseg, d64;
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

// d = c + A * B over K = 16: A 16 x 16 (a[0], a[1] of the K = 32
// fragment), B 16 x 8 (b[0]): orders whose taps all lie in the first 16.
template <bool AS>
__device__ __forceinline__ void mma16(int (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2], int c0, int c1,
                                      int c2, int c3) {
  if constexpr (AS)
    asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b[0]), "r"(c0), "r"(c1), "r"(c2),
          "r"(c3));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b[0]), "r"(c0), "r"(c1), "r"(c2),
          "r"(c3));
}

template <bool WIDE>
using Pred = std::conditional_t<WIDE, long long, uint32_t>;

// The prediction of one order tile, the sum over shifts 8 s of the limb
// products there (lo x limb s, plus hi x limb s - 1 where the block has hi
// taps), each exact in int32, combined as they come: in uint32 (shift 32
// vanishes) or in int64 (WIDE).  L sample limbs; TW: hi taps; K: 16 for a
// tile whose taps all lie in the first 16 (half the products, and no
// registers of the block before), else 32.
template <bool WIDE, int L, bool TW, int K = 32>
__device__ __forceinline__ void tile_predict(Pred<WIDE> (&c)[4],
                                             const uint32_t (&a)[4][4],
                                             const uint32_t (&b)[2][2]) {
  auto op = [](int(&d)[4], const uint32_t(&av)[4], const uint32_t(&bv)[2],
               bool top, int c0, int c1, int c2, int c3) {
    if (K == 16 && top)
      mma16<true>(d, av, bv, c0, c1, c2, c3);
    else if (K == 16)
      mma16<false>(d, av, bv, c0, c1, c2, c3);
    else if (top)
      mma<true>(d, av, bv, c0, c1, c2, c3);
    else
      mma<false>(d, av, bv, c0, c1, c2, c3);
  };
#pragma unroll
  for (int s = 0; s < (WIDE ? 5 : 4); ++s) {
    int t[4];
    const bool lo = s < L, hi = TW && s >= 1 && s <= L;
    if (lo) op(t, a[s], b[0], s == L - 1, 0, 0, 0, 0);
    if (hi) {
      const int c0 = lo ? t[0] : 0, c1 = lo ? t[1] : 0;
      const int c2 = lo ? t[2] : 0, c3 = lo ? t[3] : 0;
      op(t, a[s - 1], b[1], s - 1 == L - 1, c0, c1, c2, c3);
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

// The sums of one step (32 samples) of a column: four values of |res| <
// 2^30 under the int32 bound fit 32 bits; 64 bits past it.
template <bool WIDE>
using Step = std::conditional_t<WIDE, unsigned long long, uint32_t>;

// Order index of C column c of tile tt: tiles of 8 orders; with PACK the
// last tile holds orders 8 tt .. 8 tt + 3 twice, its columns 4..7 with the
// taps moved 16 deeper (the block before).
template <int NTU, bool PACK>
__device__ __forceinline__ int column_order(int tt, int c) {
  return PACK && tt == NTU - 1 ? 8 * tt + (c & 3) : 8 * tt + c;
}

// Adds |res| of the thread's two orders (columns 2 tg, 2 tg + 1: order
// indices o0, o1) at samples x0 (row g) and x1 (row g + 8), row positions
// i0 and i0 + 8, into st; EDGE masks positions i <= o (the warm-up) and
// i >= lim (past the segment).
template <bool WIDE, bool EDGE>
__device__ __forceinline__ void fold(const Pred<WIDE> (&c)[4], int x0,
                                     int x1, const int (&sh)[2],
                                     Step<WIDE> (&st)[2], int i0, int lim,
                                     int o0, int o1) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int xv = h ? x1 : x0;
      const bool off =
          EDGE && (i0 + 8 * h <= (k ? o1 : o0) || i0 + 8 * h >= lim);
      if constexpr (WIDE) {
        const long long r = off ? 0 : (long long)xv - (c[2 * h + k] >> sh[k]);
        st[k] += (unsigned long long)(r < 0 ? -r : r);
      } else {
        const int32_t pr = off ? xv : (int32_t)c[2 * h + k] >> sh[k];
        st[k] = __sad(xv, pr, st[k]);
      }
    }
  }
}

// One step of a warp (two 16-sample blocks from segment position 32 stp)
// over all NTU order tiles; the layout is known at compile time, so the
// step is one straight run of code.  a: the A registers, [2..3] of each
// limb the block before's; wb: this thread's plane word of block 0.
template <bool WIDE, int L, bool TW, int NTU, bool PACK, bool EDGE>
__device__ __forceinline__ void lpc_step(
    const Smem& sm, int stp, int s0, int lim, int wb, uint32_t sel, int g,
    int tg, uint32_t (&a)[4][4], const uint32_t (&b)[NTU][2][2],
    const int (&sh)[NTU][2], unsigned long long (&tot)[NTU][2]) {
  Step<WIDE> st[NTU][2];
#pragma unroll
  for (int tt = 0; tt < NTU; ++tt) st[tt][0] = st[tt][1] = 0;
  int xb0 = 0, xb1 = 0;
#pragma unroll
  for (int blk = 0; blk < 2; ++blk) {
    const int u0 = 32 * stp + 16 * blk;
    const uint4* pw = sm.pl + wb + (u0 >> 2);
    const uint4 w0 = pw[0], w1 = pw[1], w2 = pw[2], w3 = pw[3];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      a[l][2] = a[l][0];  // taps 16.. of rows g, g + 8: 16 samples back
      a[l][3] = a[l][1];
      a[l][0] = __byte_perm(limb(w0, l), limb(w1, l), sel);
      a[l][1] = __byte_perm(limb(w2, l), limb(w3, l), sel);
    }
    const int x0 = sm.xs[HALO + u0 + g], x1 = sm.xs[HALO + u0 + g + 8];
    const int i0 = s0 + u0 + g;
#pragma unroll
    for (int tt = 0; tt < (PACK ? NTU - 1 : NTU); ++tt) {
      Pred<WIDE> c[4];
      if (tt < 2)  // orders <= 16: taps in the first 16
        tile_predict<WIDE, L, TW, 16>(c, a, b[tt]);
      else
        tile_predict<WIDE, L, TW, 32>(c, a, b[tt]);
      fold<WIDE, EDGE>(c, x0, x1, sh[tt], st[tt], i0, lim, 8 * tt + 2 * tg,
                       8 * tt + 2 * tg + 1);
    }
    if (blk == 0) {
      xb0 = x0;
      xb1 = x1;
    } else if (PACK) {
      // the packed tile on the second block: columns 0..3 predict its
      // samples, columns 4..7 (tg >= 2) the first block's
      constexpr int tt = NTU - 1;
      const bool back = tg >= 2;
      Pred<WIDE> c[4];
      tile_predict<WIDE, L, TW>(c, a, b[tt]);
      fold<WIDE, EDGE>(c, back ? xb0 : x0, back ? xb1 : x1, sh[tt], st[tt],
                       back ? i0 - 16 : i0, lim,
                       column_order<NTU, PACK>(tt, 2 * tg),
                       column_order<NTU, PACK>(tt, 2 * tg + 1));
    }
  }
#pragma unroll
  for (int tt = 0; tt < NTU; ++tt) {
    tot[tt][0] += st[tt][0];
    tot[tt][1] += st[tt][1];
  }
}

// The LPC orders of the staged segment (m samples from row position s0)
// in the layout (NTU tiles, PACK); each order's sum of the warp reaches
// sm.red[warp][5 + o].
template <bool WIDE, int L, bool TW, int NTU, bool PACK>
__device__ __forceinline__ void lpc_orders(Smem& sm, int s0, int m, int p,
                                           const uint32_t (&b)[NTU][2][2],
                                           const int (&sh)[NTU][2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  unsigned long long tot[NTU][2];
#pragma unroll
  for (int tt = 0; tt < NTU; ++tt) tot[tt][0] = tot[tt][1] = 0;
  // an A register's 4 bytes start at u = HALO + block + g - 4 - 4 tg (its
  // lowest sample), so their offset in the aligned word is g & 3; prmt
  // reverses them
  const int off = g & 3;
  const uint32_t sel = (off + 3) | (off + 2) << 4 | (off + 1) << 8 | off << 12;
  const int wb = (HALO + g - 4 - 4 * tg) >> 2;
  const int steps = (m + 31) >> 5, lim = s0 + m;
  // a warp walks steps [s_lo, s_hi), contiguous, so each block inherits
  // half of its A registers from the block before
  const int per = (steps + WARPS - 1) / WARPS;
  const int s_lo = warp * per, s_hi = min(steps, s_lo + per);
  uint32_t a[4][4];
  if (s_lo < s_hi) {  // registers 0 and 1 of the block before the first
    const uint4* pw = sm.pl + wb + 8 * s_lo - 4;
    const uint4 w0 = pw[0], w1 = pw[1], w2 = pw[2], w3 = pw[3];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      a[l][0] = __byte_perm(limb(w0, l), limb(w1, l), sel);
      a[l][1] = __byte_perm(limb(w2, l), limb(w3, l), sel);
    }
  }
  for (int stp = s_lo; stp < s_hi; ++stp) {
    const int gs = s0 + 32 * stp;  // the step's first row position
    if (gs < HALO || gs + 32 > lim)
      lpc_step<WIDE, L, TW, NTU, PACK, true>(sm, stp, s0, lim, wb, sel, g,
                                             tg, a, b, sh, tot);
    else
      lpc_step<WIDE, L, TW, NTU, PACK, false>(sm, stp, s0, lim, wb, sel, g,
                                              tg, a, b, sh, tot);
  }
  // lanes of one column (g = 0..7) hold the same order, and so do the
  // packed tile's columns c and c + 4 (lanes tg and tg ^ 2): shuffles, then
  // the warp's slot
#pragma unroll
  for (int tt = 0; tt < NTU; ++tt) {
    const bool packed = PACK && tt == NTU - 1;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      unsigned long long s = tot[tt][k];
#pragma unroll
      for (int d = 4; d < 32; d <<= 1)
        s += __shfl_xor_sync(flacx::FULL_MASK, s, d);
      if (packed) s += __shfl_xor_sync(flacx::FULL_MASK, s, 2);
      const int o = column_order<NTU, PACK>(tt, 2 * tg + k);
      if (g == 0 && o < p && !(packed && tg >= 2)) sm.red[warp][5 + o] = s;
    }
  }
}

// The B fragments of a segment's row in the layout (NTU tiles, PACK):
// column g of every tile, taps 4 tg .. 4 tg + 3 (register 0) and 16 + 4 tg
// .. (register 1), both tap limbs; the shifts of the thread's C columns
// 2 tg, 2 tg + 1.  Then the LPC orders, with the hi tap products where a
// tap of the row passes one signed byte.  Its barrier ends the staging.
template <bool WIDE, int L, int NTU, bool PACK>
__device__ void lpc_pass(Smem& sm, const SumArgs& sa, int row, int s0,
                         int m) {
  const int p = sa.p;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  uint32_t b[NTU][2][2];
  int sh[NTU][2];
  bool hi_used = false;
#pragma unroll
  for (int tt = 0; tt < NTU; ++tt) {
    const int o = column_order<NTU, PACK>(tt, g);
    const int delay = PACK && tt == NTU - 1 && g >= 4 ? 16 : 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 16 * r + 4 * tg + i - delay;
        const int q = (o < p && j >= 0 && j <= o)
                          ? sa.qcoefs[((size_t)row * p + o) * p + j]
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
      const int oo = column_order<NTU, PACK>(tt, 2 * tg + k);
      sh[tt][k] = oo < p ? sa.qshift[(size_t)row * p + oo] : 0;
    }
  }
  if (__syncthreads_or(hi_used))
    lpc_orders<WIDE, L, true, NTU, PACK>(sm, s0, m, p, b, sh);
  else
    lpc_orders<WIDE, L, false, NTU, PACK>(sm, s0, m, p, b, sh);
}

// The fixed orders 0..4 of the staged segment as differences: runs of RUN
// samples, the 4 before each from the halo.  D64: int64 differences and
// sums (eff_bps > 26); else int32 differences (|D^4 x| < 2^30) whose run
// sums fit 32 bits.  Each order's sum reaches sm.red[warp][o].
template <bool D64>
__device__ __forceinline__ void fixed_pass(Smem& sm, int s0, int m) {
  using D = std::conditional_t<D64, long long, int32_t>;
  using F = std::conditional_t<D64, unsigned long long, uint32_t>;
  unsigned long long f[5] = {0, 0, 0, 0, 0};
  for (int c = RUN * threadIdx.x; c < m; c += RUN * THREADS) {
    D v[RUN + 4];  // row positions s0 + c - 4 .. s0 + c + RUN - 1
#pragma unroll
    for (int q = 0; q < (RUN + 4) / 4; ++q) {
      const int4 w = reinterpret_cast<const int4*>(sm.xs + HALO + c - 4)[q];
      v[4 * q] = w.x;
      v[4 * q + 1] = w.y;
      v[4 * q + 2] = w.z;
      v[4 * q + 3] = w.w;
    }
    D d1 = v[3] - v[2], d1p = v[2] - v[1];
    D d2 = d1 - d1p, d2p = d1p - (v[1] - v[0]);
    D d3 = d2 - d2p;  // D^1..D^3 at position c - 1
    const bool edge = s0 + c < 4 || c + RUN > m;
    F r[5] = {0, 0, 0, 0, 0};
#pragma unroll
    for (int u = 0; u < RUN; ++u) {
      const D x0 = v[4 + u];
      const D e1 = x0 - v[3 + u], e2 = e1 - d1, e3 = e2 - d2, e4 = e3 - d3;
      const D e[5] = {x0, e1, e2, e3, e4};
#pragma unroll
      for (int o = 0; o < 5; ++o) {
        const bool on = !edge || (s0 + c + u >= o && c + u < m);
        if constexpr (D64) {
          const long long w = on ? e[o] : 0;
          r[o] += (unsigned long long)(w < 0 ? -w : w);
        } else {
          r[o] = __sad(e[o], on ? 0 : e[o], r[o]);
        }
      }
      d1 = e1;
      d2 = e2;
      d3 = e3;
    }
#pragma unroll
    for (int o = 0; o < 5; ++o) f[o] += r[o];
  }
  const int warp = threadIdx.x >> 5;
  const bool lead = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int o = 0; o < 5; ++o) {
    unsigned long long s = f[o];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      s += __shfl_xor_sync(flacx::FULL_MASK, s, d);
    if (lead) sm.red[warp][o] = s;
  }
}

template <bool WIDE, int L>
__global__ void __launch_bounds__(THREADS, 3)
    abs_residual_sums_kernel(SumArgs a) {
  __shared__ Smem sm;
  const int row = blockIdx.x / a.nseg, sg = blockIdx.x % a.nseg;
  const int n = a.n, p = a.p, s0 = sg * a.seg;
  const int m = min(a.seg, n - s0);  // samples of the segment
  const int32_t* xr = a.x + (size_t)row * n;

  // stage the segment and its halo as int32 and limb planes
  const bool vec = (n & 3) == 0;
  const int quads = HALO / 4 + 8 * ((m + 31) >> 5);
  for (int qd = threadIdx.x; qd < quads; qd += THREADS) {
    const int i0 = s0 - HALO + 4 * qd;
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

  // the order tiles: 8 orders each, a last one of at most 4 orders, all
  // <= 16, packed (P = 12: one full tile and a packed one)
  if (p == 0)
    __syncthreads();
  else if (p <= 4)
    lpc_pass<WIDE, L, 1, true>(sm, a, row, s0, m);
  else if (p <= 8)
    lpc_pass<WIDE, L, 1, false>(sm, a, row, s0, m);
  else if (p <= 12)
    lpc_pass<WIDE, L, 2, true>(sm, a, row, s0, m);
  else if (p <= 16)
    lpc_pass<WIDE, L, 2, false>(sm, a, row, s0, m);
  else if (p <= 24)
    lpc_pass<WIDE, L, 3, false>(sm, a, row, s0, m);
  else
    lpc_pass<WIDE, L, 4, false>(sm, a, row, s0, m);
  if (a.d64)
    fixed_pass<true>(sm, s0, m);
  else
    fixed_pass<false>(sm, s0, m);
  __syncthreads();
  for (int o = threadIdx.x; o < 5 + p; o += THREADS) {
    unsigned long long v = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += sm.red[w][o];
    long long* out = o < 5 ? a.fsum + (size_t)row * 5 + o
                           : a.lsum + (size_t)row * p + (o - 5);
    if (a.nseg == 1)
      *out = (long long)v;
    else
      atomicAdd(reinterpret_cast<unsigned long long*>(out), v);
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
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= flacx::MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  static int sms[flacx::MAX_DEVICES];  // read once a device
  if (!sms[dev]) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  // One lag a lane where the rows give the SMs at most two chain warps
  // each: a warp then issues half the f64 work a step; packed lanes where
  // the rows fill the card, whose shared memory then sets the step.
  const int wpr = (p + 32) / 32;  // chain warps a row, one lag a lane
  const bool one = rows * wpr <= 2 * sms[dev];
  LpcShape sp;
  sp.lpr = 1 + (p + 1) / 2;
  sp.rpw = one ? 1 : min(8, 32 / sp.lpr);
  // about 1024 samples of a tile a chain warp; at least a quad a lane of
  // the windowing warp
  sp.tile = 512;
  while (sp.tile > 128 && sp.rpw * sp.tile > 1024) sp.tile >>= 1;
  // the loads reach 2 U + (the largest c offset) + U - 1 samples past a
  // group's start
  sp.mirror = (2 * U + (one ? p + 1 : 2 * sp.lpr) + 3) & ~3;
  // a row's ring, at least its Levinson arrays (autoc, a, the taps of
  // every order, the quantized taps, shifts and flags), a stride that puts
  // lane L's 16-byte loads on banks 4L..4L+3
  const int nl = p + 1;
  const int levinson = 2 * nl + p * p + (p * p + 2 * p + 1) / 2;
  sp.stride = max(SLOTS * sp.tile + sp.mirror, levinson + (levinson & 1));
  while (sp.stride % 16 != 2 * sp.lpr % 16) sp.stride += 2;
  sp.vec = n % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)window % 16 == 0;
  // chain warps a block: a row's (one lag a lane), else up to LPC_WARPS,
  // fewer where the blocks would not reach every SM
  int chains = one ? wpr : LPC_WARPS;
  const int warps = (rows + sp.rpw - 1) / sp.rpw;
  while (!one && chains > 1 && warps / chains < sms[dev]) chains >>= 1;
  const int brows = one ? 1 : chains * sp.rpw;
  const int smem = brows * sp.stride * (int)sizeof(double);
  auto kernel = one ? reference_lpc_kernel<true> : reference_lpc_kernel<false>;
  static int allowed[2][flacx::MAX_DEVICES];  // opted-in bytes, per device
  e = flacx::allow_smem(kernel, smem, allowed[one]);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(rows + brows - 1) / brows, 32 * (chains + 1), smem, stream>>>(
      x, window, autoc, qcoefs, shift, valid, rows, n, p, precision, sp);
  return (int)cudaGetLastError();
}

// x int32 [rows, n], qcoefs int32 [rows, p, p], qshift int32 [rows, p] ->
// fsum int64 [rows, 5], lsum int64 [rows, p]; wide != 0 takes the int64
// combine, limbs (2, 3 or 4) the sample limbs (x within 8 limbs bits; the
// int32 combine takes 2 or 3, the int64 one 3 or 4, a 2 runs as 3); d64
// != 0 takes int64 differences (eff_bps > 26); seg: the samples of a segment (a multiple of 32, at most 2304); past
// one segment a row, fsum and lsum must hold zeros.
FLACX_API int flacx_abs_residual_sums(const int32_t* x, const int32_t* qcoefs,
                                      const int32_t* qshift, long long* fsum,
                                      long long* lsum, int rows, int n, int p,
                                      int wide, int limbs, int d64,
                                      int seg,
                                      cudaStream_t stream) {
  if (rows <= 0 || n < 1 || p < 0 || p > MAX_ORDER || seg <= 0 ||
      seg % 32 || seg > SEG_MAX || limbs < 2 || limbs > 4 ||
      (!wide && limbs > 3))
    return (int)cudaErrorInvalidValue;
  const SumArgs a{x, qcoefs, qshift, fsum, lsum, n, p, seg,
                  (n + seg - 1) / seg, d64};
  const dim3 grid(rows * a.nseg);
  if (!wide && limbs == 2)
    abs_residual_sums_kernel<false, 2><<<grid, THREADS, 0, stream>>>(a);
  else if (!wide)
    abs_residual_sums_kernel<false, 3><<<grid, THREADS, 0, stream>>>(a);
  else if (limbs <= 3)
    abs_residual_sums_kernel<true, 3><<<grid, THREADS, 0, stream>>>(a);
  else
    abs_residual_sums_kernel<true, 4><<<grid, THREADS, 0, stream>>>(a);
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
