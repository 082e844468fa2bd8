// reconstruct: the samples of a batch of FLAC frames from their decoded
// residuals: warm-up samples and constants merged in, the predictor run,
// wasted bits restored, stereo decorrelation undone, and the result
// written interleaved as int32 PCM [F, n, C].
//
// Replaces flacx/ops/reconstruct.py::reconstruct_predicted (:18),
// ::reconstruct_predicted_chunks (:73), ::reconstruct_fixed_parallel
// (:141) and ::undo_decorrelation (:184), with the glue of
// flacx/decoder.py:399-427 around them: XLA lax.scans and cumsums in
// flacx (no Pallas kernel).
//
// Semantics (flacx_torch.kernels.reconstruct.reconstruct_plain, integer
// for integer), in the working type Acc (int32 where the caller's int32
// bound holds, else int64; products and sums wrap in Acc):
//   r[i] = const_val for a constant subframe, else warmup[i] for i <
//          order (zero past 32), else vals[i];
//   IIR routes: x[i] = r[i] + (i >= order ? (sum_j taps[j] x[i-1-j]) >>
//          shift : 0), taps zero past the order and x[-1-j] = 0; with the
//          walker's sample state (state_ss > 0), chunk m of SS samples
//          starts from the window state[m] = x[m SS - 32 .. m SS - 1]
//          (int32, or int64 past 31-bit samples on the int64 type);
//   all-fixed route (fixed_max = L >= 0, no state): flacx's parallel
//          integration.  The difference triangle on the warm-up prefix
//          (position i in [1, order) becomes the min(i, L-1)-th
//          difference of r there), then for j = L-1 .. 0, where order > j,
//          every position i >= j becomes the running sum of positions
//          j .. i (the prefix below j left out of the sum);
//   x <<= wasted, then (two channels) the channel code's undecorrelation
//   (L/S, S/R, M/S with an arithmetic ch1 >> 1), cast to int32.
// Where lim >= 0, err is set if any value of vals has |v| > 2^lim (the
// int32 route's guard, flacx/decoder.py:406-410).
//
// Exactness: addition mod 2^32 and mod 2^64 is associative, so the
// reordered sums of the all-fixed route (a run a thread, then the warps'
// totals, then the tiles' carries) give the integers of flacx's cumsums
// and of the plain version in both working types, wrapping included; and
// the MAC's terms may be summed in any order.
//
// Bound on the card: bytes.  vals read once (8 B a sample) and pcm
// written once (4 B): 18.9 + 9.4 MB at 256 frames of 16-bit stereo at
// block 4608, 8.5 us at 3.35 TB/s; the MAC is t multiply-adds a sample.
//
// Design, all-fixed route: one block a frame, its C channels side by
// side (16 warps over the channels), walking the block in tiles of 128
// samples a warp.  Each thread takes a run of 4 consecutive samples (two
// 16-byte loads, the next tile's prefetched into registers); per
// integration level it sums its run serially, scans the run totals across
// its warp with shuffles and adds the totals of the channel's earlier
// warps and the level's carry from the tiles before (one barrier a level,
// the warp totals double-buffered).  The tile's samples pass through
// shared memory once, where they are undecorrelated and stored to the
// interleaved rows, coalesced.
//
// Design, IIR routes: one thread per (frame, channel, chunk) lane where
// the walker gave state (chunks of SS samples), else one per (frame,
// channel) over all n samples.  A block holds G = 32 / C (frame, chunk)
// groups with their C channels side by side: one warp of lanes, the
// walker, and mover warps (three for int32, one for int64, whose walker
// takes up to 168 registers a thread).  The movers stage the lanes'
// residuals into shared memory with coalesced cp.async copies, a window of
// WS samples at a time (WS: 64, or half a short chunk, rounded up to the
// tap bucket T), two windows ahead of the walk (int32; one ahead for
// int64, whose walk is longer), and store each window once it is walked:
// undecorrelated, each group's samples contiguous in pcm, 16 bytes a
// thread.  Named barriers hand the slots
// between walker and movers, so staging and stores overlap the walk.  The
// walker runs each lane's recurrence from shared memory with no branch:
// taps and the last T samples in registers (a ring whose slots are fixed
// at compile time, the samples taken T at a time), every prediction
// formed and masked, the MAC split over up to four accumulators with the
// newest sample's product added last, so the serial chain is one
// multiply-add a sample; int64 samples as a low word and a high part (a
// 32 x 32 -> 64-bit multiply-add a tap, and a 32-bit one only while some
// lane of the warp holds a sample past int32).  Warm-up samples
// and constants are merged into the window before its walk, their guard
// checked there.  Outputs overwrite their residuals in place.

#include <type_traits>

#include "common.cuh"

namespace {

struct Args {
  const long long* vals;     // [F, C, n] residuals (0 at i < order)
  const int32_t* taps;       // [F, C, 32]
  const int32_t* shift;      // [F, C]
  const int32_t* order;
  const int32_t* kind;
  const int32_t* wasted;
  const long long* warmup;   // [F, C, 32]
  const long long* const_val;  // [F, C]
  const void* state;         // [F, C, Ks, 32] (int64: state64) or null
  const int32_t* channel_code;  // [F]
  int32_t* pcm;              // [F, n, C]
  int32_t* err;              // [1]
  int f, c, n, chunk, ks, lim, fixed_max, state64;
  int groups_per_block, ws, a16;  // IIR routes: G, window, 16-B copies
  unsigned inv_hp;           // ceil(2^32 / pairs a window)
  long long groups;          // F * ks
};

template <typename Acc>
using Uns = std::make_unsigned_t<Acc>;

template <typename Acc>
__device__ __forceinline__ Acc wadd(Acc x, Acc y) {
  return (Acc)((Uns<Acc>)x + (Uns<Acc>)y);
}

template <typename Acc>
__device__ __forceinline__ Acc wsub(Acc x, Acc y) {
  return (Acc)((Uns<Acc>)x - (Uns<Acc>)y);
}

template <typename Acc>
__device__ __forceinline__ Acc shl_wasted(Acc x, int wasted) {
  return wasted < (int)(8 * sizeof(Acc)) ? (Acc)((Uns<Acc>)x << wasted)
                                         : (Acc)0;
}

__device__ __forceinline__ bool past_guard(long long v, int lim) {
  return lim >= 0 && (v > (1LL << lim) || -v > (1LL << lim));
}

// Sample e of an interleaved group of C channels, given the channels'
// values at that sample (ch0, ch1 used only for two channels).
template <typename Acc>
__device__ __forceinline__ int32_t undecorrelated(Acc mine, Acc ch0, Acc ch1,
                                                  int c, int ech, int code) {
  if (c == 2) {
    if (code == 8)   // left/side
      return (int32_t)(ech ? wsub(ch0, ch1) : ch0);
    if (code == 9)   // side/right
      return (int32_t)(ech ? ch1 : wadd(ch0, ch1));
    if (code == 10) {  // mid/side
      const Acc right = wsub(ch0, (Acc)(ch1 >> 1));
      return (int32_t)(ech ? right : wadd(right, ch1));
    }
  }
  return (int32_t)mine;
}

// ---------------------------------------------------------------------------
// All-fixed route

constexpr int FX_RUN = 4;        // samples a thread's run
constexpr int FX_WARPS = 16;     // warps a block at most
constexpr int FX_TILE = FX_WARPS * 32 * FX_RUN;  // tile elements, all channels

__device__ __forceinline__ void load_run(const long long* row, int n, int i0,
                                         long long (&v)[FX_RUN]) {
  if (i0 + FX_RUN <= n && (((uintptr_t)(row + i0)) & 15u) == 0) {
    const longlong2 p = __ldg(reinterpret_cast<const longlong2*>(row + i0));
    const longlong2 q =
        __ldg(reinterpret_cast<const longlong2*>(row + i0 + 2));
    v[0] = p.x; v[1] = p.y; v[2] = q.x; v[3] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < FX_RUN; ++k)
      v[k] = i0 + k < n ? __ldg(row + i0 + k) : 0;
  }
}

// r at a warm-up position i < order.
template <typename Acc>
__device__ __forceinline__ Acc prefix_r(const long long* wrow, int kind,
                                        Acc cval, int i) {
  return kind == 0 ? cval : i < 32 ? (Acc)__ldg(wrow + i) : (Acc)0;
}

template <typename Acc>
__global__ void __launch_bounds__(FX_WARPS * 32)
reconstruct_kernel_fixed(Args a, int wpc) {
  __shared__ Acc wtot[2][FX_WARPS];
  __shared__ __align__(16) Acc tile[2][FX_TILE];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ch = warp / wpc, wc = warp - ch * wpc;
  const int ts = wpc * 32 * FX_RUN;          // samples a tile, a channel
  const int fr = blockIdx.x, n = a.n, c = a.c, L = a.fixed_max;
  const long long sub = (long long)fr * c + ch;
  const int order = a.order[sub], kind = a.kind[sub];
  const int wasted = a.wasted[sub];
  const Acc cval = (Acc)a.const_val[sub];
  const long long* vrow = a.vals + sub * n;
  const long long* wrow = a.warmup + sub * 32;
  const int code = a.channel_code[fr];
  const int run0 = (wc * 32 + lane) * FX_RUN;  // the run's tile offset
  Acc carry[4] = {0, 0, 0, 0};
  long long nv[FX_RUN];
  bool bad = false;
  int par = 0;
  load_run(vrow, n, run0, nv);

  for (int t0 = 0, tp = 0; t0 < n; t0 += ts, tp ^= 1) {
    const int i0 = t0 + run0;
    Acc x[FX_RUN];
#pragma unroll
    for (int k = 0; k < FX_RUN; ++k) {
      const int i = i0 + k;
      const long long v = nv[k];
      if (i < n) bad |= past_guard(v, a.lim);
      x[k] = i >= n ? (Acc)0
             : kind == 0 ? cval
             : i < order ? (i < 32 ? (Acc)__ldg(wrow + i) : (Acc)0)
                         : (Acc)v;
    }
    if (t0 + ts < n) load_run(vrow, n, i0 + ts, nv);

    // the difference triangle on the warm-up prefix (first tile only)
    if (L >= 2 && i0 < order) {
#pragma unroll
      for (int k = 0; k < FX_RUN; ++k) {
        const int i = i0 + k;
        if (i >= 1 && i < order && i < n) {
          const int m = min(i, L - 1);
          // sum_q (-1)^q C(m, q) r[i - q]
          Acc d = prefix_r(wrow, kind, cval, i);
          int binom = 1;
          for (int q = 1; q <= m; ++q) {
            binom = binom * (m - q + 1) / q;
            const Acc term = (Acc)((Uns<Acc>)binom *
                                   (Uns<Acc>)prefix_r(wrow, kind, cval,
                                                      i - q));
            d = (q & 1) ? wsub(d, term) : wadd(d, term);
          }
          x[k] = d;
        }
      }
    }

    // integration levels L-1 .. 0: a masked inclusive scan along the row
    for (int j = L - 1; j >= 0; --j) {
      Acc s[FX_RUN];
      Acc run = 0;
#pragma unroll
      for (int k = 0; k < FX_RUN; ++k) {
        run = wadd(run, i0 + k >= j ? x[k] : (Acc)0);
        s[k] = run;
      }
      Acc inc = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const Acc y = __shfl_up_sync(flacx::FULL_MASK, inc, o);
        if (lane >= o) inc = wadd(inc, y);
      }
      if (lane == 31) wtot[par][warp] = inc;
      __syncthreads();
      Acc before = wadd(carry[j], wsub(inc, run)), total = 0;
      for (int w = 0; w < wpc; ++w) {
        const Acc wt = wtot[par][ch * wpc + w];
        if (w < wc) before = wadd(before, wt);
        total = wadd(total, wt);
      }
      if (order > j) {
#pragma unroll
        for (int k = 0; k < FX_RUN; ++k)
          if (i0 + k >= j) x[k] = wadd(before, s[k]);
      }
      carry[j] = wadd(carry[j], total);
      par ^= 1;
    }

    // the tile through shared memory: planar [C][ts], then interleaved
    Acc* mine = tile[tp] + ch * ts + run0;
#pragma unroll
    for (int k = 0; k < FX_RUN; ++k) mine[k] = shl_wasted(x[k], wasted);
    __syncthreads();
    const int cnt = min(ts, n - t0) * c;
    int32_t* prow = a.pcm + ((long long)fr * n + t0) * c;
    for (int e = tid; e < cnt; e += nthreads) {
      const int s = e / c, ech = e - s * c;
      const Acc* col = tile[tp] + s;
      prow[e] = undecorrelated(col[ech * ts], col[0], col[c > 1 ? ts : 0], c,
                               ech, code);
    }
  }
  if (bad) a.err[0] = 1;
}

// ---------------------------------------------------------------------------
// IIR routes (walker state in chunks, or serial over the block)

constexpr int WS_MAX = 64;   // window samples at most, before rounding to T

// A block's lanes and groups (at most 32 each), filled by the lanes' own
// threads: a lane's chunk offset in vals and its samples (0: no lane); a
// group's offset in pcm, samples and channel code.
struct Tables {
  long long lane_src[32], group_out[32];
  int lane_len[32], group_len[32], group_code[32];
};

// Stage window h of every lane of the block: lane l's samples
// [h ws, h ws + ws) of its chunk into slot[l][0 .. ws).
__device__ __forceinline__ void stage_window(const Args& a, const Tables& tb,
                                             long long* slot, int lanes,
                                             int wsp, int h, int tid,
                                             int nthreads) {
  for (int l = 0; l < lanes; ++l) {
    const int cnt = min(a.ws, tb.lane_len[l] - h * a.ws);
    if (cnt <= 0) continue;
    const long long* src = a.vals + tb.lane_src[l] + h * a.ws;
    long long* dst = slot + l * wsp;
    if (a.a16) {
      for (int p = tid; 2 * p < cnt; p += nthreads) {
        if (2 * p + 1 < cnt)
          flacx::cp_async16(dst + 2 * p, src + 2 * p);
        else
          flacx::cp_async8(dst + 2 * p, src + 2 * p);
      }
    } else {
      for (int p = tid; p < cnt; p += nthreads)
        flacx::cp_async8(dst + p, src + p);
    }
  }
}

// Undecorrelate and store window h of every group of the block: each
// group's samples are contiguous in pcm.
template <typename Acc>
__device__ __forceinline__ void store_window(const Args& a, const Tables& tb,
                                             const long long* slot, int wsp,
                                             int h, int tid, int nthreads) {
  const int c = a.c;
  if (c == 2) {
    // two samples of a group a thread, every group's at once (g from a
    // multiply by the reciprocal of the pairs a window): one 16-byte
    // store where aligned
    const int hp = (a.ws + 1) / 2;
    for (int e = tid; e < a.groups_per_block * hp; e += nthreads) {
      const int g = (int)__umulhi((unsigned)e, a.inv_hp);
      const int s = 2 * (e - g * hp);
      const int cnt = min(a.ws, tb.group_len[g] - h * a.ws);
      if (s >= cnt) continue;
      const long long* col = slot + g * 2 * wsp;
      int32_t* out = a.pcm + tb.group_out[g] + (long long)(h * a.ws + s) * 2;
      const int code = tb.group_code[g];
      const longlong2 p0 = *reinterpret_cast<const longlong2*>(col + s);
      const longlong2 p1 = *reinterpret_cast<const longlong2*>(col + wsp + s);
      const int4 o = make_int4(
          undecorrelated((Acc)p0.x, (Acc)p0.x, (Acc)p1.x, 2, 0, code),
          undecorrelated((Acc)p1.x, (Acc)p0.x, (Acc)p1.x, 2, 1, code),
          undecorrelated((Acc)p0.y, (Acc)p0.y, (Acc)p1.y, 2, 0, code),
          undecorrelated((Acc)p1.y, (Acc)p0.y, (Acc)p1.y, 2, 1, code));
      if (s + 1 < cnt && (((uintptr_t)out) & 15u) == 0) {
        *reinterpret_cast<int4*>(out) = o;
      } else {
        out[0] = o.x;
        out[1] = o.y;
        if (s + 1 < cnt) {
          out[2] = o.z;
          out[3] = o.w;
        }
      }
    }
    return;
  }
  for (int g = 0; g < a.groups_per_block; ++g) {
    const int cnt = min(a.ws, tb.group_len[g] - h * a.ws);
    if (cnt <= 0) continue;
    int32_t* out = a.pcm + tb.group_out[g] + (long long)h * a.ws * c;
    const long long* col = slot + g * c * wsp;
    for (int e = tid; e < c * cnt; e += nthreads) {
      const int s = e / c, ech = e - s * c;
      out[e] = (int32_t)(Acc)col[ech * wsp + s];
    }
  }
}

// The predictor's ring of the last T samples: int32 as is; int64 as a
// low word lo (signed) and a high part hc = hi - (lo >> 31), so that
// x = lo + 2^32 hc and tap * x = tap * lo + 2^32 (tap * hc) mod 2^64: a
// 32 x 32 -> 64-bit multiply-add and a 32-bit one a tap.
template <int T, typename Acc>
struct Ring;

template <int T>
struct Ring<T, int32_t> {
  int32_t x[T];
  __device__ __forceinline__ void set(int k, int32_t v) { x[k] = v; }
};

template <int T>
struct Ring<T, long long> {
  int32_t lo[T], hc[T];
  int since = T;    // samples set since the last with a nonzero hc
  __device__ __forceinline__ void set(int k, long long v) {
    lo[k] = (int32_t)v;
    hc[k] = (int32_t)(v >> 32) - (lo[k] >> 31);
    since = hc[k] ? 0 : since + 1;
  }
};

// The prediction of the sample at ring slot s (s a constant once the
// caller's loop is unrolled): sum_j taps[j] x[s-1-j] >> shift, summed in
// NA accumulators (short dependent chains), the newest sample's product
// added last.
template <int T>
__device__ __forceinline__ int32_t predict(const int32_t (&tp)[T],
                                           const Ring<T, int32_t>& rg, int s,
                                           int shift) {
  constexpr int NA = T >= 16 ? 4 : T / 4;
  uint32_t acc[NA];
#pragma unroll
  for (int k = 0; k < NA; ++k) acc[k] = 0;
#pragma unroll
  for (int j = T - 1; j >= 1; --j)
    acc[j % NA] += (uint32_t)tp[j] * (uint32_t)rg.x[(s - 1 - j + 2 * T) % T];
  uint32_t sum = 0;
#pragma unroll
  for (int k = 0; k < NA; ++k) sum += acc[k];
  sum += (uint32_t)tp[0] * (uint32_t)rg.x[(s - 1 + T) % T];
  return (int32_t)sum >> shift;
}

// a * b + c, a 32 x 32 -> 64-bit multiply-add (one instruction)
__device__ __forceinline__ long long mad_wide(int32_t a, int32_t b,
                                              long long c) {
  long long d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

template <int T>
__device__ __forceinline__ long long predict(const int32_t (&tp)[T],
                                             const Ring<T, long long>& rg,
                                             int s, int shift) {
  constexpr int NA = T >= 16 ? 4 : T / 4;
  long long lo[NA];
  uint32_t hi[NA];
#pragma unroll
  for (int k = 0; k < NA; ++k) {
    lo[k] = 0;
    hi[k] = 0;
  }
#pragma unroll
  for (int j = T - 1; j >= 1; --j) {
    const int k = (s - 1 - j + 2 * T) % T;
    lo[j % NA] = mad_wide(tp[j], rg.lo[k], lo[j % NA]);
  }
  unsigned long long sum = 0;
#pragma unroll
  for (int k = 0; k < NA; ++k) sum += (unsigned long long)lo[k];
  const int k0 = (s - 1 + T) % T;
  sum = (unsigned long long)mad_wide(tp[0], rg.lo[k0], (long long)sum);
  // the high parts are zero while every sample of the ring fits int32 (a
  // valid stream's): skipped unless some lane of the warp needs them
  if (__any_sync(__activemask(), rg.since < T)) {
#pragma unroll
    for (int j = T - 1; j >= 0; --j) {
      const int k = (s - 1 - j + 2 * T) % T;
      hi[j % NA] += (uint32_t)tp[j] * (uint32_t)rg.hc[k];
    }
  }
  uint32_t hsum = 0;
#pragma unroll
  for (int k = 0; k < NA; ++k) hsum += hi[k];
  return (long long)(sum + ((unsigned long long)hsum << 32)) >> shift;
}

// Named barriers of the block (0 is __syncthreads): sync waits, arrive
// signals without waiting.  FULL[b] (every warp): window slot b has
// landed; FREE[b] (every warp): it has been walked; MOVE (the mover
// warps): every mover has read a slot before it is staged again.  int32:
// three slots (the movers stage two windows ahead) and three mover warps;
// int64: two slots and one mover, as its longer walk hides one window's
// staging and its walker's registers (up to 168) would otherwise halve
// the blocks an SM holds.
constexpr int BAR_FULL = 1, BAR_FREE = 4, BAR_MOVE = 7;

template <typename Acc>
__host__ __device__ constexpr int n_slots() {
  return sizeof(Acc) == 4 ? 3 : 2;
}

template <typename Acc>
__host__ __device__ constexpr int n_movers() {
  return sizeof(Acc) == 4 ? 3 : 1;
}

template <int ID, int N>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(N) : "memory");
}

template <int ID, int N>
__device__ __forceinline__ void bar_arrive() {
  asm volatile("bar.arrive %0, %1;" ::"n"(ID), "n"(N) : "memory");
}

// barrier ID + h % NS of the block's N threads, the id a compile-time
// constant
template <int ID, int NS, int N>
__device__ __forceinline__ void slot_sync(int h) {
  switch (h % NS) {
    case 0: bar_sync<ID, N>(); break;
    case 1: bar_sync<ID + 1, N>(); break;
    default: bar_sync<ID + 2, N>(); break;
  }
}

template <int ID, int NS, int N>
__device__ __forceinline__ void slot_arrive(int h) {
  switch (h % NS) {
    case 0: bar_arrive<ID, N>(); break;
    case 1: bar_arrive<ID + 1, N>(); break;
    default: bar_arrive<ID + 2, N>(); break;
  }
}

__device__ __forceinline__ bool past(long long v, long long glim) {
  return (v > glim) | ((long long)(0ull - (unsigned long long)v) > glim);
}

template <int T, typename Acc>
__global__ void __launch_bounds__(32 * (1 + n_movers<Acc>()))
reconstruct_kernel_iir(Args a) {
  constexpr int NS = n_slots<Acc>(), NT = 32 * (1 + n_movers<Acc>());
  extern __shared__ __align__(16) long long buf[];  // [NS][lanes][wsp]
  __shared__ Tables tb;
  const int tid = threadIdx.x;
  const int lanes = a.groups_per_block * a.c;
  const int wsp = a.ws + 2;        // lane stride: 16-byte reads, no conflict
  const int g = tid / a.c, ch = tid - g * a.c;
  const long long grp = (long long)blockIdx.x * a.groups_per_block + g;
  const bool live = tid < lanes && grp < a.groups;
  const int fr = live ? (int)(grp / a.ks) : 0;
  const int m = live ? (int)(grp - (long long)fr * a.ks) : 0;
  const long long sub = (long long)fr * a.c + ch;
  const int c0 = m * a.chunk;
  const int cend = min(c0 + a.chunk, a.n);
  if (tid < lanes) {
    tb.lane_src[tid] = sub * a.n + c0;
    tb.lane_len[tid] = live ? cend - c0 : 0;
    if (ch == 0) {
      tb.group_out[g] = ((long long)fr * a.n + c0) * a.c;
      tb.group_len[g] = live ? cend - c0 : 0;
      tb.group_code[g] = live ? a.channel_code[fr] : 0;
    }
  }

  int32_t tp[T];
  Ring<T, Acc> rg;
  int order = 0, shift = 0, kind = 0, wasted = 0;
  Acc cval = 0;
  if (live) {
    order = a.order[sub];
    shift = a.shift[sub];
    kind = a.kind[sub];
    wasted = a.wasted[sub];
    cval = (Acc)a.const_val[sub];
  }
  const long long s0 = (sub * a.ks + m) * 32 + 32 - T;  // the window's tail
#pragma unroll
  for (int j = 0; j < T; ++j) {
    tp[j] = live ? a.taps[sub * 32 + j] : 0;
    Acc v = 0;
    if (live && a.state)
      v = a.state64 ? (Acc) static_cast<const long long*>(a.state)[s0 + j]
                    : (Acc) static_cast<const int32_t*>(a.state)[s0 + j];
    rg.set(j, v);
  }
  const long long* wrow = a.warmup + sub * 32;
  // the guard's bound (none: past every int64)
  const long long glim = a.lim >= 0 ? 1LL << a.lim : 0x7fffffffffffffffLL;
  bool bad = false;
  __syncthreads();

  const int nwin = (a.chunk + a.ws - 1) / a.ws;
  const int slot_size = lanes * wsp;
  if (tid >= 32) {
    // the movers: stage the next NS - 1 windows while window h is walked,
    // store a window once walked
    const int mt = tid - 32, nm = NT - 32;
    for (int q = 0; q < NS - 1; ++q) {
      if (q < nwin)
        stage_window(a, tb, buf + q * slot_size, lanes, wsp, q, mt, nm);
      flacx::cp_async_commit();
    }
    for (int h = 0; h < nwin; ++h) {
      flacx::cp_async_wait<NS - 2>();    // window h has landed
      slot_arrive<BAR_FULL, NS, NT>(h);
      if (h + NS - 1 < nwin) {
        long long* next = buf + ((h + NS - 1) % NS) * slot_size;
        if (h >= 1) {   // window h - 1 holds the slot: walked, then stored
          slot_sync<BAR_FREE, NS, NT>(h - 1);
          store_window<Acc>(a, tb, next, wsp, h - 1, mt, nm);
          bar_sync<BAR_MOVE, NT - 32>();
        }
        stage_window(a, tb, next, lanes, wsp, h + NS - 1, mt, nm);
      }
      flacx::cp_async_commit();
    }
    for (int q = max(0, nwin - NS); q < nwin; ++q) {
      slot_sync<BAR_FREE, NS, NT>(q);
      store_window<Acc>(a, tb, buf + (q % NS) * slot_size, wsp, q, mt, nm);
    }
    return;
  }
  // the walker
  for (int h = 0; h < nwin; ++h) {
    long long* slot = buf + (h % NS) * slot_size;
    slot_sync<BAR_FULL, NS, NT>(h);
    if (live) {
      long long* w = slot + tid * wsp;
      const int wbase = c0 + h * a.ws;
      const int wend = min(wbase + a.ws, cend);
      // warm-up samples and constants merged in before the walk, their
      // residuals checked here (the positions below mlim)
      int mlim = wbase;
      if (kind == 0 || wbase < order) {
        mlim = min(kind == 0 ? cend : order, wend);
        for (int i = wbase; i < mlim; ++i) {
          bad |= past(w[i - wbase], glim);
          w[i - wbase] = kind == 0 ? (long long)cval
                         : i < 32  ? __ldg(wrow + i)
                                   : 0;
        }
      }
      for (int b = 0; b < a.ws; b += T) {
#pragma unroll
        for (int s = 0; s < T; s += 2) {
          longlong2 pr = *reinterpret_cast<const longlong2*>(w + b + s);
          const int i = wbase + b + s;
          // no branch in the walk: every prediction is formed and masked
          bad |= (i >= mlim) & (i < wend) & past(pr.x, glim);
          bad |= (i + 1 >= mlim) & (i + 1 < wend) & past(pr.y, glim);
          const Acc x0 = wadd((Acc)pr.x, predict<T>(tp, rg, s, shift) &
                                             -(Acc)(i >= order));
          rg.set(s, x0);
          const Acc x1 = wadd((Acc)pr.y, predict<T>(tp, rg, s + 1, shift) &
                                             -(Acc)(i + 1 >= order));
          rg.set(s + 1, x1);
          *reinterpret_cast<longlong2*>(w + b + s) =
              make_longlong2((long long)shl_wasted(x0, wasted),
                             (long long)shl_wasted(x1, wasted));
        }
      }
    }
    slot_arrive<BAR_FREE, NS, NT>(h);
  }
  if (bad) a.err[0] = 1;
}

template <int T, typename Acc>
int launch_iir(const Args& a, int blocks, cudaStream_t stream) {
  const int lanes = a.groups_per_block * a.c;
  const int smem =
      n_slots<Acc>() * lanes * (a.ws + 2) * (int)sizeof(long long);
  // past the 48 KB default, per device; as many blocks as fit
  static int allowed[flacx::MAX_DEVICES];
  const cudaError_t e =
      flacx::allow_smem(reconstruct_kernel_iir<T, Acc>, smem, allowed, 100);
  if (e != cudaSuccess) return (int)e;
  reconstruct_kernel_iir<T, Acc>
      <<<blocks, 32 * (1 + n_movers<Acc>()), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename Acc>
int launch(Args& a, int t, cudaStream_t stream) {
  if (a.fixed_max >= 0) {
    const int wpc = max(1, FX_WARPS / a.c);
    reconstruct_kernel_fixed<Acc><<<a.f, wpc * 32 * a.c, 0, stream>>>(a,
                                                                   wpc);
    return (int)cudaGetLastError();
  }
  // one warp of lanes a block; windows of WS_MAX samples (or half a
  // short chunk) rounded up to the tap bucket
  a.groups_per_block = max(1, 32 / a.c);
  const int half = min((a.chunk + 1) / 2, WS_MAX);
  a.ws = (half + t - 1) / t * t;
  a.inv_hp = 0xffffffffu / ((a.ws + 1) / 2) + 1u;
  const long long blocks =
      (a.groups + a.groups_per_block - 1) / a.groups_per_block;
  switch (t) {
    case 4: return launch_iir<4, Acc>(a, (int)blocks, stream);
    case 8: return launch_iir<8, Acc>(a, (int)blocks, stream);
    case 12: return launch_iir<12, Acc>(a, (int)blocks, stream);
    case 16: return launch_iir<16, Acc>(a, (int)blocks, stream);
    case 32: return launch_iir<32, Acc>(a, (int)blocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// vals [f, c, n] int64; taps [f, c, 32]; shift, order, kind, wasted
// [f, c]; warmup [f, c, 32] int64; const_val [f, c] int64; state
// [f, c, ks, 32] or null (then ks = 1 and the chunk is n), int32, or
// int64 where state64 (with the int64 working type only); channel_code
// [f]; pcm [f, n, c] int32; err one int32 the caller zeroed.  t the tap
// bucket, wide: int64 working type, lim < 0: no residual guard, chunk
// the state interval (ignored without state), fixed_max: the all-fixed
// route's integration count (0..4; -1: an IIR route; no state).
// Returns the CUDA error code.
FLACX_API int flacx_reconstruct(const long long* vals, const int32_t* taps,
                                const int32_t* shift, const int32_t* order,
                                const int32_t* kind, const int32_t* wasted,
                                const long long* warmup,
                                const long long* const_val,
                                const void* state,
                                const int32_t* channel_code, int32_t* pcm,
                                int32_t* err, int f, int c, int n, int t,
                                int wide, int lim, int chunk, int ks,
                                int fixed_max, int state64,
                                cudaStream_t stream) {
  if (f <= 0 || c < 1 || c > 8 || n < 1 || lim > 62 || fixed_max > 4 ||
      (fixed_max >= 0 && state != nullptr) ||
      (state64 && (!wide || state == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (state == nullptr) {
    chunk = n;
    ks = 1;
  } else if (chunk < 1 || ks != (n + chunk - 1) / chunk) {
    return (int)cudaErrorInvalidValue;
  }
  // 16-byte copies where every lane's window starts 16-byte aligned
  const int a16 = ((uintptr_t)vals & 15u) == 0 && n % 2 == 0 &&
                  chunk % 2 == 0;
  Args a{vals, taps, shift, order, kind, wasted, warmup, const_val, state,
         channel_code, pcm, err, f, c, n, chunk, ks, lim,
         fixed_max < 0 ? -1 : fixed_max, state64 ? 1 : 0, 1, 0, a16, 0u,
         (long long)f * ks};
  return wide ? launch<long long>(a, t, stream)
              : launch<int32_t>(a, t, stream);
}
