// rice_stats: the exact Rice-parameter search statistics of every
// partition of every requested partition order, from zz.
//
// Replaces the TPU kernel flacx/kernels/rice_tile.py::rice_stats_tiles,
// its whole-row form (:266) and its chunked form for levels past a tile
// (:293).
//
// Semantics (flacx_torch.ops.rice.rice_stats, bit for bit): for each
// partition of order po, count = psize - (partition 0 ? order : 0) and
//   bits(k) = S_k + (k+1)*count,  S_k = sum (zz >> k)      (int32 wrap)
//   bits(k) = SENT if (max >> k) + k + 1 > 32 in int32     (code-length cap)
// min5/arg5 = min/first argmin over k <= kmax, min4/arg4 over k <= 14,
// max = partition max.  Wrapped sums only occur where the cap already
// rejects k: an eligible k has zz >> k <= 31 - k for every sample of the
// partition, so S_k <= 31 * psize and the eligible values are exact.  The
// one exception is max = 2^31 - 1, whose k = 0 passes the int32 cap by
// wrapping with a cost above SENT in the plain version's int64: it never
// wins there unless it is the only k.
//
// int64 zz (past 24-bit samples, the encoder's int64 working type): each
// value is read as min(zz, 2^31) into the same uint32 tree, and the
// statistics equal the plain int64 search's (ops.rice.rice_stats on int64
// zz) in every value exact_plan uses.  Proof: a Rice parameter k <= kmax
// <= 30 is eligible only where (max >> k) + k + 1 <= 32, i.e. max < (32 -
// k) * 2^k <= 2^31 (the largest at k = 30), and an escape only where E =
// bitlen(max) <= 31, i.e. max < 2^31.  So a partition that any coding can
// take has every value below 2^31, read unchanged: its sums, max and
// search are the int64 ones.  A partition holding a value >= 2^31 reads
// max 2^31, and so does every coarser partition over it (a max of maxes):
// bitlen 32, every k fails the cap ((2^31 >> 30) + 31 = 33 > 32), E = 32
// passes 31, min = SENT and arg = 0, as the int64 search has them (its
// sums may wrap, but no cost is formed from them).  On this route the cap
// is checked in unsigned arithmetic, which cannot wrap for max <= 2^31: a
// max of 2^31 - 1 rejects k = 0, as in int64, with no int32 exception.
// The max is written as int32, so 2^31 comes out as -2^31; exact_plan
// reads it back as unsigned.
//
// Design: one bottom-up partition tree.  S_k is additive over samples,
// uint32 wrap included, so a partition's sums are its two children's sums
// added and its max the larger of theirs.  A block takes a partition-
// aligned segment of a row (2^s segments, s the least whose table fits 48
// KB of shared memory), reads its zz once and coalesced (16 B a thread),
// builds the finest stored level, then every coarser level inside the
// segment from the one below, and searches all of them from the table:
// no level reads zz again.  The finest stored level is summed
//   from zz staged in shared memory, one thread per (partition, k), where
//   its partitions are under 32 samples (hi-res, the 9-sample levels), or
//   straight from device memory, one warp a partition with the K sums in
//   registers and warp reductions, past that (the headline's 144, the best
//   path's 36 to 144).
// One-sample partitions (hi-res -r ..14 at 16384) need no table: S_k = zz
// >> k, searched from the staged zz; their parent level is the first one
// stored.  Levels coarser than a segment (hi-res: orders 0..5 over 64
// segments of 256 samples) are finished by the row's last block (atomic
// ticket after __threadfence) from the segment sums the blocks leave in a
// device-memory scratch the wrapper allocates.  The search runs one thread
// a partition over k, downwards from the partition max's bit length (S_k
// is 0 past it and the cost only grows, for counts > 0) to the first k
// the code-length cap rejects (it rejects every smaller k too), keeping
// the lowest k on ties.  Output entries of a level are written by
// consecutive threads, coalesced, in the [rows, 5, tot] layout exact_plan
// reads.
//
// Bound: bytes, set by the output at hi-res: 256 rows of 16384 samples,
// 32767 partitions a row, 16.8 MB of zz read and 168 MB of statistics
// written, 55 us at 3.35 TB/s; 12 us at the headline (37.7 MB of zz); the
// int64 route reads 8 B a value (23 us for 1024 x 2 x 4608).
// Work: (kmax+1) shift-adds per sample at the finest stored level, (kmax
// + 2) adds a partition per coarser level, and a few k a partition in the
// search.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KMAX_MAX = 30;
constexpr int SENT = 1 << 28;
constexpr int CODE_BITS_MAX = 32;
constexpr int SMEM_BUDGET = 48 * 1024;
constexpr int STAGE_BELOW = 32;  // finest stored partitions summed from smem
constexpr int WIN = 7;           // sums a tree entry keeps (see window_lo)

// The segment plan, the same on host and card (and in the wrapper's
// segment_log2): table entries hold K sums and the max at an odd stride
// KS, level q of a segment (2^q partitions) at entries 2^q - 1 .. 2^(q+1)
// - 2.
struct Plan {
  int K, KS;   // kmax + 1 sums; the table stride
  int lo;      // the finest stored level (max_po, or max_po - 1 over
               // one-sample partitions)
  int psize;   // its partition size
  int s, seg;  // 2^s segments of seg samples a row
  int qlo;     // level lo within a segment
  bool staged;
};

__host__ __device__ inline Plan make_plan(int n, int max_po, int kmax,
                                          int s) {
  Plan P;
  P.K = kmax + 1;
  P.KS = (P.K + 1) | 1;
  P.lo = ((n >> max_po) == 1 && max_po > 0) ? max_po - 1 : max_po;
  P.psize = n >> P.lo;
  P.s = s;
  P.seg = n >> s;
  P.qlo = P.lo - s;
  P.staged = P.psize < STAGE_BELOW;
  return P;
}

__host__ __device__ inline int zs_words(const Plan& P) {
  return P.staged ? (P.seg + 3) & ~3 : 0;
}

__host__ __device__ inline int smem_bytes(const Plan& P) {
  return (zs_words(P) + ((2 << P.qlo) - 1) * P.KS) * (int)sizeof(uint32_t);
}

// f(e, k) for every entry e < count and column k < kc (k fastest), the
// block's threads striding over them.
template <typename F>
__device__ __forceinline__ void for_each_entry(int count, int kc, F f) {
  int e = threadIdx.x / kc, k = threadIdx.x - e * kc;
  const int de = THREADS / kc, dk = THREADS - de * kc;
  while (e < count) {
    f(e, k);
    e += de;
    k += dk;
    if (k >= kc) {
      k -= kc;
      ++e;
    }
  }
}

__device__ __forceinline__ int bitlen(uint32_t m) { return 32 - __clz(m); }

// An int64 zz value as the tree reads it: min(zz, 2^31) (zz >= 0).
__device__ __forceinline__ uint32_t saturate(long long z) {
  return (unsigned long long)z < (1ull << 31) ? (uint32_t)z : 1u << 31;
}

// zz values of a row, int32 or (Z64) int64 read through saturate(): one
// at index i, or four at 4 * i4 (16-byte aligned).
template <bool Z64>
struct Zz {
  const void* p;
  __device__ __forceinline__ uint32_t at(size_t i) const {
    if (Z64) return saturate(__ldg(static_cast<const long long*>(p) + i));
    return __ldg(static_cast<const uint32_t*>(p) + i);
  }
  __device__ __forceinline__ uint4 four(size_t i4) const {
    if (Z64) {
      const longlong2* q = static_cast<const longlong2*>(p) + 2 * i4;
      const longlong2 a = __ldg(q), b = __ldg(q + 1);
      return make_uint4(saturate(a.x), saturate(a.y), saturate(b.x),
                        saturate(b.y));
    }
    return __ldg(static_cast<const uint4*>(p) + i4);
  }
};

// The first of the WIN values of k whose sums a partition of max m keeps:
// below bitlen(m) - 6, m >> k >= 64 and the code-length cap rejects k, and
// past bitlen(m) S_k = 0.  A parent's window starts no lower than its
// children's, so the sums it adds up are theirs, or 0.
__device__ __forceinline__ int window_lo(uint32_t m, int K) {
  return min(max(0, bitlen(m) - (WIN - 1)), K - 1);
}

// One tree level from the one below: entry e from children 2e, 2e + 1,
// read through rd(child, column) and written through wr(e, column, v);
// the max at column K.
template <typename RD, typename WR>
__device__ __forceinline__ void add_level(int count, int K, RD rd, WR wr) {
  for_each_entry(count, WIN + 1, [&](int e, int w) {
    const uint32_t m0 = rd(2 * e, K), m1 = rd(2 * e + 1, K);
    const uint32_t m = max(m0, m1);
    if (w == WIN) {
      wr(e, K, m);
      return;
    }
    const int k = window_lo(m, K) + w;
    if (k > min(K - 1, bitlen(m))) return;
    wr(e, k, (k > bitlen(m0) ? 0u : rd(2 * e, k)) +
                 (k > bitlen(m1) ? 0u : rd(2 * e + 1, k)));
  });
}

// Writes the (min4, arg4, min5, arg5, max) of one partition, given S(k),
// its max and its count, at entry `at` of the row's output.  Z64: the cap
// in unsigned arithmetic (m <= 2^31), else in int32 as the plain version.
template <bool Z64, typename SK>
__device__ __forceinline__ void search(SK S, uint32_t m, int K, int cnt,
                                       int32_t* o, int tot, int at) {
  const int k4 = min(K - 1, 14);
  int min4 = SENT, arg4 = 0, min5 = SENT, arg5 = 0;
  // (m >> 0) + 1 wraps in int32: k = 0 passes the cap at a cost above
  // SENT, so the all-ineligible argmin is k = 1, unless k = 0 is alone
  const bool wrap = !Z64 && m == 0x7fffffffu;
  if (wrap) {
    if (K == 1)
      min4 = min5 = (int)(S(0) + (uint32_t)cnt);
    else
      arg4 = arg5 = 1;
  }
  int kh = K - 1;
  if (cnt > 0) kh = min(kh, bitlen(m));  // S_k = 0 past bitlen(m)
  for (int k = kh; k >= (wrap ? 1 : 0); --k) {
    const uint32_t code = (m >> k) + (uint32_t)(k + 1);
    if (Z64 ? code > (uint32_t)CODE_BITS_MAX : (int)code > CODE_BITS_MAX)
      break;
    const int bits = (int)(S(k) + (uint32_t)(k + 1) * (uint32_t)cnt);
    if (bits <= min5) {
      min5 = bits;
      arg5 = k;
    }
    if (k <= k4 && bits <= min4) {
      min4 = bits;
      arg4 = k;
    }
  }
  o[at] = min4;
  o[tot + at] = arg4;
  o[2 * tot + at] = min5;
  o[3 * tot + at] = arg5;
  o[4 * tot + at] = (int32_t)m;
}

template <bool Z64>
__global__ void __launch_bounds__(THREADS)
rice_stats_kernel(const void* __restrict__ zz,
                  const int32_t* __restrict__ order, int32_t* __restrict__ out,
                  uint32_t* __restrict__ scratch, int* __restrict__ tickets,
                  int n, int max_po, unsigned po_mask, int kmax,
                  int seg_log2) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Plan P = make_plan(n, max_po, kmax, seg_log2);
  const int K = P.K, KS = P.KS, KC = K + 1;  // columns: K sums, the max
  const int nseg = 1 << P.s;
  const int row = blockIdx.x >> P.s, sg = blockIdx.x & (nseg - 1);
  const size_t first = (size_t)row * n + (size_t)sg * P.seg;
  const Zz<Z64> zr{Z64 ? static_cast<const void*>(
                            static_cast<const long long*>(zz) + first)
                      : static_cast<const void*>(
                            static_cast<const int32_t*>(zz) + first)};
  uint32_t* zs = smem;
  uint32_t* S = smem + zs_words(P);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ord = order[row];
  const int tot = (int)po_mask;  // the levels' 2^po entries
  int32_t* o = out + (size_t)row * 5 * tot;

  // ----- the finest stored level of the segment --------------------------
  const int ps = P.psize;
  const int lo_base = (1 << P.qlo) - 1;
  if (P.staged) {
    if ((first & 3) == 0 && (P.seg & 3) == 0) {
      for (int i = threadIdx.x; i < P.seg / 4; i += THREADS)
        reinterpret_cast<uint4*>(zs)[i] = zr.four(i);
    } else {
      for (int i = threadIdx.x; i < P.seg; i += THREADS) zs[i] = zr.at(i);
    }
    __syncthreads();
    for_each_entry(1 << P.qlo, WIN + 1, [&](int e, int w) {
      const uint32_t* zp = zs + e * ps;
      uint32_t m = 0;
      for (int i = 0; i < ps; ++i) m = max(m, zp[i]);
      const int k = w == WIN ? K : window_lo(m, K) + w;
      if (w < WIN && k > min(K - 1, bitlen(m))) return;
      uint32_t v = m;
      if (k < K) {
        v = 0;
        for (int i = 0; i < ps; ++i) v += zp[i] >> k;
      }
      S[(lo_base + e) * KS + k] = v;
    });
  } else {
    const bool vec = (first & 3) == 0 && (ps & 3) == 0;
    for (int e = warp; e < (1 << P.qlo); e += WARPS) {
      const size_t e0 = (size_t)e * ps;  // the partition's first value
      uint32_t acc[KMAX_MAX + 1];
#pragma unroll
      for (int k = 0; k <= KMAX_MAX; ++k) acc[k] = 0;
      uint32_t m = 0;
      if (vec) {
        for (int i = lane; i < ps / 4; i += 32) {
          const uint4 v = zr.four(e0 / 4 + i);
          m = max(m, max(max(v.x, v.y), max(v.z, v.w)));
#pragma unroll
          for (int k = 0; k <= KMAX_MAX; ++k)
            if (k < K)
              acc[k] += (v.x >> k) + (v.y >> k) + (v.z >> k) + (v.w >> k);
        }
      } else {
        for (int i = lane; i < ps; i += 32) {
          const uint32_t z = zr.at(e0 + i);
          m = max(m, z);
#pragma unroll
          for (int k = 0; k <= KMAX_MAX; ++k)
            if (k < K) acc[k] += z >> k;
        }
      }
      uint32_t mine = __reduce_max_sync(flacx::FULL_MASK, m);  // lane K's
#pragma unroll
      for (int k = 0; k <= KMAX_MAX; ++k) {
        if (k < K) {
          const uint32_t v = __reduce_add_sync(flacx::FULL_MASK, acc[k]);
          if (lane == k) mine = v;
        }
      }
      if (lane < KC) S[(lo_base + e) * KS + lane] = mine;
    }
  }

  // ----- every coarser level inside the segment, from the one below ------
  for (int q = P.qlo - 1; q >= 0; --q) {
    __syncthreads();
    const int b = (1 << q) - 1, c = (2 << q) - 1;
    add_level(
        1 << q, K, [&](int ch, int k) { return S[(c + ch) * KS + k]; },
        [&](int e, int k, uint32_t v) { S[(b + e) * KS + k] = v; });
  }
  __syncthreads();
  // the row's segment sums and coarser levels, a heap as the table's
  uint32_t* H =
      nseg > 1 ? scratch + (size_t)row * (2 * nseg - 1) * KS : nullptr;
  if (H && threadIdx.x < KC)
    __stcg(H + (nseg - 1 + sg) * KS + threadIdx.x, S[threadIdx.x]);

  // ----- search every requested level inside the segment -----------------
  int total = 0;
  for (int po = P.s; po <= max_po; ++po)
    if ((po_mask >> po) & 1u) total += 1 << (po - P.s);
  for (int it = threadIdx.x; it < total; it += THREADS) {
    int po = P.s, e = it;
    for (;; ++po) {
      if (!((po_mask >> po) & 1u)) continue;
      if (e < 1 << (po - P.s)) break;
      e -= 1 << (po - P.s);
    }
    const int pg = (sg << (po - P.s)) + e;
    const int cnt = (n >> po) - (pg == 0 ? ord : 0);
    const int at = (int)(po_mask & ((1u << po) - 1u)) + pg;
    if (po > P.lo) {  // one-sample partitions
      const uint32_t z = zs[e];
      search<Z64>([&](int k) { return z >> k; }, z, K, cnt, o, tot, at);
    } else {
      const uint32_t* Se = S + ((1 << (po - P.s)) - 1 + e) * KS;
      const int bl = bitlen(Se[K]);
      search<Z64>([&](int k) { return k > bl ? 0u : Se[k]; }, Se[K], K, cnt,
                  o, tot, at);
    }
  }
  if (nseg == 1) return;

  // ----- levels coarser than a segment: the row's last block -------------
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + row, 1) == nseg - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int q = P.s - 1; q >= 0; --q) {
    const int b = (1 << q) - 1, c = (2 << q) - 1;
    add_level(
        1 << q, K,
        [&](int ch, int k) { return __ldcg(H + (c + ch) * KS + k); },
        [&](int e, int k, uint32_t v) { __stcg(H + (b + e) * KS + k, v); });
    __syncthreads();
  }
  const int coarse = (int)(po_mask & ((1u << P.s) - 1u));  // 2^po summed
  for (int it = threadIdx.x; it < coarse; it += THREADS) {
    int po = 0, e = it;
    for (;; ++po) {
      if (!((po_mask >> po) & 1u)) continue;
      if (e < 1 << po) break;
      e -= 1 << po;
    }
    const uint32_t* He = H + ((1 << po) - 1 + e) * KS;
    const uint32_t m = __ldcg(He + K);
    const int bl = bitlen(m);
    search<Z64>([&](int k) { return k > bl ? 0u : __ldcg(He + k); }, m, K,
                (n >> po) - (e == 0 ? ord : 0), o, tot,
                (int)(po_mask & ((1u << po) - 1u)) + e);
  }
}

}  // namespace

// zz int32 [rows, n] (>= 0), or int64 when z64 != 0, order int32 [rows]
// -> out int32 [rows, 5, po_mask]: the 2^po entries of every order set in
// po_mask, levels ascending.  seg_log2: the row's 2^seg_log2 segments
// (the wrapper's segment_log2); past 0, scratch holds rows x
// (2^(seg_log2+1) - 1) x KS words and tickets rows zeros.  Returns the CUDA error code of the
// launch.
FLACX_API int flacx_rice_stats(const void* zz, const int32_t* order,
                               int32_t* out, uint32_t* scratch, int* tickets,
                               int rows, int n, int max_po, int po_mask,
                               int kmax, int seg_log2, int z64,
                               cudaStream_t stream) {
  if (rows <= 0 || max_po < 0 || max_po > 15 || (n >> max_po) < 1 ||
      ((n >> max_po) << max_po) != n || kmax < 0 || kmax > KMAX_MAX ||
      (po_mask >> max_po) != 1)
    return (int)cudaErrorInvalidValue;
  const Plan P = make_plan(n, max_po, kmax, seg_log2);
  if (seg_log2 < 0 || seg_log2 > P.lo || smem_bytes(P) > SMEM_BUDGET ||
      (seg_log2 > 0 && (!scratch || !tickets)))
    return (int)cudaErrorInvalidValue;
  if (z64)
    rice_stats_kernel<true><<<rows << seg_log2, THREADS, smem_bytes(P),
                               stream>>>(zz, order, out, scratch, tickets, n,
                                         max_po, (unsigned)po_mask, kmax,
                                         seg_log2);
  else
    rice_stats_kernel<false><<<rows << seg_log2, THREADS, smem_bytes(P),
                                stream>>>(zz, order, out, scratch, tickets,
                                          n, max_po, (unsigned)po_mask, kmax,
                                          seg_log2);
  return (int)cudaGetLastError();
}
