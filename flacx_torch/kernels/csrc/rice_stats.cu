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
//   bits(k) = SENT if (max >> k) + k + 1 > 32               (code-length cap)
// min5/arg5 = min/first argmin over k <= kmax, min4/arg4 over k <= 14,
// max = partition max.  Wrapped sums only occur where the cap already
// rejects k: an eligible k has zz >> k <= 31 - k for every sample of the
// partition, so S_k <= 31 * psize (< 2^19 at block 16384, the largest
// partition of any path) and bits(k) < 2^20.  The eligible values are
// exact.
//
// Two routes, picked by the wrapper from the size of the finest level's
// table, (kmax + 2) * 2^max_po words:
//
// smem (the table fits 48 KB; every path up to partition order 8).  One
// block per (frame, channel) row.  Phase 1: one warp per finest partition
// (2^max_po of them, any partition size), each lane keeping the kmax+1
// sums in registers, warp-shuffle reductions into shared memory.  Phase 2:
// one thread per (order, partition) entry sums its finest partitions for
// every k and runs the min/argmin with the lowest-k tie-break.  Bound:
// bytes.  zz is read once, 4 B/sample: 1024 x 2 x 4608 at the headline =
// 37.7 MB, 11.3 us at 3.35 TB/s; the output is 5 x 63 int32 per row.
// Work: (kmax+1) shift-adds per sample (24 at 16-bit).
//
// levels (many partitions: at block 16384 with orders 0..14 the table
// would be 2 MB per row).  No table: every partition of every level is
// searched straight from zz, which the row's levels re-read from L1/L2.
// A partition of fewer than 32 samples is one thread's (its kmax+1 sums
// in registers; a warp takes 32 neighbouring partitions, so its reads and
// its output writes are contiguous); a larger one is one warp's, reduced
// with __reduce_add_sync.  The warps of the row's LEVELS_SPLIT blocks walk
// the (level, partition group) units of all levels in one flat loop, so
// no level waits for another and 256 rows still fill the card.  Bound:
// bytes, set by the output: at the hi-res shape (256 rows of 16384
// samples, 32767 partitions a row) zz is 16.8 MB read and the statistics
// 168 MB written, 55 us at 3.35 TB/s.  Work: (kmax+1) shift-adds per
// sample per level, 15 x 31 at hi-res.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KMAX_MAX = 30;
constexpr int SENT = 1 << 28;
constexpr int CODE_BITS_MAX = 32;
constexpr int LEVELS_SPLIT = 8;  // blocks per row of the levels route

__global__ void __launch_bounds__(THREADS)
rice_stats_kernel(const int32_t* __restrict__ zz,
                  const int32_t* __restrict__ order, int32_t* __restrict__ out,
                  int n, int max_po, unsigned po_mask, int kmax, int tot) {
  extern __shared__ uint32_t smem[];
  const int nparts = 1 << max_po;
  const int psize = n >> max_po;
  const int K = kmax + 1;
  uint32_t* S = smem;               // [K][nparts]
  uint32_t* M = smem + K * nparts;  // [nparts]

  const int row = blockIdx.x;
  const uint32_t* zr = reinterpret_cast<const uint32_t*>(zz) + (size_t)row * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int p = warp; p < nparts; p += THREADS / 32) {
    uint32_t acc[KMAX_MAX + 1];
#pragma unroll
    for (int k = 0; k <= KMAX_MAX; ++k) acc[k] = 0;
    uint32_t m = 0;
    const uint32_t* zp = zr + (size_t)p * psize;
    for (int i = lane; i < psize; i += 32) {
      const uint32_t z = zp[i];
      m = max(m, z);
#pragma unroll
      for (int k = 0; k <= KMAX_MAX; ++k)
        if (k < K) acc[k] += z >> k;
    }
    m = flacx::warp_max(m);
#pragma unroll
    for (int k = 0; k <= KMAX_MAX; ++k) {
      if (k < K) {
        const uint32_t v = flacx::warp_sum(acc[k]);
        if (lane == 0) S[k * nparts + p] = v;
      }
    }
    if (lane == 0) M[p] = m;
  }
  __syncthreads();

  const int ord = order[row];
  const int n_k4 = min(kmax, 14) + 1;
  int32_t* o = out + (size_t)row * 5 * tot;
  for (int e = threadIdx.x; e < tot; e += THREADS) {
    int off = 0, po = 0;
    for (int q = 0; q <= max_po; ++q) {
      if (!((po_mask >> q) & 1u)) continue;
      if (e < off + (1 << q)) {
        po = q;
        break;
      }
      off += 1 << q;
    }
    const int part = e - off;
    const int span = 1 << (max_po - po);
    const int first = part * span;
    const int cnt = (n >> po) - (part == 0 ? ord : 0);
    uint32_t m = 0;
    for (int f = 0; f < span; ++f) m = max(m, M[first + f]);
    int min4 = SENT, arg4 = 0, min5 = SENT, arg5 = 0;
    for (int k = 0; k < K; ++k) {
      uint32_t s = 0;
      for (int f = 0; f < span; ++f) s += S[k * nparts + first + f];
      int bits = (int)(s + (uint32_t)(k + 1) * (uint32_t)cnt);
      const int code = (int)((m >> k) + (uint32_t)(k + 1));
      if (code > CODE_BITS_MAX) bits = SENT;
      if (bits < min5) {
        min5 = bits;
        arg5 = k;
      }
      if (k < n_k4 && bits < min4) {
        min4 = bits;
        arg4 = k;
      }
    }
    o[e] = min4;
    o[tot + e] = arg4;
    o[2 * tot + e] = min5;
    o[3 * tot + e] = arg5;
    o[4 * tot + e] = (int32_t)m;
  }
}

// Writes the (min4, arg4, min5, arg5, max) of one partition, given its
// kmax+1 sums, its max and its count, at entry e of the row's output.
__device__ __forceinline__ void search(const uint32_t (&acc)[KMAX_MAX + 1],
                                       uint32_t m, int K, int cnt,
                                       int32_t* o, int tot, int e) {
  const int n_k4 = min(K - 1, 14) + 1;
  int min4 = SENT, arg4 = 0, min5 = SENT, arg5 = 0;
#pragma unroll
  for (int k = 0; k <= KMAX_MAX; ++k) {
    if (k < K) {
      int bits = (int)(acc[k] + (uint32_t)(k + 1) * (uint32_t)cnt);
      const int code = (int)((m >> k) + (uint32_t)(k + 1));
      if (code > CODE_BITS_MAX) bits = SENT;
      if (bits < min5) {
        min5 = bits;
        arg5 = k;
      }
      if (k < n_k4 && bits < min4) {
        min4 = bits;
        arg4 = k;
      }
    }
  }
  o[e] = min4;
  o[tot + e] = arg4;
  o[2 * tot + e] = min5;
  o[3 * tot + e] = arg5;
  o[4 * tot + e] = (int32_t)m;
}

__global__ void __launch_bounds__(THREADS)
rice_stats_levels_kernel(const int32_t* __restrict__ zz,
                         const int32_t* __restrict__ order,
                         int32_t* __restrict__ out, int n, int max_po,
                         unsigned po_mask, int kmax, int tot) {
  constexpr int WARPS = THREADS / 32;
  const int row = blockIdx.x;
  const uint32_t* zr = reinterpret_cast<const uint32_t*>(zz) + (size_t)row * n;
  int32_t* o = out + (size_t)row * 5 * tot;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = kmax + 1;
  const int ord = order[row];

  // units: per level, one per partition of >= 32 samples, else one per
  // group of 32 partitions
  int units = 0;
  for (int q = 0; q <= max_po; ++q)
    if ((po_mask >> q) & 1u)
      units += (n >> q) >= 32 ? 1 << q : ((1 << q) + 31) >> 5;

  // the row's gridDim.y blocks share its units, a warp at a time
  for (int u = blockIdx.y * WARPS + warp; u < units; u += gridDim.y * WARPS) {
    int q = 0, off = 0, first = u;
    for (;; ++q) {
      if (!((po_mask >> q) & 1u)) continue;
      const int lu = (n >> q) >= 32 ? 1 << q : ((1 << q) + 31) >> 5;
      if (first < lu) break;
      first -= lu;
      off += 1 << q;
    }
    const int psize = n >> q;
    uint32_t acc[KMAX_MAX + 1];
#pragma unroll
    for (int k = 0; k <= KMAX_MAX; ++k) acc[k] = 0;
    uint32_t m = 0;
    if (psize >= 32) {  // one warp per partition
      const int part = first;
      const uint32_t* zp = zr + (size_t)part * psize;
      for (int i = lane; i < psize; i += 32) {
        const uint32_t z = __ldg(zp + i);
        m = max(m, z);
#pragma unroll
        for (int k = 0; k <= KMAX_MAX; ++k)
          if (k < K) acc[k] += z >> k;
      }
      m = __reduce_max_sync(flacx::FULL_MASK, m);
#pragma unroll
      for (int k = 0; k <= KMAX_MAX; ++k)
        if (k < K) acc[k] = __reduce_add_sync(flacx::FULL_MASK, acc[k]);
      if (lane == 0)
        search(acc, m, K, psize - (part == 0 ? ord : 0), o, tot, off + part);
    } else {  // one thread per partition
      const int part = first * 32 + lane;
      if (part < (1 << q)) {
        const uint32_t* zp = zr + (size_t)part * psize;
        for (int i = 0; i < psize; ++i) {
          const uint32_t z = __ldg(zp + i);
          m = max(m, z);
#pragma unroll
          for (int k = 0; k <= KMAX_MAX; ++k)
            if (k < K) acc[k] += z >> k;
        }
        search(acc, m, K, psize - (part == 0 ? ord : 0), o, tot, off + part);
      }
    }
  }
}

}  // namespace

// Shared memory the kernel needs for max_po / kmax (bytes).
FLACX_API int flacx_rice_stats_smem(int max_po, int kmax) {
  return (kmax + 2) * (1 << max_po) * (int)sizeof(uint32_t);
}

// zz int32 [rows, n], order int32 [rows] -> out int32 [rows, 5, tot] with
// tot = sum of 2^po over the orders set in po_mask (levels ascending).
FLACX_API int flacx_rice_stats(const int32_t* zz, const int32_t* order,
                               int32_t* out, int rows, int n, int max_po,
                               int po_mask, int kmax, int tot,
                               cudaStream_t stream) {
  const int smem = flacx_rice_stats_smem(max_po, kmax);
  if (rows <= 0 || max_po < 0 || max_po > 15 || (n >> max_po) < 1 ||
      ((n >> max_po) << max_po) != n || kmax < 0 || kmax > KMAX_MAX ||
      smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  rice_stats_kernel<<<rows, THREADS, smem, stream>>>(
      zz, order, out, n, max_po, (unsigned)po_mask, kmax, tot);
  return (int)cudaGetLastError();
}

// The levels route: the same arguments and output, any partition count.
FLACX_API int flacx_rice_stats_levels(const int32_t* zz, const int32_t* order,
                                      int32_t* out, int rows, int n,
                                      int max_po, int po_mask, int kmax,
                                      int tot, cudaStream_t stream) {
  if (rows <= 0 || max_po < 0 || max_po > 15 || (n >> max_po) < 1 ||
      ((n >> max_po) << max_po) != n || kmax < 0 || kmax > KMAX_MAX ||
      !((po_mask >> max_po) & 1))
    return (int)cudaErrorInvalidValue;
  rice_stats_levels_kernel<<<dim3(rows, LEVELS_SPLIT), THREADS, 0, stream>>>(
      zz, order, out, n, max_po, (unsigned)po_mask, kmax, tot);
  return (int)cudaGetLastError();
}
