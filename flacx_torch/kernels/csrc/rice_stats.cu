// rice_stats: the exact Rice-parameter search statistics of every
// partition of every requested partition order, from one read of zz.
//
// Replaces the TPU kernel flacx/kernels/rice_tile.py::rice_stats_tiles.
//
// Semantics (flacx_torch.ops.rice.rice_stats, bit for bit): for each
// partition of order po, count = psize - (partition 0 ? order : 0) and
//   bits(k) = S_k + (k+1)*count,  S_k = sum (zz >> k)      (int32 wrap)
//   bits(k) = SENT if (max >> k) + k + 1 > 32               (code-length cap)
// min5/arg5 = min/first argmin over k <= kmax, min4/arg4 over k <= 14,
// max = partition max.  Wrapped sums only occur where the cap already
// rejects k, so the eligible values are exact.
//
// Bound on the card: bytes.  zz is read once, 4 B/sample: 1024 x 2 x 4608
// at the headline = 37.7 MB, 11.3 us at 3.35 TB/s; the output is 5 x 63
// int32 per row.  Work: (kmax+1) shift-adds per sample (24 at 16-bit).
//
// Design: one block per (frame, channel) row.  Phase 1: one warp per
// finest partition (2^max_po of them, any partition size), each lane
// keeping the kmax+1 sums in registers, warp-shuffle reductions into
// shared memory.  Phase 2: one thread per (order, partition) entry sums
// its finest partitions for every k and runs the min/argmin with the
// lowest-k tie-break.  Any block size divisible by 2^max_po works; the
// only limit is shared memory ((kmax+2) * 2^max_po words <= 48 KB).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KMAX_MAX = 30;
constexpr int SENT = 1 << 28;
constexpr int CODE_BITS_MAX = 32;

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
