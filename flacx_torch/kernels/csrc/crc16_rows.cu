// crc16_rows: every frame row's CRC-16 checked against the two bytes
// stored at its end.
//
// Replaces flacx/ops/crcfold.py::crc16_over_rows (:142) and the check of
// flacx/decoder.py:428-437 around it (XLA in flacx, no Pallas kernel).
//
// Semantics (flacx_torch.kernels.crc16_rows.crc16_rows_plain): for row f
// of length lens[f], ok[f] = CRC-16(rows[f, :lens[f] - 2]) (poly 0x18005,
// init 0, MSB first) == rows[f, lens[f] - 2] << 8 | rows[f, lens[f] - 1];
// all_ok = 0 where any row fails (the caller sets it to 1).
//
// Bound on the card: bytes.  The frame bytes are read once (3.4 MB for
// 256 frames of 16-bit stereo at block 4608: 1.0 us at 3.35 TB/s), near
// the card's launch floor (`flacx_empty` times an empty kernel of the same
// grid, clusters included).
//
// Design.  A row's body is m big-endian 32-bit words (bytes past it
// masked to zero) cut into pieces of PIECE_WORDS; S blocks of WARPS warps
// a row (S from the row width, at most 8: a cluster; one block a row is a
// plain launch), warp w of block b taking pieces b * WARPS + w, then
// every S * WARPS-th.  A warp copies a piece into its shared slots by
// coalesced 16-byte cp.async copies (4-byte ones where the rows are not
// 16-byte aligned), lane i's run of RUN_WORDS consecutive words at word
// (RUN_WORDS + 4) i so its 16-byte reads meet distinct banks; the first
// piece is in flight with the tables before the row's length is read, and
// a lane reads its run into registers and starts the copy of its next
// piece before folding.  Each lane folds its run with the sliced tables
// tab[k][i] = i x^(16 + 8k) mod P (P the polynomial), v = w ^ (crc << 16),
// then four lookups a word: no multiply a word.  crc(A | B) = crc(A)
// x^(8 |B|) + crc(B): the run's CRC is shifted to the body's padded end by
// one or two GF(2) products with x^(32 d) (d the words after the run, from
// tables of x^(32 d) for d < 1024, x^(32 * 1024 j) and x^(32 * 2^20 k),
// read while the piece is in flight) and XORed into the lane's total: the
// terms add in any order.  The warp XORs its lanes, the block its warps,
// block 0 of a cluster the cluster's blocks through distributed shared
// memory; it undoes the 0-3 zero bytes after the body with x^(-8 pad) and
// checks the stored bytes (both read as soon as the length is known).
// Every block stages the tables (4 KB) once, in flight with its first
// piece.  Measured and dropped (PERF.md): four interleaved folds a lane,
// runs of 8 and 32 words, nibble tables (conflict-free lookups but twice
// as many).

#include <cooperative_groups.h>

#include "common.cuh"
#include "crc16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RUN_WORDS = 16;                 // a lane's run of a piece
constexpr int PIECE_WORDS = 32 * RUN_WORDS;   // 2 KB
constexpr int STRIDE = RUN_WORDS + 4;         // shared words a run
constexpr int MAX_CLUSTER = 8;                // blocks a row at most
// constants: the tables, x^(32 d) for d < 1024, x^(32 * 1024 j) for j <
// 1024, x^(32 * 2^20 k) for k < 512, x^(-8 p) for p < 4
constexpr int LO = 1024, MID = LO + 1024, HI = MID + 1024, INV = HI + 512;

__device__ __forceinline__ uint32_t fold_word(uint32_t crc, uint32_t w,
                                              const uint32_t (*tab)[256]) {
  const uint32_t v = w ^ (crc << 16);
  return tab[3][v >> 24] ^ tab[2][(v >> 16) & 0xffu] ^
         tab[1][(v >> 8) & 0xffu] ^ tab[0][v & 0xffu];
}

// x^(32 d) mod P as up to three factors from the tables, read ahead of
// their use (the product waits for them, not the reads for the fold)
struct Power {
  uint32_t lo, mid, hi;
  int d;

  __device__ __forceinline__ void fetch(int words, const uint32_t* consts) {
    d = words;
    lo = __ldg(consts + LO + (d & 1023));
    mid = d >= 1024 ? __ldg(consts + MID + ((d >> 10) & 1023)) : 1u;
    hi = d >= (1 << 20) ? __ldg(consts + HI + (d >> 20)) : 1u;
  }

  // a * x^(32 d) mod P
  __device__ __forceinline__ uint32_t times(uint32_t a,
                                            const uint32_t (*tab)[256]) const {
    a = flacx::gf_mulmod16(a, lo, tab);
    if (d >= 1024) a = flacx::gf_mulmod16(a, mid, tab);
    if (d >= (1 << 20)) a = flacx::gf_mulmod16(a, hi, tab);
    return a;
  }
};

// The copy of piece p of a row (words [p * PIECE_WORDS, ...) of `row`, up
// to the body's m words) into a warp's slots.
template <bool VEC>
__device__ __forceinline__ void copy_piece(uint32_t* slots,
                                           const uint32_t* row, int p, int m,
                                           int lane) {
  const int w0 = p * PIECE_WORDS;
  if (VEC) {
#pragma unroll
    for (int q = 0; q < PIECE_WORDS / 4 / 32; ++q) {
      const int c = lane + 32 * q;  // 16-byte chunk of the piece
      if (w0 + 4 * c < m)
        flacx::cp_async16(slots + STRIDE * (c / (RUN_WORDS / 4)) +
                              4 * (c % (RUN_WORDS / 4)),
                          row + w0 + 4 * c);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < PIECE_WORDS / 32; ++q) {
      const int i = lane + 32 * q;  // word of the piece
      if (w0 + i < m)
        flacx::cp_async4(slots + STRIDE * (i / RUN_WORDS) + i % RUN_WORDS,
                         row + w0 + i);
    }
  }
  flacx::cp_async_commit();
}

template <bool VEC, bool CLUSTER>
__global__ void __launch_bounds__(THREADS)
crc16_rows_kernel(const uint32_t* __restrict__ rows,
                  const int32_t* __restrict__ lens,
                  const uint32_t* __restrict__ consts, int32_t* ok,
                  int32_t* all_ok, int nw) {
  __shared__ __align__(16) uint32_t tab[4][256];
  __shared__ __align__(16) uint32_t slots[WARPS][32 * STRIDE];
  __shared__ uint32_t part[WARPS];
  __shared__ uint32_t block_crc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int S = 1, b = 0;
  if constexpr (CLUSTER) {
    S = cg::this_cluster().num_blocks();
    b = cg::this_cluster().block_rank();
  }
  const int f = blockIdx.x / S;
  const uint32_t* row = rows + (long long)f * nw;
  const int step = S * WARPS;
  uint32_t* mine = slots[warp];

  // the warp's first piece (up to the row's width: the length is not read
  // yet) and the tables in flight together, then the length
  int p = b * WARPS + warp;
  if (p * PIECE_WORDS < nw) copy_piece<VEC>(mine, row, p, nw, lane);
  for (int i = threadIdx.x; i < 256; i += THREADS)
    flacx::cp_async16(&tab[0][0] + 4 * i, consts + 4 * i);
  flacx::cp_async_commit();
  const int len = lens[f];
  const int body = max(0, min(len - 2, 4 * nw));  // bytes under the CRC
  const int m = (body + 3) >> 2;                   // words holding them
  const int pieces = (m + PIECE_WORDS - 1) / PIECE_WORDS;
  const bool fits = len >= 2 && len <= 4 * nw;
  // read as soon as the length is known, so their latency overlaps the
  // copies: the stored bytes, x^(-8 pad), the first run's power
  uint32_t stored = 0, unpad = 1;
  if (b == 0 && threadIdx.x == 0) {
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(row);
    if (fits) stored = ((uint32_t)bytes[len - 2] << 8) | bytes[len - 1];
    unpad = __ldg(consts + INV + (4 * m - body));
  }
  Power pw;
  int r0 = p * PIECE_WORDS + RUN_WORDS * lane;  // the run's first word
  if (p < pieces) pw.fetch(m - min(r0 + RUN_WORDS, m), consts);
  flacx::cp_async_wait<0>();
  __syncthreads();

  uint32_t total = 0;
  for (; p < pieces; p += step, r0 += step * PIECE_WORDS) {
    uint32_t w[RUN_WORDS];
    const uint4* run = reinterpret_cast<const uint4*>(mine + STRIDE * lane);
#pragma unroll
    for (int q = 0; q < RUN_WORDS / 4; ++q) {
      const uint4 v = run[q];
      w[4 * q] = v.x, w[4 * q + 1] = v.y, w[4 * q + 2] = v.z,
      w[4 * q + 3] = v.w;
    }
    __syncwarp();  // every lane has read its run: the slots are free
    Power next{};
    if (p + step < pieces) {
      copy_piece<VEC>(mine, row, p + step, m, lane);
      const int n0 = r0 + step * PIECE_WORDS;
      next.fetch(m - min(n0 + RUN_WORDS, m), consts);
    }
    const int r1 = min(r0 + RUN_WORDS, m);
    if (r0 < r1) {
      uint32_t crc = 0;
#pragma unroll
      for (int i = 0; i < RUN_WORDS; ++i) {
        if (r0 + i < r1) {
          uint32_t wd = __byte_perm(w[i], 0, 0x0123);  // big-endian
          const int keep = body - 4 * (r0 + i);        // bytes of it kept
          if (keep < 4) wd &= ~(0xffffffffu >> (8 * keep));
          crc = fold_word(crc, wd, tab);
        }
      }
      total ^= pw.times(crc, tab);
    }
    pw = next;
    flacx::cp_async_wait<0>();
    __syncwarp();
  }
  total = flacx::warp_all(total, flacx::Xor{});
  if (lane == 0) part[warp] = total;
  __syncthreads();
  uint32_t crc = 0;
  if (threadIdx.x == 0)
    for (int q = 0; q < WARPS; ++q) crc ^= part[q];
  if constexpr (CLUSTER) {
    if (threadIdx.x == 0) block_crc = crc;
    cg::this_cluster().sync();  // every block's part is in its shared memory
    if (b == 0 && threadIdx.x == 0)
      for (int r = 1; r < S; ++r)
        crc ^= *cg::this_cluster().map_shared_rank(&block_crc, r);
  }
  if (b == 0 && threadIdx.x == 0) {
    crc = flacx::gf_mulmod16(crc, unpad, tab);
    const int good = fits && crc == stored;
    ok[f] = good;
    if (!good) all_ok[0] = 0;
  }
  if constexpr (CLUSTER)
    cg::this_cluster().sync();  // block 0 has read the others' parts
}

__global__ void flacx_empty_kernel() {}

// blocks a row: enough for the row's pieces at about eight a warp, at
// most a portable cluster
int cluster_size(int nw) {
  const int pieces = (nw + PIECE_WORDS - 1) / PIECE_WORDS;
  return max(1, min(MAX_CLUSTER, (pieces + 8 * WARPS - 1) / (8 * WARPS)));
}

template <typename Kernel, typename... Args>
cudaError_t launch_clustered(Kernel kernel, int blocks, int cluster,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// rows [f, w] bytes (w a multiple of 4, the tensor 4-byte aligned); lens
// [f]; consts: the 1024 table words, x^(32 d) for d < 1024, x^(32 * 1024
// j) for j < 1024, x^(32 * 2^20 k) for k < 512, x^(-8 p) for p < 4; ok
// [f] int32; all_ok one int32 the caller set to 1.  Returns the CUDA error
// code.
FLACX_API int flacx_crc16_rows(const uint8_t* rows, const int32_t* lens,
                               const int32_t* consts, int32_t* ok,
                               int32_t* all_ok, int f, int w,
                               cudaStream_t stream) {
  if (f <= 0 || w < 4 || w % 4 != 0 || ((uintptr_t)rows & 3u) != 0)
    return (int)cudaErrorInvalidValue;
  const int nw = w / 4;
  const int s = cluster_size(nw);
  if ((long long)f * s > 2147483647LL) return (int)cudaErrorInvalidValue;
  const bool vec = w % 16 == 0 && ((uintptr_t)rows & 15u) == 0;
  const uint32_t* r = reinterpret_cast<const uint32_t*>(rows);
  const uint32_t* c = reinterpret_cast<const uint32_t*>(consts);
  if (s == 1) {  // one block a row: a plain launch, no cluster barrier
    if (vec)
      crc16_rows_kernel<true, false><<<f, THREADS, 0, stream>>>(
          r, lens, c, ok, all_ok, nw);
    else
      crc16_rows_kernel<false, false><<<f, THREADS, 0, stream>>>(
          r, lens, c, ok, all_ok, nw);
    return (int)cudaGetLastError();
  }
  const cudaError_t e =
      vec ? launch_clustered(crc16_rows_kernel<true, true>, f * s, s, stream,
                             r, lens, c, ok, all_ok, nw)
          : launch_clustered(crc16_rows_kernel<false, true>, f * s, s,
                             stream, r, lens, c, ok, all_ok, nw);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The launch floor, for measurement only: an empty kernel on the grid
// flacx_crc16_rows launches for rows [f, w] (f x cluster_size blocks of
// THREADS threads, in clusters where it clusters), for the bound's
// comparison.  Returns the CUDA error code.
FLACX_API int flacx_empty(int f, int w, cudaStream_t stream) {
  if (f <= 0 || w < 4 || w % 4 != 0) return (int)cudaErrorInvalidValue;
  const int s = cluster_size(w / 4);
  if ((long long)f * s > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (s == 1) {
    flacx_empty_kernel<<<f, THREADS, 0, stream>>>();
    return (int)cudaGetLastError();
  }
  const cudaError_t e = launch_clustered(flacx_empty_kernel, f * s, s, stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
