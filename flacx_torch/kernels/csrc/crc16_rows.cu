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
// Bound on the card: bytes.  The rows are read once (3.4 MB for 256
// frames of 16-bit stereo at block 4608: 1.0 us at 3.35 TB/s).
//
// Design: one block of 256 threads a row.  Thread t folds the row's
// 32-bit words t, t + 256, t + 512, ... (coalesced loads, bytes past the
// body masked to zero) in Horner form: acc = acc x^(32 * 256) + crc(word),
// each word's CRC from four table lookups, the product by a power of x a
// GF(2) multiply from integer products (crc16.cuh, shared with
// frame_pack).  Then acc is shifted by x^(32 d), d the words after the
// thread's last, and the threads' parts are XORed: crc(A|B) = crc(A)
// x^(8|B|) + crc(B), and the zero bytes after the body are undone with
// x^(-8 pad).  Tables: i x^(16 + 8k) mod P (k < 4, the first 1024 words
// of the constants frame_pack uses), then x^(32 d) for d <= 256, then
// x^(-8 p) for p < 4, from the wrapper.

#include "common.cuh"
#include "crc16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
crc16_rows_kernel(const uint32_t* rows, const int32_t* lens,
                  const uint32_t* consts, int32_t* ok, int32_t* all_ok,
                  int nw) {
  __shared__ uint32_t tab[4][256];
  __shared__ uint32_t xw[THREADS + 1];
  __shared__ uint32_t part[WARPS];
  const int tid = threadIdx.x, lane = tid & 31;
  const int f = blockIdx.x;
  for (int i = tid; i < 4 * 256; i += THREADS)
    tab[i >> 8][i & 255] = __ldg(consts + i);
  for (int i = tid; i <= THREADS; i += THREADS)
    xw[i] = __ldg(consts + 1024 + i);
  __syncthreads();

  const uint32_t* row = rows + (long long)f * nw;
  const int len = lens[f];
  const int body = max(0, min(len - 2, 4 * nw));  // bytes under the CRC
  const int m = (body + 3) >> 2;                   // words holding them
  uint32_t acc = 0;
  int last = -1;
  for (int i = tid; i < m; i += THREADS) {
    uint32_t wd = __byte_perm(__ldg(row + i), 0, 0x0123);  // big-endian
    const int keep = body - 4 * i;                   // bytes of it kept
    if (keep < 4) wd &= ~(0xffffffffu >> (8 * keep));
    acc = flacx::gf_mulmod16(acc, xw[THREADS], tab) ^
          tab[3][wd >> 24] ^ tab[2][(wd >> 16) & 0xffu] ^
          tab[1][(wd >> 8) & 0xffu] ^ tab[0][wd & 0xffu];
    last = i;
  }
  if (last >= 0) acc = flacx::gf_mulmod16(acc, xw[m - 1 - last], tab);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc ^= __shfl_xor_sync(flacx::FULL_MASK, acc, o);
  if (lane == 0) part[tid >> 5] = acc;
  __syncthreads();
  if (tid != 0) return;
  uint32_t crc = 0;
  for (int w = 0; w < WARPS; ++w) crc ^= part[w];
  crc = flacx::gf_mulmod16(crc, __ldg(consts + 1024 + THREADS + 1 +
                                      (4 * m - body)), tab);
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(row);
  uint32_t stored = 0;
  if (len >= 2 && len <= 4 * nw)
    stored = ((uint32_t)bytes[len - 2] << 8) | bytes[len - 1];
  const int good = len >= 2 && len <= 4 * nw && crc == stored;
  ok[f] = good;
  if (!good) all_ok[0] = 0;
}

}  // namespace

// rows [f, w] bytes (w a multiple of 4, the tensor 4-byte aligned); lens
// [f]; consts: the 1024 table words, x^(32 d) for d = 0..256, x^(-8 p)
// for p = 0..3; ok [f] int32; all_ok one int32 the caller set to 1.
// Returns the CUDA error code.
FLACX_API int flacx_crc16_rows(const uint8_t* rows, const int32_t* lens,
                               const int32_t* consts, int32_t* ok,
                               int32_t* all_ok, int f, int w,
                               cudaStream_t stream) {
  if (f <= 0 || f > 2147483647 || w < 4 || w % 4 != 0 ||
      ((uintptr_t)rows & 3u) != 0)
    return (int)cudaErrorInvalidValue;
  crc16_rows_kernel<<<f, THREADS, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(rows), lens,
      reinterpret_cast<const uint32_t*>(consts), ok, all_ok, w / 4);
  return (int)cudaGetLastError();
}
