// CRC-16 helpers shared by the flacx_torch CUDA kernels (frame_pack,
// crc16_rows): GF(2) products mod P = x^16 + x^15 + x^2 + 1 (FLAC's
// CRC-16, poly 0x18005) from integer multiplies, and the in-order join of
// a warp's (crc, x^(8 len)) pairs.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace flacx {

// a * b mod P over GF(2), for a, b < 2^16.  The carry-less product comes
// from integer products of the operands' bits four apart (each bit of a
// product sums at most 4 terms, whose carries land in the 3-bit holes);
// its top 15 bits are reduced with the table rows tab[0] (x^16) and
// tab[1] (x^24).
__device__ __forceinline__ uint32_t gf_mulmod16(uint32_t a, uint32_t b,
                                                const uint32_t (*tab)[256]) {
  const uint32_t a0 = a & 0x1111u, a1 = a & 0x2222u, a2 = a & 0x4444u,
                 a3 = a & 0x8888u;
  const uint32_t b0 = b & 0x1111u, b1 = b & 0x2222u, b2 = b & 0x4444u,
                 b3 = b & 0x8888u;
  const uint32_t z0 = (a0 * b0) ^ (a1 * b3) ^ (a2 * b2) ^ (a3 * b1);
  const uint32_t z1 = (a0 * b1) ^ (a1 * b0) ^ (a2 * b3) ^ (a3 * b2);
  const uint32_t z2 = (a0 * b2) ^ (a1 * b1) ^ (a2 * b0) ^ (a3 * b3);
  const uint32_t z3 = (a0 * b3) ^ (a1 * b2) ^ (a2 * b1) ^ (a3 * b0);
  const uint32_t p = (z0 & 0x11111111u) | (z1 & 0x22222222u) |
                     (z2 & 0x44444444u) | (z3 & 0x88888888u);
  return (p & 0xffffu) ^ tab[0][(p >> 16) & 0xffu] ^ tab[1][p >> 24];
}

// Joins the warp's lanes' (crc, x^(8 len)) in lane order into lane 0's:
// crc(A|B) = crc(A) * x^(8|B|) + crc(B).
__device__ __forceinline__ void warp_join(uint32_t& crc, uint32_t& pw,
                                          const uint32_t (*tab)[256]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t c2 = __shfl_down_sync(FULL_MASK, crc, o);
    const uint32_t p2 = __shfl_down_sync(FULL_MASK, pw, o);
    if ((lane & (2 * o - 1)) == 0) {
      crc = gf_mulmod16(crc, p2, tab) ^ c2;
      pw = gf_mulmod16(pw, p2, tab);
    }
  }
}

}  // namespace flacx
