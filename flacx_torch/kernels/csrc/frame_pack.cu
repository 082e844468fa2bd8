// frame_pack: every frame's finished bytes from the encoder's chosen
// subframes -- sample symbols emitted, the frame's symbol stream packed
// MSB-first, CRC-16 appended.
//
// Replaces the TPU chain flacx/kernels/emit_tile.py::emit_sample_tiles ->
// bitpack_tile.py::merge_tiles_t -> bitpack_tile.py::merge_strings_t ->
// crc_tile.py::crc16_packed_t (the caller there fixes the CRC's zero tail)
// of the blocked layout; its segmented-layout emit
// emit_tile.py::emit_sample_tiles_seg (psize_min < 40, down to the 1-sample
// partitions of the hi-res path) and the leveled merge
// bitpack_tile.py::merge_strings_t_leveled that flacx takes for string
// stacks past 80 MiB; and the classic symbol path's
// bitpack_tile.py::merge_tiles -> bitpack_tile.py::merge_strings (with the
// XLA CRC-16 fold after it) below 40-sample partitions.
//
// Semantics (flacx_torch.kernels.frame_pack.frame_pack_plain, byte for
// byte): the frame's stream is [frame header], then per channel
// [subframe header], [param slots extra[0..n_extra)], and per segment s
// [param slot mult[s]][samples of segment s], with the two tables of
// emit.general_layout_tables.  That is the general layout of
// flacx_torch.ops.emit.interleave_slots, and where its blocked layout
// applies (psize >= 40) the same stream: there the head param slots 0..32
// precede the first sample in both, only one of them carries bits
// (partition 0's, before sample `order`), and the blocked layout's pad
// slots are zero-length.  Each sample symbol is computed here as the
// plain sample_symbols_from does: a Rice code as one <= 32-bit symbol, an
// escaped raw residual, or a verbatim sample.  nbytes = ceil(bits / 8);
// bytes [nbytes, nbytes+2) carry the CRC-16 (poly 0x18005, init 0) of the
// first nbytes; every later byte is zero; length = nbytes + 2.
//
// Bound on the card: bytes.  zz and x are read once (4 B/sample each) and
// the output row written once: at the headline 1024 frames x 2 channels x
// 4608 samples that is 75.5 MB in + 20.2 MB out, 28.6 us at 3.35 TB/s
// (the same samples at block 1152: 4096 frames x 2 x 1152).
// The per-symbol work (a scan step, a shift, one or two atomics) is below
// that.
//
// Design: one block per frame.  The block walks the frame's symbol slots
// one tile of THREADS at a time: each thread makes its slot's (value,
// length), a block-wide exclusive scan of the lengths (warp shuffles, then
// the warp totals) gives every symbol's bit offset, and the symbol is ORed
// into at most two MSB-first words with atomics.  The CRC-16 is then
// parallel: each thread folds a contiguous run of whole words, byte by
// byte, with a 256-entry table (and the power x^(8*len) mod P of its run),
// and a log-depth tree joins the runs by crc(A|B) = crc(A) * x^(8|B|) +
// crc(B).  Two routes, picked by the wrapper from max_frame_bytes:
//   smem:   the words live in shared memory (pre-zeroed, up to 200 KB: a
//           stereo hi-res frame is at most 102,656 bytes), and the block
//           writes its output row once at the end, coalesced;
//   global: frames past that (a 5.1 hi-res frame is up to 295,168 bytes,
//           past the 232,448 bytes a Hopper block may have; flacx levels
//           its merge there).  The words are ORed straight into the
//           frame's output row in device memory, which the wrapper
//           zero-fills; the CRC folds from that row, read past L1
//           (__ldcg) from L2, where the batch sits (64 frames x 295 KB =
//           19 MB of 50 MB); then each word is byte-swapped in place into
//           stream order and the CRC's two bytes are stored after the
//           stream.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // also the CRC table size
constexpr int WARPS = THREADS / 32;
constexpr int KIND_VERBATIM = 1;
constexpr int KIND_FIXED = 2;
constexpr uint32_t POLY16 = 0x18005u;

struct Args {
  const long long* hdr_v;  // [B, H] frame header symbols
  const int32_t* hdr_l;
  const long long* sh_v;   // [B, C, SH] subframe header symbols
  const int32_t* sh_l;
  const long long* pv;     // [B, C, P] partition-parameter symbols
  const int32_t* pl;
  const int32_t* zz;       // [B, C, N] zigzag residuals, 0 at i < order
  const int32_t* x;        // [B, C, N] samples
  const int32_t* kesc;     // [B, C, NSEG] k | escape << 7 per segment
  const int32_t* meta;     // [B, C, 3] kind, order, bps
  const int32_t* extra;    // [n_extra] head param slots off the segment grid
  const int32_t* mult;     // [N / psize] the param slot leading each segment
  uint8_t* out;            // [B, MFB]
  int32_t* length;         // [B]
  int c, h, sh, p, n, psize, mfb, n_extra;
};

__device__ __forceinline__ uint32_t low_mask(int l) {
  return l >= 32 ? 0xffffffffu : (1u << l) - 1u;
}

// (value, length) of symbol slot s of frame b.
__device__ void symbol(const Args& a, int b, int s, uint32_t& v, int& l) {
  v = 0;
  l = 0;
  if (s < a.h) {
    v = (uint32_t)a.hdr_v[(size_t)b * a.h + s];
    l = a.hdr_l[(size_t)b * a.h + s];
    return;
  }
  s -= a.h;
  const int per_ch = a.sh + a.p + a.n;
  const int ch = s / per_ch;
  int q = s - ch * per_ch;
  const size_t bc = (size_t)b * a.c + ch;
  if (q < a.sh) {
    v = (uint32_t)a.sh_v[bc * a.sh + q];
    l = a.sh_l[bc * a.sh + q];
    return;
  }
  q -= a.sh;
  int param = -1, i = 0;
  if (q < a.n_extra) {
    param = a.extra[q];
  } else {
    const int u = q - a.n_extra;
    const int seg = u / (a.psize + 1);
    const int r = u - seg * (a.psize + 1);
    if (r == 0)
      param = a.mult[seg];
    else
      i = seg * a.psize + r - 1;
  }
  if (param >= 0) {
    v = (uint32_t)a.pv[bc * a.p + param];
    l = a.pl[bc * a.p + param];
    return;
  }
  const int kind = a.meta[bc * 3], ord = a.meta[bc * 3 + 1];
  const int bps = a.meta[bc * 3 + 2];
  if (kind == KIND_VERBATIM) {
    v = (uint32_t)a.x[bc * a.n + i] & low_mask(bps);
    l = bps;
    return;
  }
  if (kind < KIND_FIXED || i < ord) return;
  const int nseg = a.n / a.psize;
  const int ke = a.kesc[bc * nseg + i / a.psize];
  const int k = ke & 31;
  const uint32_t z = (uint32_t)a.zz[bc * a.n + i];
  const uint32_t low = low_mask(k);
  if ((ke >> 7) & 1) {  // escaped partition: k-bit two's complement
    v = ((z >> 1) ^ (0u - (z & 1u))) & low;
    l = k;
  } else {              // Rice code: quotient zeros, stop bit, remainder
    v = (1u << k) | (z & low);
    l = (int)(z >> k) + 1 + k;
  }
}

// OR an l-bit (1..32) symbol into MSB-first words at bit offset off.
__device__ __forceinline__ void put_bits(uint32_t* words, int cap,
                                         uint32_t off, uint32_t v, int l) {
  const int r = off & 31;
  const int w = off >> 5;
  const unsigned long long t =
      (unsigned long long)(v & low_mask(l)) << (64 - l - r);
  const uint32_t hi = (uint32_t)(t >> 32), lo = (uint32_t)t;
  if (hi && w < cap) atomicOr(&words[w], hi);
  if (lo && w + 1 < cap) atomicOr(&words[w + 1], lo);
}

// a * b mod P over GF(2), for a, b < 2^16.
__device__ __forceinline__ uint32_t gf_mulmod16(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t)
    if ((b >> t) & 1u) p ^= a << t;
#pragma unroll
  for (int t = 30; t >= 16; --t)
    if ((p >> t) & 1u) p ^= POLY16 << (t - 16);
  return p;
}

template <bool GLOBAL>
__device__ __forceinline__ uint32_t load_word(const uint32_t* words, int i) {
  return GLOBAL ? __ldcg(words + i) : words[i];
}

template <bool GLOBAL>
__global__ void __launch_bounds__(THREADS) frame_pack_kernel(Args a) {
  extern __shared__ uint32_t smem_words[];  // smem route: [mfb / 4]
  __shared__ uint32_t tab[THREADS];
  __shared__ uint32_t wsum[WARPS];
  __shared__ uint32_t crc_s[THREADS], pow_s[THREADS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cap = a.mfb / 4;
  uint8_t* row = a.out + (size_t)b * a.mfb;
  uint32_t* words = GLOBAL ? reinterpret_cast<uint32_t*>(row) : smem_words;
  if (!GLOBAL)
    for (int i = tid; i < cap; i += THREADS) words[i] = 0;
  {
    uint32_t e = (uint32_t)tid << 8;
    for (int j = 0; j < 8; ++j) e = (e & 0x8000u) ? (e << 1) ^ POLY16 : e << 1;
    tab[tid] = e & 0xffffu;
  }
  __syncthreads();

  // ---- emit + pack, one tile of THREADS symbol slots at a time
  const int total = a.h + a.c * (a.sh + a.p + a.n);
  uint32_t carry = 0;  // bits of all earlier tiles
  for (int base = 0; base < total; base += THREADS) {
    uint32_t v = 0;
    int l = 0;
    if (base + tid < total) symbol(a, b, base + tid, v, l);
    uint32_t incl = (uint32_t)l;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(flacx::FULL_MASK, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    uint32_t before = 0, tile_bits = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const uint32_t t = wsum[w];
      before += w < warp ? t : 0u;
      tile_bits += t;
    }
    if (l) put_bits(words, cap, carry + before + incl - (uint32_t)l, v, l);
    carry += tile_bits;
    __syncthreads();  // wsum is rewritten by the next tile
  }

  // ---- CRC-16 over the first nbytes bytes, each run whole words
  const int nbytes = (int)((carry + 7u) >> 3);
  const int readable = min(nbytes, cap * 4);
  const int run = (((readable + THREADS - 1) / THREADS) + 3) & ~3;
  const int lo = min(tid * run, readable), hi = min(lo + run, readable);
  uint32_t crc = 0, pw = 1;  // crc of the run, x^(8 * run length) mod P
  for (int w4 = lo; w4 < hi; w4 += 4) {
    const uint32_t w = load_word<GLOBAL>(words, w4 >> 2);
    const int nb = min(4, hi - w4);
    for (int j = 0; j < nb; ++j) {
      const uint32_t byte = (w >> (24 - 8 * j)) & 0xffu;
      crc = tab[((crc >> 8) ^ byte) & 0xffu] ^ ((crc << 8) & 0xffffu);
      pw = tab[(pw >> 8) & 0xffu] ^ ((pw << 8) & 0xffffu);
    }
  }
  crc_s[tid] = crc;
  pow_s[tid] = pw;
  __syncthreads();
  for (int stride = 1; stride < THREADS; stride <<= 1) {
    if ((tid & (2 * stride - 1)) == 0) {
      const uint32_t c2 = gf_mulmod16(crc_s[tid], pow_s[tid + stride]) ^
                          crc_s[tid + stride];
      const uint32_t p2 = gf_mulmod16(pow_s[tid], pow_s[tid + stride]);
      crc_s[tid] = c2;
      pow_s[tid] = p2;
    }
    __syncthreads();
  }
  const uint32_t frame_crc = crc_s[0];

  // ---- the output row: packed bytes, CRC-16, zeros
  if (GLOBAL) {
    // the row holds the stream's words (zero past it): put each in byte
    // order, then store the CRC-16 after the stream
    for (int i = tid; i < (readable + 3) >> 2; i += THREADS) {
      const uint32_t w = __ldcg(words + i);
      if (w) words[i] = __byte_perm(w, 0, 0x0123);
    }
    __syncthreads();
    if (tid == 0) {
      if (nbytes < a.mfb) row[nbytes] = (uint8_t)(frame_crc >> 8);
      if (nbytes + 1 < a.mfb) row[nbytes + 1] = (uint8_t)(frame_crc & 0xffu);
    }
  } else {
    for (int i = tid; i < a.mfb; i += THREADS) {
      uint32_t byte = 0;
      if (i < readable)
        byte = (words[i >> 2] >> (24 - 8 * (i & 3))) & 0xffu;
      else if (i == nbytes)
        byte = frame_crc >> 8;
      else if (i == nbytes + 1)
        byte = frame_crc & 0xffu;
      row[i] = (uint8_t)byte;
    }
  }
  if (tid == 0) a.length[b] = nbytes + 2;
}

}  // namespace

// Symbol arrays as in Args; rows = B frames, c channels, h frame-header
// slots, sh subframe-header slots, p = n_extra + n / psize param slots,
// mfb = max_frame_bytes (a multiple of 4).  global_route != 0 packs into
// `out` in device memory, which must arrive zero-filled; else the frame's
// words live in shared memory (mfb <= 200 KB).  Returns the CUDA error
// code.
FLACX_API int flacx_frame_pack(const long long* hdr_v, const int32_t* hdr_l,
                               const long long* sh_v, const int32_t* sh_l,
                               const long long* pv, const int32_t* pl,
                               const int32_t* zz, const int32_t* x,
                               const int32_t* kesc, const int32_t* meta,
                               const int32_t* extra, const int32_t* mult,
                               uint8_t* out, int32_t* length, int rows, int c,
                               int h, int sh, int p, int n, int psize, int mfb,
                               int n_extra, int global_route,
                               cudaStream_t stream) {
  if (rows <= 0 || c < 1 || h < 0 || sh < 0 || psize < 1 || n % psize != 0 ||
      n_extra < 0 || p != n_extra + n / psize || mult == nullptr ||
      (n_extra > 0 && extra == nullptr) || mfb <= 0 || mfb % 4 != 0 ||
      (!global_route && mfb > 200 * 1024))
    return (int)cudaErrorInvalidValue;
  Args a{hdr_v, hdr_l, sh_v, sh_l, pv, pl, zz, x, kesc, meta, extra, mult,
         out, length, c, h, sh, p, n, psize, mfb, n_extra};
  if (global_route) {
    frame_pack_kernel<true><<<rows, THREADS, 0, stream>>>(a);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        frame_pack_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        mfb);
    if (err != cudaSuccess) return (int)err;
    frame_pack_kernel<false><<<rows, THREADS, mfb, stream>>>(a);
  }
  return (int)cudaGetLastError();
}
