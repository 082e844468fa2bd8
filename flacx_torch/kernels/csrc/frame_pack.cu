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
// zz is int32, or int64 past 24-bit samples, of which the kernel reads the
// low 32 bits (zz64): the value itself wherever a symbol is coded from it.
// A Rice parameter k <= 30 codes only partitions whose max zz has (zz >> k)
// + k + 1 <= 32, so zz < (32 - k) * 2^k <= 2^31, and an escape only those
// with bitlen(max zz) <= 31 (ops.rice.exact_plan, the rice_stats kernel's
// int64 route); a subframe with any other partition is not coded but
// verbatim, from x.  So every zz the kernel codes is below 2^31.
//
// Bound on the card: bytes.  zz and x are read once (4 B/sample each) and
// the output row written once: at the headline 1024 frames x 2 channels x
// 4608 samples that is 75.5 MB in + 20.2 MB out, 28.6 us at 3.35 TB/s
// (the same samples at block 1152: 4096 frames x 2 x 1152).
//
// Design: many blocks a frame, in two launches, with no host sync.  A
// frame's slot sequence is cut into chunks of CHUNK slots; `symbols` runs
// a grid over (chunk, frame), `place` over (group of GROUP chunks,
// frame): a hi-res stereo batch is about 8,300 and 2,200 blocks, not 128.
//
//   symbols: each thread owns RUN consecutive slots and walks them with
//     its (channel, slot, segment, position) stepped a slot at a time (two
//     divisions for the run's first slot, none after; a run inside one
//     channel's segment grid takes a path with no branch on the region).
//     All the run's loads are issued before any is used.  One block-wide
//     scan of the runs' bit totals gives each run its offset in the chunk;
//     the thread packs its run through a 64-bit accumulator into whole
//     32-bit words in shared memory (plain stores for the words it fills
//     alone, atomicOr for its first and last word, which neighbouring runs
//     share).  The chunk's words, from bit 0, go to its scratch row in
//     device memory with its bit count.
//   place: each block scans its frame's chunk bit counts (a few dozen
//     ints), which gives its chunks' bit offsets and the frame's total.
//     Rule for the words that chunks share: the chunk in which a word's
//     first bit lies writes the word, after ORing in the leading bits of
//     the chunks after it (from their scratch rows).  So every output word
//     has one writer and the row needs no zero-fill, which would add
//     [B, max_frame_bytes] of writes: 13 MB in hi-res stereo and 19 MB in
//     5.1, as much again as the rows.  The words past the stream are
//     zeroed by the frame's blocks in equal slices; the one or two words
//     that hold the CRC bytes are left to the frame's last block.  Each
//     thread folds the CRC-16 of a run of the block's words, four bytes a
//     step, and shifts it by the bytes after the run (x^(8 len) mod P, a
//     table the wrapper builds); the runs' CRCs are XORed.  The frame's
//     last block to finish (an atomic ticket after __threadfence) joins
//     the blocks' parts in order, crc(A|B) = crc(A) * x^(8|B|) + crc(B),
//     one warp, and writes the words with the CRC bytes and the length.
//
// Why a second launch and not one pass with a decoupled look-back: the
// shared words need the next chunk's bits, which a single pass could only
// wait for (a block spinning on a later block that is not resident can
// hang the card) or OR into a zero-filled row (the bytes above).  The
// scratch rows hold the packed stream, about the frame's compressed size,
// read back from L2; zz and x are read once.  RUN and GROUP were the
// fastest of RUN 2..16 and GROUP 1..8 on the H100 (PERF.md).

#include "common.cuh"
#include "crc16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RUN = 4;                 // slots a thread
constexpr int CHUNK = THREADS * RUN;   // slots a symbols block
constexpr int GROUP = 4;               // chunks a place block
constexpr int KIND_VERBATIM = 1;
constexpr int KIND_FIXED = 2;

struct Args {
  const long long* hdr_v;  // [B, H] frame header symbols
  const int32_t* hdr_l;
  const long long* sh_v;   // [B, C, SH] subframe header symbols
  const int32_t* sh_l;
  const long long* pv;     // [B, C, P] partition-parameter symbols
  const int32_t* pl;
  const uint32_t* zz;      // [B, C, N] zigzag residuals, 0 at i < order,
                           // int32, or int64 read as its low words
  int zz_shift;            // log2 of zz's words a value: 0 or 1
  const int32_t* x;        // [B, C, N] samples
  const int32_t* kesc;     // [B, C, NSEG] k | escape << 7 per segment
  const int32_t* meta;     // [B, C, 3] kind, order, bps
  const int32_t* extra;    // [n_extra] head param slots off the segment grid
  const int32_t* mult;     // [N / psize] the param slot leading each segment
  uint8_t* out;            // [B, MFB]
  int32_t* length;         // [B]
  const uint32_t* tab;     // [4, 256] i * x^(16 + 8k) mod P
  const uint32_t* pow8;    // [4 GROUP CHUNK + 5] x^(8k) mod P
  uint32_t* scratch;       // [B, nch, CHUNK] each chunk's packed words
  uint32_t* counts;        // [B, nch] each chunk's bits
  uint32_t* parts;         // [B, ng] each group's CRC | x^(8 len) << 16
  int32_t* tickets;        // [B] place blocks finished
  int c, h, sh, p, n, psize, nseg, mfb, n_extra, mult_head, slots, nch, ng;
};

__device__ __forceinline__ uint32_t low_mask(int l) {
  return l >= 32 ? 0xffffffffu : (1u << l) - 1u;
}

// Exclusive scan of v over the block; *total gets the block's sum.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* wsum,
                                               uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(flacx::FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  uint32_t before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const uint32_t t = wsum[w];
    before += w < warp ? t : 0u;
    sum += t;
  }
  __syncthreads();  // wsum is rewritten by the next scan
  *total = sum;
  return before + incl - v;
}

// Where a slot lies: ch -1 is the frame header (slot q); else channel ch's
// slot q, and in its segment grid segment seg, position pos (0 the param
// slot, then the samples).
struct Walk {
  int ch, q, seg, pos;
};

__device__ __forceinline__ Walk walk_at(const Args& a, int s) {
  Walk w{-1, s, 0, 0};
  if (s < a.h) return w;
  const int per_ch = a.sh + a.p + a.n;
  w.ch = (s - a.h) / per_ch;
  w.q = s - a.h - w.ch * per_ch;
  const int r = w.q - a.sh - a.n_extra;
  if (r >= 0) {
    w.seg = r / (a.psize + 1);
    w.pos = r - w.seg * (a.psize + 1);
  }
  return w;
}

__device__ __forceinline__ void walk_step(const Args& a, Walk& w) {
  ++w.q;
  if (w.ch < 0) {
    if (w.q == a.h) w.ch = w.q = 0;
  } else if (w.q == a.sh + a.p + a.n) {
    ++w.ch;
    w.q = 0;
  }
  const int r = w.q - a.sh - a.n_extra;
  if (w.ch < 0 || r < 0) return;
  if (r == 0) {
    w.seg = w.pos = 0;
  } else if (++w.pos == a.psize + 1) {
    ++w.seg;
    w.pos = 0;
  }
}

// low 32 bits of an int64 symbol value (little-endian)
__device__ __forceinline__ uint32_t low_word(const long long* p, size_t i) {
  return __ldg(reinterpret_cast<const uint32_t*>(p) + 2 * i);
}

// what a slot's raw value is: a finished symbol (length in aux), a
// verbatim sample (width in aux), a coded residual (its segment's
// k | escape << 7 in aux), or nothing
constexpr int LITERAL = 1, VERBATIM = 2, CODED = 3;

__global__ void __launch_bounds__(THREADS) frame_pack_kernel_symbols(Args a) {
  __shared__ __align__(16) uint32_t words[CHUNK];
  __shared__ uint32_t wsum[WARPS];
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  if (c == 0 && tid == 0) a.tickets[b] = 0;  // for the place kernel
  for (int i = tid; i < CHUNK / 4; i += THREADS)
    reinterpret_cast<uint4*>(words)[i] = make_uint4(0, 0, 0, 0);

  // the run's loads, all issued before any is used
  const int first = c * CHUNK + tid * RUN;
  uint32_t raw[RUN];
  int aux[RUN];
  uint32_t types = 0;  // 2 bits a slot
  Walk w = walk_at(a, first);
  if (w.ch >= 0 && w.q >= a.sh + a.n_extra && w.q + RUN <= a.sh + a.p + a.n &&
      first + RUN <= a.slots) {
    // the common case, a run inside one channel's segment grid: its
    // channel's kind, order and width once, and no branch on the region
    const size_t bc = (size_t)b * a.c + w.ch;
    const int32_t* mp = a.meta + bc * 3;
    const int kind = __ldg(mp), ord = __ldg(mp + 1), bps = __ldg(mp + 2);
    int seg = w.seg, pos = w.pos;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      int type;
      if (pos == 0) {
        const int param = seg >= a.mult_head ? seg + a.n_extra
                                             : __ldg(a.mult + seg);
        type = LITERAL;
        raw[j] = low_word(a.pv, bc * a.p + param);
        aux[j] = __ldg(a.pl + bc * a.p + param);
      } else {
        const int i = seg * a.psize + pos - 1;
        raw[j] = __ldg(a.zz + ((bc * a.n + i) << a.zz_shift));
        aux[j] = __ldg(a.kesc + bc * a.nseg + seg);
        type = kind >= KIND_FIXED && i >= ord ? CODED : 0;
        if (kind == KIND_VERBATIM) {
          type = VERBATIM;
          raw[j] = (uint32_t)__ldg(a.x + bc * a.n + i);
          aux[j] = bps;
        }
      }
      types |= (uint32_t)type << (2 * j);
      if (++pos == a.psize + 1) {
        pos = 0;
        ++seg;
      }
    }
  } else {  // the header, a subframe header, a channel boundary or the end
    int3 m{0, 0, 0};  // kind, order, bps of channel mch
    int mch = -1;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      raw[j] = 0;
      aux[j] = 0;
      int type = 0;
      if (first + j < a.slots) {
        if (w.ch < 0) {
          type = LITERAL;
          raw[j] = low_word(a.hdr_v, (size_t)b * a.h + w.q);
          aux[j] = __ldg(a.hdr_l + (size_t)b * a.h + w.q);
        } else {
          const size_t bc = (size_t)b * a.c + w.ch;
          int param = -1;
          if (w.q < a.sh) {
            type = LITERAL;
            raw[j] = low_word(a.sh_v, bc * a.sh + w.q);
            aux[j] = __ldg(a.sh_l + bc * a.sh + w.q);
          } else if (w.q < a.sh + a.n_extra) {
            param = __ldg(a.extra + w.q - a.sh);
          } else if (w.pos == 0) {
            param = w.seg >= a.mult_head ? w.seg + a.n_extra
                                         : __ldg(a.mult + w.seg);
          } else {
            if (w.ch != mch) {
              const int32_t* mp = a.meta + bc * 3;
              m = make_int3(__ldg(mp), __ldg(mp + 1), __ldg(mp + 2));
              mch = w.ch;
            }
            const int i = w.seg * a.psize + w.pos - 1;
            if (m.x == KIND_VERBATIM) {
              type = VERBATIM;
              raw[j] = (uint32_t)__ldg(a.x + bc * a.n + i);
              aux[j] = m.z;
            } else if (m.x >= KIND_FIXED && i >= m.y) {
              type = CODED;
              raw[j] = __ldg(a.zz + ((bc * a.n + i) << a.zz_shift));
              aux[j] = __ldg(a.kesc + bc * a.nseg + w.seg);
            }
          }
          if (param >= 0) {
            type = LITERAL;
            raw[j] = low_word(a.pv, bc * a.p + param);
            aux[j] = __ldg(a.pl + bc * a.p + param);
          }
        }
      }
      types |= (uint32_t)type << (2 * j);
      walk_step(a, w);
    }
  }

  // each slot's (value, length) as the plain sample_symbols_from makes it;
  // lengths past 32 (outside the contract) are cut to 32
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int type = (types >> (2 * j)) & 3;
    uint32_t v = raw[j];
    int l = type ? aux[j] : 0;
    if (type == CODED) {
      const int k = aux[j] & 31;
      const uint32_t z = raw[j], low = low_mask(k);
      if ((aux[j] >> 7) & 1) {  // escaped partition: k-bit two's complement
        v = (z >> 1) ^ (0u - (z & 1u));
        l = k;
      } else {  // Rice code: quotient zeros, stop bit, remainder
        v = (1u << k) | (z & low);
        l = (int)min(z >> k, 31u) + 1 + k;
      }
    }
    l = min(l, 32);
    raw[j] = v & low_mask(l);
    aux[j] = l;
    bits += (uint32_t)l;
  }
  uint32_t chunk_bits;
  const uint32_t off = block_scan(bits, wsum, &chunk_bits);

  // the run's bits from offset off: whole words it fills alone are
  // stored, its first and last word (shared with neighbouring runs) ORed
  uint32_t wi = off >> 5;
  int nacc = off & 31;  // bits in acc; those before off are zeros
  bool shared = nacc != 0;
  unsigned long long acc = 0;
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    if (!aux[j]) continue;
    acc = (acc << aux[j]) | raw[j];
    nacc += aux[j];
    if (nacc >= 32) {
      nacc -= 32;
      const uint32_t word = (uint32_t)(acc >> nacc);
      if (shared)
        atomicOr(&words[wi], word);
      else
        words[wi] = word;
      ++wi;
      shared = false;
      acc &= (1ull << nacc) - 1;
    }
  }
  if (bits && nacc) atomicOr(&words[wi], (uint32_t)(acc << (32 - nacc)));
  __syncthreads();

  uint32_t* dst = a.scratch + ((size_t)b * a.nch + c) * CHUNK;
  const int nw = (int)((chunk_bits + 31) >> 5);
  for (int i = tid; i < nw; i += THREADS) dst[i] = words[i];
  if (tid == 0) a.counts[b * a.nch + c] = chunk_bits;
}

// Word w of frame b's stream, whose first bit lies in chunk d: from d's
// scratch row, ORed with the leading bits of the chunks after d.
__device__ uint32_t stream_word(const Args& a, int b, const uint32_t* offs,
                                int d, uint32_t w) {
  const size_t row_words = (size_t)a.nch * CHUNK;
  const uint32_t s = offs[d], e = offs[d + 1];
  const uint32_t* src = a.scratch + (size_t)b * row_words + (size_t)d * CHUNK;
  const uint32_t rel = 32 * w - s, iw = rel >> 5, sh = rel & 31;
  uint32_t val = src[iw];
  if (sh) {
    val <<= sh;
    if (iw + 1 < (e - s + 31) >> 5) val |= src[iw + 1] >> (32 - sh);
  }
  for (int f = d + 1; f < a.nch && offs[f] < 32 * w + 32; ++f)
    if (offs[f + 1] > offs[f])
      val |= a.scratch[(size_t)b * row_words + (size_t)f * CHUNK] >>
             (offs[f] - 32 * w);
  return val;
}

__global__ void __launch_bounds__(THREADS) frame_pack_kernel_place(Args a) {
  extern __shared__ uint32_t dyn[];  // [nch + 1] chunk offsets, then words
  uint32_t* offs = dyn;
  uint32_t* sw = dyn + a.nch + 1;    // [GROUP CHUNK + 1] this block's words
  // tab[k][i] = i * x^(16 + 8k) mod P: a CRC-16 step over 1 or 4 bytes
  __shared__ uint32_t tab[4][256];
  __shared__ uint32_t wsum[WARPS];
  __shared__ int last;

  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31;
  const int c0 = g * GROUP, c1 = min(c0 + GROUP, a.nch);  // its chunks
  for (int i = tid; i < 4 * 256; i += THREADS)
    tab[i >> 8][i & 255] = __ldg(a.tab + i);
  const uint32_t* counts = a.counts + (size_t)b * a.nch;
  uint32_t carry = 0;
  for (int base = 0; base < a.nch; base += THREADS) {
    const int i = base + tid;
    uint32_t tile;
    const uint32_t ex = block_scan(i < a.nch ? counts[i] : 0u, wsum, &tile);
    if (i < a.nch) offs[i] = carry + ex;
    carry += tile;
  }
  if (tid == 0) offs[a.nch] = carry;
  __syncthreads();

  const uint32_t total = offs[a.nch], s = offs[c0], e = offs[c1];
  const uint32_t nbytes = (total + 7) >> 3;
  const uint32_t cap = (uint32_t)a.mfb / 4;
  // the words whose first bit lies in this block's chunks; the one or two
  // words that hold the CRC bytes, [t0, t1], are the frame's last block's
  const uint32_t w0 = (s + 31) >> 5, w1 = (e + 31) >> 5;
  const uint32_t t0 = nbytes >> 2, t1 = (nbytes + 1) >> 2;
  uint32_t* row = reinterpret_cast<uint32_t*>(a.out + (size_t)b * a.mfb);
  for (uint32_t k = tid; k < w1 - w0; k += THREADS) {
    const uint32_t w = w0 + k;
    int d = c0;
    while (offs[d + 1] <= 32 * w) ++d;
    const uint32_t val = stream_word(a, b, offs, d, w);
    sw[k] = val;
    if (w < cap && w != t0) row[w] = __byte_perm(val, 0, 0x0123);
  }
  // the words past those: zeros, an equal slice for each block
  if (t1 + 1 < cap) {
    const uint32_t per = (cap - t1 - 1 + a.ng - 1) / a.ng;
    const uint32_t z0 = t1 + 1 + (uint32_t)g * per, z1 = min(z0 + per, cap);
    for (uint32_t w = z0 + tid; w < z1; w += THREADS) row[w] = 0;
  }
  __syncthreads();

  // ---- CRC-16 of this block's bytes [4 w0, min(4 w1, nbytes)): each
  // thread folds a run of whole words, four bytes a step, shifts it by the
  // bytes after the run (x^(8 len) from pow8) and the runs are XORed
  const int nb = w1 > w0 ? (int)(min(4 * w1, nbytes) - 4 * w0) : 0;
  const int nw = (nb + 3) >> 2, per = (nw + THREADS - 1) / THREADS;
  const int lo = min(tid * per, nw), hi = min(lo + per, nw);
  uint32_t crc = 0;
  for (int i = lo; i < hi; ++i) {
    const uint32_t wd = sw[i];
    if (4 * i + 4 <= nb) {
      crc = tab[3][(wd >> 24) ^ (crc >> 8)] ^
            tab[2][((wd >> 16) & 0xffu) ^ (crc & 0xffu)] ^
            tab[1][(wd >> 8) & 0xffu] ^ tab[0][wd & 0xffu];
    } else {
      for (int j = 0; j < nb - 4 * i; ++j) {
        const uint32_t byte = (wd >> (24 - 8 * j)) & 0xffu;
        crc = tab[0][(crc >> 8) ^ byte] ^ ((crc << 8) & 0xffffu);
      }
    }
  }
  crc = flacx::gf_mulmod16(crc, __ldg(a.pow8 + nb - min(4 * hi, nb)), tab);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    crc ^= __shfl_xor_sync(flacx::FULL_MASK, crc, o);
  if (lane == 0) wsum[tid >> 5] = crc;
  __syncthreads();
  if (tid >= 32) return;
  crc = lane < WARPS ? wsum[lane] : 0u;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    crc ^= __shfl_xor_sync(flacx::FULL_MASK, crc, o);
  uint32_t* parts = a.parts + (size_t)b * a.ng;
  if (lane == 0) {
    parts[g] = crc | (__ldg(a.pow8 + nb) << 16);
    __threadfence();
    last = atomicAdd(a.tickets + b, 1) == a.ng - 1;
  }
  __syncwarp();
  if (!last) return;

  // ---- the frame's last block: the parts joined in chunk order, then
  // the words that hold the CRC bytes, and the length
  __threadfence();
  const int pc = (a.ng + 31) / 32;
  uint32_t pw = 1;
  crc = 0;
  for (int d = lane * pc; d < min(a.ng, lane * pc + pc); ++d) {
    const uint32_t part = __ldcg(parts + d);
    crc = flacx::gf_mulmod16(crc, part >> 16, tab) ^ (part & 0xffffu);
    pw = flacx::gf_mulmod16(pw, part >> 16, tab);
  }
  flacx::warp_join(crc, pw, tab);
  if (lane == 0) {
    for (uint32_t w = t0; w <= t1 && w < cap; ++w) {
      uint32_t val = 0;
      if (32 * w < total) {  // the stream's last word: find its chunk
        int d = 0;
        while (offs[d + 1] <= 32 * w) ++d;
        val = stream_word(a, b, offs, d, w);
      }
      for (uint32_t i = 0; i < 2; ++i)  // CRC byte i at byte nbytes + i
        if ((nbytes + i) >> 2 == w)
          val |= ((i ? crc : crc >> 8) & 0xffu)
                 << (24 - 8 * ((nbytes + i) & 3));
      row[w] = __byte_perm(val, 0, 0x0123);
    }
    a.length[b] = (int32_t)nbytes + 2;
  }
}

}  // namespace

// Symbol arrays as in Args (zz int64 when zz64 != 0); rows = B frames, c
// channels, h frame-header
// slots, sh subframe-header slots, p = n_extra + n / psize param slots,
// mfb = max_frame_bytes (a multiple of 4); mult[s] = s + n_extra for every
// segment s >= mult_head; crc_consts holds tab (Args) and then x^(8k) mod
// P for k <= 4 GROUP CHUNK + 4; chunk_slots and group must be CHUNK and
// GROUP.  `work` is int32 scratch of rows * (nch * (CHUNK + 2) + 1), nch
// the frame's slots over CHUNK rounded up.  Returns the CUDA error code.
FLACX_API int flacx_frame_pack(const long long* hdr_v, const int32_t* hdr_l,
                               const long long* sh_v, const int32_t* sh_l,
                               const long long* pv, const int32_t* pl,
                               const void* zz, const int32_t* x,
                               const int32_t* kesc, const int32_t* meta,
                               const int32_t* extra, const int32_t* mult,
                               const int32_t* crc_consts, uint8_t* out,
                               int32_t* length, int32_t* work, int rows,
                               int c, int h, int sh, int p, int n, int psize,
                               int mfb, int n_extra, int mult_head,
                               int chunk_slots, int group, int zz64,
                               cudaStream_t stream) {
  if (rows <= 0 || rows > 65535 || c < 1 || h < 0 || sh < 0 || psize < 1 ||
      n % psize != 0 || n_extra < 0 || p != n_extra + n / psize ||
      mult == nullptr || (n_extra > 0 && extra == nullptr) || mfb <= 0 ||
      mfb % 4 != 0 || mult_head < 0 || chunk_slots != CHUNK ||
      group != GROUP || crc_consts == nullptr || work == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long slots = h + (long long)c * (sh + p + n);
  const long long nch = (slots + CHUNK - 1) / CHUNK;
  if (slots < 1 || slots > (1LL << 30) || nch > 4096)
    return (int)cudaErrorInvalidValue;
  uint32_t* scratch = reinterpret_cast<uint32_t*>(work);
  uint32_t* counts = scratch + (size_t)rows * nch * CHUNK;
  uint32_t* parts = counts + (size_t)rows * nch;
  int32_t* tickets = reinterpret_cast<int32_t*>(parts + (size_t)rows * nch);
  Args a{hdr_v, hdr_l, sh_v, sh_l, pv, pl,
         static_cast<const uint32_t*>(zz), zz64 ? 1 : 0, x, kesc, meta,
         extra, mult,
         out, length, reinterpret_cast<const uint32_t*>(crc_consts),
         reinterpret_cast<const uint32_t*>(crc_consts) + 4 * 256, scratch,
         counts, parts, tickets,
         c, h, sh, p, n, psize, n / psize, mfb, n_extra, mult_head,
         (int)slots, (int)nch, (int)((nch + GROUP - 1) / GROUP)};
  frame_pack_kernel_symbols<<<dim3((unsigned)nch, (unsigned)rows), THREADS, 0,
                              stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (nch + 1 + GROUP * CHUNK + 1) * sizeof(uint32_t);
  frame_pack_kernel_place<<<dim3((unsigned)a.ng, (unsigned)rows), THREADS,
                            smem, stream>>>(a);
  return (int)cudaGetLastError();
}
