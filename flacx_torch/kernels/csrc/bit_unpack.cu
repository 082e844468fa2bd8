// bit_unpack: every residual / verbatim symbol of a batch of FLAC frames,
// decoded from the host walker's checkpoints, one thread per chunk of 64
// symbols.
//
// Replaces flacx/ops/bitunpack.py::parse_residual_chunks (with
// bytes_to_words), the decode path's XLA lax.scan: flacx has no Pallas
// kernel here, and as plain torch each of its 64 scan steps would be some
// 40 launches.
//
// Semantics (flacx_torch.ops.bitunpack.parse_residual_chunks, integer for
// integer): lane (f, c, k) starts at checkpoint k of subframe (f, c) with
// its cursor, Rice parameter, escape size and in-escape flag, and walks
// samples j = 64 k .. 64 k + 63 (j < n).  A fixed or LPC subframe's
// partition parameter field (4 or 5 bits; the escape code 2^width - 1 is
// followed by a 5-bit raw size) sits before the first sample of each
// partition (j == order, or j a nonzero multiple of the partition size);
// a sample is active where j >= order (fixed, LPC) or always (verbatim,
// which the walker hands over as an escape of its sample width).  An
// active sample reads its 64-bit window at the cursor (bits past the row
// read as zero): the count of leading zeros after the fields is the Rice
// quotient q, the next `param` bits the remainder, u = q << param | rem
// and the value (u >> 1) ^ -(u & 1); in escape it is the next `esc` bits,
// signed (zero for esc = 0).  The error flag is set where an active
// symbol's bits pass its 64-bit window, or where a chunk's final cursor
// is not the next chunk's checkpoint.  vals [F, C, n] int64 (zero at
// inactive positions).
//
// Bound on the card: bytes.  The rows are read once (3.4 MB for 256
// frames of 16-bit stereo at block 4608) and vals written once (8 B a
// sample, 18.9 MB there), about 6.7 us at 3.35 TB/s; the walk does some
// 40 integer operations a symbol (9.4 M symbols: 5.6 us at the scalar
// rate).
//
// Design: 64 lanes a block, consecutive lanes of a subframe (and the
// subframes and frames) next to each other, so the bits the block walks
// are one contiguous span of the [F, W] rows: from the word of its first
// lane's checkpoint to five words past the word of the next block's
// first checkpoint (the end of the rows for the last block).  The block
// stages that span into shared memory first, with coalesced 16-byte
// cp.async copies all in flight at once (a word is byte-swapped to
// big-endian where it is read), up to a capacity sized from the rows'
// mean bytes a lane (the wrapper's W / (C K), one eighth over).
// Each thread keeps three words of its row in registers and reads the
// one after them ahead of each symbol's decode, from the span (or, for
// a word outside it, as in a corrupt stream, from the row in global
// memory; zero past the row), so no load waits on the decode.  The
// decode takes both the Rice and the escape value and selects, and the
// words advance by the 0 or 1 word the symbol used, by selects, so the
// lanes of a warp do not diverge; a symbol of 33 bits or more reads one
// more word, and one past its window (an error) reloads them.  Values
// leave 16 a lane at a time through shared memory, each warp's share of
// vals written coalesced, 16 bytes a thread, after a warp barrier only;
// about 17 KB of shared memory a block at the headline, so an SM holds
// every block the batch gives it.

#include "common.cuh"

namespace {

constexpr int LANES = 64;   // threads (chunk lanes) a block
constexpr int S = 64;       // symbols a chunk (the walker's interval)
constexpr int OUT = 16;     // symbols a lane between two stores
constexpr int SPAN_MAX = 8192;  // staged words a block at most

struct Args {
  const uint32_t* rows;    // [F, W/4] frame bytes as words
  const int32_t* ckpt_pos;  // [F, C, K] checkpoints
  const int32_t* ckpt_param;
  const int32_t* ckpt_esc;
  const int32_t* ckpt_inesc;
  const int32_t* kind;     // [F, C]
  const int32_t* order;
  const int32_t* po;
  const int32_t* width;
  long long* vals;         // [F, C, n]
  int32_t* err;            // [1], set to 1 on an error
  int c, k, n, nw, cap;    // channels, chunks a subframe, block, words a
                           // row, staged words a block at most
  long long lanes, words;  // F C K, F nw
};

// Big-endian word i of a lane's row: from the staged span where it lies
// there (row words [ilo, ihi) are staged, at span[rb + i]), else from the
// row in global memory; zero past the row.  One shared-memory load in the
// common case; the global read is a call, off the common path.
struct RowSpan {
  const uint32_t* span;
  long long fbase;   // the row's first word in the flat rows
  int rb, ilo, ihi;
};

__device__ __noinline__ uint32_t row_word(const Args& a, long long fbase,
                                          int i) {
  return i < a.nw ? __byte_perm(__ldg(a.rows + fbase + i), 0, 0x0123) : 0u;
}

__device__ __forceinline__ uint32_t word_at(const Args& a, const RowSpan& r,
                                            int i) {
  if ((unsigned)(i - r.ilo) < (unsigned)(r.ihi - r.ilo))
    return __byte_perm(r.span[r.rb + i], 0, 0x0123);
  return row_word(a, r.fbase, i);
}

__global__ void __launch_bounds__(LANES) bit_unpack_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t span[];   // [cap] words
  __shared__ long long sv[LANES][OUT + 1];
  __shared__ long long vbase[LANES];   // flat vals index of a lane's first
  __shared__ int nvalid[LANES];        // a lane's samples in the block
  const int t = threadIdx.x;
  const long long l0 = (long long)blockIdx.x * LANES;
  const long long lend = min(l0 + LANES, a.lanes);
  const long long lane = l0 + t;
  const int ck = a.c * a.k;

  // the span [s0, s0 + slen) of flat words, 16-byte aligned at its start
  long long s0 = (l0 / ck) * a.nw + (a.ckpt_pos[l0] >> 5);
  long long s1 = lend < a.lanes
                     ? (lend / ck) * a.nw + (a.ckpt_pos[lend] >> 5) + 5
                     : a.words;
  s0 = max(0LL, s0) & ~3LL;
  s1 = min(s1, a.words);
  const int slen = (int)max(0LL, min(s1 - s0, (long long)a.cap));
  // asynchronous copies, all in flight at once; words are byte-swapped
  // to big-endian where they are read
  int done = 0;   // words staged as whole 16-byte quads
  if ((((uintptr_t)a.rows) & 15u) == 0) {
    for (int p = t; 4 * p + 4 <= slen; p += LANES)
      flacx::cp_async16(span + 4 * p, a.rows + s0 + 4 * p);
    done = slen & ~3;
  }
  for (int p = done + t; p < slen; p += LANES)
    flacx::cp_async4(span + p, a.rows + s0 + p);
  flacx::cp_async_commit();

  const bool valid = lane < a.lanes;
  int kk = 0, kind = 0, order = 0, psize = 1, wd = 0, nb = 0;
  int pos = 0, param = 0, esc = 0;
  bool inesc = false, bad = false;
  RowSpan rs{span, 0, 0, 0, 0};
  if (valid) {
    const long long sub = lane / a.k;
    kk = (int)(lane - sub * a.k);
    rs.fbase = (sub / a.c) * (long long)a.nw;
    rs.rb = (int)(rs.fbase - s0);
    rs.ilo = max(0, -rs.rb);
    rs.ihi = max(rs.ilo, min(slen - rs.rb, a.nw));
    kind = a.kind[sub];
    order = a.order[sub];
    psize = max(1, a.n >> a.po[sub]);
    wd = a.width[sub];
    pos = a.ckpt_pos[lane];
    param = a.ckpt_param[lane];
    esc = a.ckpt_esc[lane];
    inesc = a.ckpt_inesc[lane] != 0;
    vbase[t] = sub * a.n + kk * S;
    nvalid[t] = min(S, a.n - kk * S);
    // the first partition boundary past zero at or after the chunk
    nb = max(1, (kk * S + psize - 1) / psize) * psize;
  }
  const bool pred = kind >= 2;
  const uint32_t escape_val = (1u << wd) - 1u;
  flacx::cp_async_wait<0>();
  __syncthreads();   // the span is staged

  // three words of the row in registers from word cw = pos >> 5
  int cw = pos >> 5;
  uint32_t w0 = 0, w1 = 0, w2 = 0;
  if (valid) {
    w0 = word_at(a, rs, cw);
    w1 = word_at(a, rs, cw + 1);
    w2 = word_at(a, rs, cw + 2);
  }
  for (int q0 = 0; q0 < S; q0 += OUT) {
    if (valid) {
#pragma unroll 4
      for (int i = q0; i < q0 + OUT; ++i) {
        const int j = kk * S + i;
        const bool at_nb = j == nb;
        nb += at_nb ? psize : 0;
        const bool start = pred && j < a.n && (j == order || at_nb);
        const bool act = j < a.n && ((pred && j >= order) || kind == 1);
        // the word after the window, read ahead of the decode
        const uint32_t n1 = word_at(a, rs, cw + 3);
        const int sh = pos & 31;
        const unsigned long long win =
            ((unsigned long long)__funnelshift_l(w1, w0, sh) << 32) |
            __funnelshift_l(w2, w1, sh);

        // partition parameter field (and 5-bit escape size) in-window
        const int wf = start ? wd : 0;
        const uint32_t p_field = wf ? (uint32_t)(win >> (64 - wf)) : 0u;
        const bool is_esc = start && p_field == escape_val;
        const int nparam = start && !is_esc ? (int)p_field : param;
        const int nesc = is_esc ? (int)((win >> (59 - wf)) & 31u) : esc;
        const bool ninesc = start ? is_esc : inesc;
        const int consumed = wf + (is_esc ? 5 : 0);
        const unsigned long long vwin = win << consumed;
        // escaped: the next esc bits, signed; Rice: clz is the quotient
        const long long ev =
            nesc > 0 ? (long long)vwin >> min(64 - nesc, 63) : 0;
        const int qt = __clzll((long long)vwin);  // 64 for a zero window
        const int code_bits = qt + 1 + nparam;
        const unsigned long long rem =
            (vwin >> max(0, min(64 - code_bits, 63))) &
            ((1ull << nparam) - 1ull);
        const long long u = ((long long)qt << nparam) | (long long)rem;
        const long long rv = (u >> 1) ^ -(u & 1);
        const int used = consumed + (ninesc ? nesc : code_bits);
        long long val = 0;
        if (act) {
          param = nparam;
          esc = nesc;
          inesc = ninesc;
          bad |= used > 64;
          pos += used;
          val = ninesc ? ev : rv;
        }
        // move the window on: the words advance by d <= 1 (two for a
        // symbol of 33 bits or more, which reads one more word) unless a
        // symbol passed its window (an error), which reloads them
        const int d = (pos >> 5) - cw;
        if (d <= 1) {
          const uint32_t a0 = d == 0 ? w0 : w1;
          const uint32_t a1 = d == 0 ? w1 : w2;
          const uint32_t a2 = d == 0 ? w2 : n1;
          w0 = a0;
          w1 = a1;
          w2 = a2;
        } else if (d == 2) {
          w0 = w2;
          w1 = n1;
          w2 = word_at(a, rs, cw + 4);
        } else {
          w0 = word_at(a, rs, cw + d);
          w1 = word_at(a, rs, cw + d + 1);
          w2 = word_at(a, rs, cw + d + 2);
        }
        cw += d;
        sv[t][i - q0] = val;
      }
    }
    // the warp's OUT symbols a lane, coalesced (two lanes a store
    // instruction); warps do not wait for each other
    __syncwarp();
    const int w0l = t & ~31;
#pragma unroll
    for (int e = t & 31; e < 16 * OUT; e += 32) {   // two values a thread
      const int ln = w0l + e / (OUT / 2), i = 2 * (e % (OUT / 2));
      if (l0 + ln < lend && q0 + i < nvalid[ln]) {
        long long* dst = a.vals + vbase[ln] + q0 + i;
        if (q0 + i + 1 < nvalid[ln] && (((uintptr_t)dst) & 15u) == 0) {
          *reinterpret_cast<longlong2*>(dst) =
              make_longlong2(sv[ln][i], sv[ln][i + 1]);
        } else {
          dst[0] = sv[ln][i];
          if (q0 + i + 1 < nvalid[ln]) dst[1] = sv[ln][i + 1];
        }
      }
    }
    __syncwarp();
  }
  if (valid) {
    if (kk + 1 < a.k && pos != a.ckpt_pos[lane + 1]) bad = true;
    if (bad) a.err[0] = 1;
  }
}

}  // namespace

// rows: [f, w] bytes (w a multiple of 4, the tensor 4-byte aligned);
// ckpt_*: [f, c, k] with k = ceil(n / 64) (interval 64); kind, order, po,
// width: [f, c]; vals: [f, c, n] int64; err: one int32 the caller zeroed.
// Returns the CUDA error code.
FLACX_API int flacx_bit_unpack(const uint8_t* rows, const int32_t* ckpt_pos,
                               const int32_t* ckpt_param,
                               const int32_t* ckpt_esc,
                               const int32_t* ckpt_inesc, const int32_t* kind,
                               const int32_t* order, const int32_t* po,
                               const int32_t* width, long long* vals,
                               int32_t* err, int f, int c, int k, int n, int w,
                               int interval, cudaStream_t stream) {
  if (f <= 0 || c < 1 || n < 1 || interval != S || k != (n + S - 1) / S ||
      w < 4 || w % 4 != 0 || ((uintptr_t)rows & 3u) != 0)
    return (int)cudaErrorInvalidValue;
  // the span a block stages: its lanes' mean share of a row, one eighth
  // over, plus the 16-byte alignment and the three words past its end
  const long long mean = (long long)LANES * w / ((long long)c * k);
  const int cap = (int)min((long long)SPAN_MAX,
                           (mean + mean / 8) / 4 + 8) & ~3;
  Args a{reinterpret_cast<const uint32_t*>(rows), ckpt_pos, ckpt_param,
         ckpt_esc, ckpt_inesc, kind, order, po, width, vals, err, c, k, n,
         w / 4, cap, (long long)f * c * k, (long long)f * (w / 4)};
  const long long blocks = (a.lanes + LANES - 1) / LANES;
  bit_unpack_kernel<<<(unsigned)blocks, LANES, cap * sizeof(uint32_t),
                      stream>>>(a);
  return (int)cudaGetLastError();
}
