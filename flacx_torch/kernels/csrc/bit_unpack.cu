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
// active sample reads its 64-bit window at the cursor: the count of
// leading zeros after the fields is the Rice quotient q, the next `param`
// bits the remainder, u = q << param | rem and the value (u >> 1) ^ -(u &
// 1); in escape it is the next `esc` bits, signed (zero for esc = 0).  The
// error flag is set where an active symbol's bits pass its 64-bit window,
// or where a chunk's final cursor is not the next chunk's checkpoint.
// vals [F, C, n] int64 (zero at inactive positions).
//
// Bound on the card: bytes.  The rows are read once (3.4 MB for 256
// frames of 16-bit stereo at block 4608) and vals written once (8 B a
// sample, 18.9 MB there), about 6.7 us at 3.35 TB/s; the walk does some
// 40 integer operations a symbol (9.4 M symbols: 5.6 us at the scalar
// rate).
//
// Design: 64 lanes a block, consecutive lanes of a subframe next to each
// other.  Each thread keeps three big-endian words of its row in
// registers and loads one or two more as its cursor moves on (rows are
// 4-byte aligned: the wrapper takes widths that are multiples of 4; words
// past the row read as zero).  Each thread's 64 values go to shared memory
// (a row of 65 int64 a lane, so a half-warp's stores hit distinct banks),
// and the block writes its lanes' span of vals, which is contiguous,
// coalesced.

#include "common.cuh"

namespace {

constexpr int LANES = 64;   // threads (chunk lanes) a block
constexpr int S = 64;       // symbols a chunk (the walker's interval)

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
  int c, k, n, nw;         // channels, chunks a subframe, block, words a row
  long long lanes;
};

__device__ __forceinline__ uint32_t row_word(const uint32_t* row, int nw,
                                             int i) {
  return i < nw ? __byte_perm(__ldg(row + i), 0, 0x0123) : 0u;
}

__global__ void __launch_bounds__(LANES) bit_unpack_kernel(Args a) {
  __shared__ long long sv[LANES][S + 1];
  const int t = threadIdx.x;
  const long long l0 = (long long)blockIdx.x * LANES;
  const long long lane = l0 + t;

  if (lane < a.lanes) {
    const long long sub = lane / a.k;
    const int kk = (int)(lane - sub * a.k);
    const uint32_t* row = a.rows + (sub / a.c) * (long long)a.nw;
    const int kind = a.kind[sub], order = a.order[sub];
    const int psize = a.n >> a.po[sub], wd = a.width[sub];
    const bool pred = kind >= 2;
    const uint32_t escape_val = (1u << wd) - 1u;
    int pos = a.ckpt_pos[lane], param = a.ckpt_param[lane];
    int esc = a.ckpt_esc[lane];
    bool inesc = a.ckpt_inesc[lane] != 0, bad = false;
    int cw = pos >> 5;
    uint32_t w0 = row_word(row, a.nw, cw), w1 = row_word(row, a.nw, cw + 1),
             w2 = row_word(row, a.nw, cw + 2);
    for (int i = 0; i < S; ++i) {
      const int j = kk * S + i;
      const bool start = pred && j < a.n &&
                         (j == order || (j > 0 && j % psize == 0));
      const bool act = j < a.n && ((pred && j >= order) || kind == 1);
      if (!act) {
        sv[t][i] = 0;
        continue;
      }
      const int wi = pos >> 5, sh = pos & 31;
      if (wi != cw) {
        if (wi == cw + 1) {
          w0 = w1; w1 = w2; w2 = row_word(row, a.nw, wi + 2);
        } else if (wi == cw + 2) {
          w0 = w2; w1 = row_word(row, a.nw, wi + 1);
          w2 = row_word(row, a.nw, wi + 2);
        } else {
          w0 = row_word(row, a.nw, wi); w1 = row_word(row, a.nw, wi + 1);
          w2 = row_word(row, a.nw, wi + 2);
        }
        cw = wi;
      }
      const uint32_t hi = sh ? (w0 << sh) | (w1 >> (32 - sh)) : w0;
      const uint32_t lo = sh ? (w1 << sh) | (w2 >> (32 - sh)) : w1;
      const unsigned long long win =
          ((unsigned long long)hi << 32) | lo;

      // partition parameter field (and 5-bit escape size) in-window
      const int wf = start ? wd : 0;
      const uint32_t p_field = start ? (uint32_t)(win >> (64 - wf)) : 0u;
      const bool is_esc = start && p_field == escape_val;
      if (start && !is_esc) param = (int)p_field;
      if (is_esc) esc = (int)((win >> (59 - wf)) & 31u);
      if (start) inesc = is_esc;
      const int consumed = wf + (is_esc ? 5 : 0);
      const unsigned long long vwin = win << consumed;

      long long val;
      int used;
      if (inesc) {
        val = esc > 0 ? (long long)vwin >> min(64 - esc, 63) : 0;
        used = consumed + esc;
      } else {
        const int q = __clzll((long long)vwin);  // 64 for a zero window
        const int code_bits = q + 1 + param;
        const int rem_sh = max(0, min(64 - code_bits, 63));
        const unsigned long long rem =
            (vwin >> rem_sh) & ((1ull << param) - 1ull);
        const long long u = ((long long)q << param) | (long long)rem;
        val = (u >> 1) ^ -(u & 1);
        used = consumed + code_bits;
      }
      bad |= used > 64;
      pos += used;
      sv[t][i] = val;
    }
    if (kk + 1 < a.k && pos != a.ckpt_pos[lane + 1]) bad = true;
    if (bad) a.err[0] = 1;
  }
  __syncthreads();

  // the block's lanes cover vals[v0, v1) of the flat [F C n] array
  const long long lend = min(l0 + LANES, a.lanes);
  if (l0 >= lend) return;
  const long long sub0 = l0 / a.k, sub1 = (lend - 1) / a.k;
  const long long v0 = sub0 * a.n + (l0 - sub0 * a.k) * S;
  const int last_k = (int)(lend - 1 - sub1 * a.k);
  const long long v1 = sub1 * a.n + min((last_k + 1) * S, a.n);
  for (long long v = v0 + t; v < v1; v += LANES) {
    const long long sub = v / a.n;
    const int i = (int)(v - sub * a.n);
    const long long lane_v = sub * a.k + i / S;
    a.vals[v] = sv[lane_v - l0][i % S];
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
  Args a{reinterpret_cast<const uint32_t*>(rows), ckpt_pos, ckpt_param,
         ckpt_esc, ckpt_inesc, kind, order, po, width, vals, err, c, k, n,
         w / 4, (long long)f * c * k};
  const long long blocks = (a.lanes + LANES - 1) / LANES;
  bit_unpack_kernel<<<(unsigned)blocks, LANES, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
