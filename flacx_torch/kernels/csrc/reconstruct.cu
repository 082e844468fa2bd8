// reconstruct: the samples of a batch of FLAC frames from their decoded
// residuals: warm-up samples and constants merged in, the predictor's IIR
// run, wasted bits restored, stereo decorrelation undone, and the result
// written interleaved as int32 PCM [F, n, C].
//
// Replaces flacx/ops/reconstruct.py::reconstruct_predicted (:18),
// ::reconstruct_predicted_chunks (:73), ::reconstruct_fixed_parallel
// (:141) and ::undo_decorrelation (:184), with the glue of
// flacx/decoder.py:399-427 around them: XLA lax.scans in flacx (no Pallas
// kernel), one step a sample, which as plain torch would be several
// launches a sample.
//
// Semantics (flacx_torch.kernels.reconstruct.reconstruct_plain, integer
// for integer), in the working type Acc (int32 where the caller's int32
// bound holds, else int64; products and sums wrap in Acc):
//   r[i] = warmup[i] for i < order, const_val for a constant subframe,
//          else vals[i];
//   x[i] = r[i] + (i >= order ? (sum_j taps[j] x[i-1-j]) >> shift : 0),
//          taps zero past the order and x[-1-j] = 0;
//   x <<= wasted, then (two channels) the channel code's undecorrelation
//   (L/S, S/R, M/S with an arithmetic ch1 >> 1), cast to int32.
// A fixed subframe runs the same IIR with the walker's binomial taps and
// shift 0: it gives the same integers as flacx's nested cumsums, mod
// 2^32 as well as exactly, since both only add and multiply.  With the
// walker's sample state (state_ss > 0), chunk m of SS samples starts from
// the window state[m] = x[m SS - 32 .. m SS - 1] instead of from the
// chunk before it.  Where lim >= 0, err is set if any value of vals has
// |v| > 2^lim (the int32 route's guard, flacx/decoder.py:406-410).
//
// Bound on the card: bytes.  vals read once (8 B a sample) and pcm
// written once (4 B): 18.9 + 9.4 MB at 256 frames of 16-bit stereo at
// block 4608, 8.4 us at 3.35 TB/s; the MAC is t multiply-adds a sample.
//
// Design: one thread per (frame, channel, chunk) lane where the walker
// gave state (chunks of SS samples), else one per (frame, channel) lane
// over all n samples.  A block holds G (frame, chunk) groups with their C
// channels side by side.  The taps and the last T samples stay in
// registers, T the batch's tap bucket (4, 8, 12, 16, 32, a template): the
// samples go T at a time with the history slot of each sample fixed at
// compile time (a ring of T registers, no moves).  After each T samples
// the block's samples pass through shared memory, where each output
// element is undecorrelated from its frame's two channels and written to
// the interleaved [F, n, C] rows, a group's T C values contiguous.

#include <type_traits>

#include "common.cuh"

namespace {

struct Args {
  const long long* vals;     // [F, C, n] residuals (0 at i < order)
  const int32_t* taps;       // [F, C, 32]
  const int32_t* shift;      // [F, C]
  const int32_t* order;
  const int32_t* kind;
  const int32_t* wasted;
  const long long* warmup;   // [F, C, 32]
  const long long* const_val;  // [F, C]
  const int32_t* state;      // [F, C, Ks, 32] or null
  const int32_t* channel_code;  // [F]
  int32_t* pcm;              // [F, n, C]
  int32_t* err;              // [1]
  int f, c, n, chunk, ks, lim, groups_per_block;
  long long groups;          // F * ks
};

template <int T, typename Acc>
__global__ void reconstruct_kernel(Args a) {
  using U = std::make_unsigned_t<Acc>;
  extern __shared__ __align__(8) unsigned char smem_raw[];
  Acc* sx = reinterpret_cast<Acc*>(smem_raw);  // [G][T][C]
  const int tid = threadIdx.x;
  const int g = tid / a.c, ch = tid - g * a.c;
  const long long grp = (long long)blockIdx.x * a.groups_per_block + g;
  const bool live = g < a.groups_per_block && grp < a.groups;
  const int fr = live ? (int)(grp / a.ks) : 0;
  const int m = live ? (int)(grp - (long long)fr * a.ks) : 0;
  const long long sub = (long long)fr * a.c + ch;
  const int c0 = m * a.chunk;
  const int cend = min(c0 + a.chunk, a.n);

  int32_t tp[T];
  Acc h[T];
  int order = 0, shift = 0, kind = 0, wasted = 0;
  Acc cval = 0;
  if (live) {
    order = a.order[sub];
    shift = a.shift[sub];
    kind = a.kind[sub];
    wasted = a.wasted[sub];
    cval = (Acc)a.const_val[sub];
  }
#pragma unroll
  for (int j = 0; j < T; ++j) {
    tp[j] = live ? a.taps[sub * 32 + j] : 0;
    h[j] = (live && a.state)
               ? (Acc)a.state[(sub * a.ks + m) * 32 + 32 - T + j]
               : 0;
  }
  const long long* vrow = a.vals + sub * a.n;
  const long long* wrow = a.warmup + sub * 32;
  bool bad = false;

  for (int b = c0; b < c0 + a.chunk; b += T) {
#pragma unroll
    for (int s = 0; s < T; ++s) {
      const int i = b + s;
      Acc r = 0;
      if (live && i < cend) {
        const long long v = vrow[i];
        if (a.lim >= 0 && (v > (1LL << a.lim) || -v > (1LL << a.lim)))
          bad = true;
        r = kind == 0 ? cval : i < order ? (Acc)wrow[i] : (Acc)v;
      }
      U acc = 0;
#pragma unroll
      for (int j = 0; j < T; ++j)
        acc += (U)(Acc)tp[j] * (U)h[(s - 1 - j + 2 * T) % T];
      const Acc pred = (Acc)acc >> shift;
      h[s] = (Acc)((U)r + (U)(i >= order ? pred : (Acc)0));
      if (live)
        sx[(g * T + s) * a.c + ch] =
            wasted < (int)(8 * sizeof(Acc)) ? (Acc)((U)h[s] << wasted) : 0;
    }
    __syncthreads();
    const int per = T * a.c;
    const int nthreads = a.groups_per_block * a.c;
    for (int e = tid; e < a.groups_per_block * per; e += nthreads) {
      const int eg = e / per, rem = e - eg * per;
      const int s = rem / a.c, ech = rem - s * a.c;
      const long long egrp = (long long)blockIdx.x * a.groups_per_block + eg;
      if (egrp >= a.groups) continue;
      const int efr = (int)(egrp / a.ks);
      const int ei = (int)(egrp - (long long)efr * a.ks) * a.chunk + (b - c0)
                     + s;
      if (ei >= min((int)(egrp - (long long)efr * a.ks) * a.chunk + a.chunk,
                    a.n))
        continue;
      const Acc* pair = sx + (eg * T + s) * a.c;
      Acc out = pair[ech];
      if (a.c == 2) {
        const Acc ch0 = pair[0], ch1 = pair[1];
        const int code = a.channel_code[efr];
        if (code == 8) {          // left/side
          out = ech ? (Acc)((U)ch0 - (U)ch1) : ch0;
        } else if (code == 9) {   // side/right
          out = ech ? ch1 : (Acc)((U)ch0 + (U)ch1);
        } else if (code == 10) {  // mid/side
          const Acc right = (Acc)((U)ch0 - (U)(Acc)(ch1 >> 1));
          out = ech ? right : (Acc)((U)right + (U)ch1);
        }
      }
      a.pcm[((long long)efr * a.n + ei) * a.c + ech] = (int32_t)out;
    }
    __syncthreads();
  }
  if (bad) a.err[0] = 1;
}

template <typename Acc>
int launch(const Args& a, int t, int blocks, int threads,
           cudaStream_t stream) {
  const size_t smem = (size_t)threads * t * sizeof(Acc);
  switch (t) {
    case 4:
      reconstruct_kernel<4, Acc><<<blocks, threads, smem, stream>>>(a);
      break;
    case 8:
      reconstruct_kernel<8, Acc><<<blocks, threads, smem, stream>>>(a);
      break;
    case 12:
      reconstruct_kernel<12, Acc><<<blocks, threads, smem, stream>>>(a);
      break;
    case 16:
      reconstruct_kernel<16, Acc><<<blocks, threads, smem, stream>>>(a);
      break;
    case 32:
      reconstruct_kernel<32, Acc><<<blocks, threads, smem, stream>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// vals [f, c, n] int64; taps [f, c, 32]; shift, order, kind, wasted
// [f, c]; warmup [f, c, 32] int64; const_val [f, c] int64; state
// [f, c, ks, 32] or null (then ks = 1 and the chunk is n); channel_code
// [f]; pcm [f, n, c] int32; err one int32 the caller zeroed.  t the tap
// bucket, wide: int64 working type, lim < 0: no residual guard, chunk
// the state interval (ignored without state), groups_per_block the
// (frame, chunk) groups of a block.  Returns the CUDA error code.
FLACX_API int flacx_reconstruct(const long long* vals, const int32_t* taps,
                                const int32_t* shift, const int32_t* order,
                                const int32_t* kind, const int32_t* wasted,
                                const long long* warmup,
                                const long long* const_val,
                                const int32_t* state,
                                const int32_t* channel_code, int32_t* pcm,
                                int32_t* err, int f, int c, int n, int t,
                                int wide, int lim, int chunk, int ks,
                                int groups_per_block, cudaStream_t stream) {
  if (f <= 0 || c < 1 || c > 8 || n < 1 || lim > 62 ||
      groups_per_block < 1 || groups_per_block * c > 1024)
    return (int)cudaErrorInvalidValue;
  if (state == nullptr) {
    chunk = n;
    ks = 1;
  } else if (chunk < 1 || ks != (n + chunk - 1) / chunk) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{vals, taps, shift, order, kind, wasted, warmup, const_val, state,
         channel_code, pcm, err, f, c, n, chunk, ks, lim, groups_per_block,
         (long long)f * ks};
  const long long blocks = (a.groups + groups_per_block - 1) /
                           groups_per_block;
  const int threads = groups_per_block * c;
  return wide ? launch<long long>(a, t, (int)blocks, threads, stream)
              : launch<int32_t>(a, t, (int)blocks, threads, stream);
}
