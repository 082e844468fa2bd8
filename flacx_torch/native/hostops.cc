// flacx_torch native host runtime: the host half of the batched decoder.
//
// The frame-boundary candidate scan, the staging of frame byte spans into
// padded rows, table-driven CRC-16 over many rows, the full frame parse of
// the host route, and the structure walker whose checkpoints feed the
// device kernels (flacx_torch/kernels/bit_unpack.py, reconstruct.py).
//
// Built with the system compiler at first use (flacx_torch/native/build.py,
// plain c++ -O3 -shared) and loaded via ctypes; there is no Python
// fallback: a build failure raises with the compiler's output.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <type_traits>
#include <vector>

extern "C" {

// CRC-16 (poly 0x8005, init 0, MSB-first) of rows[i][:lengths[i]].
void fxt_crc16_rows(const uint8_t* data, const int32_t* lengths,
                      int64_t n_rows, int64_t row_stride, uint16_t* out) {
    static uint16_t table[256];
    static bool init = false;
    if (!init) {
        for (int b = 0; b < 256; ++b) {
            uint32_t v = static_cast<uint32_t>(b) << 8;
            for (int i = 0; i < 8; ++i) {
                v <<= 1;
                if (v & 0x10000) v ^= 0x18005;
            }
            table[b] = static_cast<uint16_t>(v & 0xFFFF);
        }
        init = true;
    }
    for (int64_t r = 0; r < n_rows; ++r) {
        const uint8_t* row = data + r * row_stride;
        uint16_t crc = 0;
        const int64_t len = lengths[r];
        for (int64_t i = 0; i < len; ++i) {
            crc = static_cast<uint16_t>((crc << 8)
                                        ^ table[(crc >> 8) ^ row[i]]);
        }
        out[r] = crc;
    }
}

// Scatter variable-length frame spans into a padded row matrix:
// rows[i][:ends[i]-offs[i]] = data[offs[i]:ends[i]], zero-filling each
// row's tail, in place of a per-frame Python copy loop.  Threaded across
// rows (rows are independent).
void fxt_scatter_rows(const uint8_t* data, const int64_t* offs,
                        const int64_t* ends, int64_t n_rows,
                        uint8_t* rows, int64_t row_stride) {
    auto run = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            const int64_t len = ends[i] - offs[i];
            uint8_t* dst = rows + i * row_stride;
            std::memcpy(dst, data + offs[i], len);
            std::memset(dst + len, 0, row_stride - len);
        }
    };
    const unsigned hw = std::thread::hardware_concurrency();
    const int nt = (n_rows >= 64 && hw > 1)
        ? static_cast<int>(std::min<int64_t>(std::min<unsigned>(hw, 8),
                                             n_rows / 16))
        : 1;
    if (nt <= 1) { run(0, n_rows); return; }
    std::vector<std::thread> threads;
    const int64_t chunk = (n_rows + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min<int64_t>(lo + chunk, n_rows);
        if (lo >= hi) break;
        threads.emplace_back(run, lo, hi);
    }
    for (auto& th : threads) th.join();
}

// Frame-boundary candidate scan: sync pattern + header CRC-8 filter +
// coded-number / block-size decode, one pass over the stream
// (flacx_torch/decoder.py::_scan_candidates).  Returns
// the number of candidates written (never exceeds `cap`; callers size
// cap = the count of 0xFF bytes, an upper bound on candidates).
int64_t fxt_scan_candidates(const uint8_t* data, int64_t nbytes,
                              int64_t first, int64_t* offs, int64_t* nums,
                              int32_t* strats, int64_t* bsizes,
                              int64_t cap) {
    static uint8_t table8[256];
    static bool init8 = false;
    if (!init8) {
        for (int b = 0; b < 256; ++b) {
            uint32_t v = b;
            for (int i = 0; i < 8; ++i) {
                v <<= 1;
                if (v & 0x100) v ^= 0x107;
            }
            table8[b] = static_cast<uint8_t>(v & 0xFF);
        }
        init8 = true;
    }
    static const int32_t kBsLut[16] = {0, 192, 576, 1152, 2304, 4608, 0, 0,
                                       256, 512, 1024, 2048, 4096, 8192,
                                       16384, 32768};
    const int64_t lim = nbytes - 6;
    int64_t count = 0;
    for (int64_t i = first; i < lim && count < cap; ++i) {
        if (data[i] != 0xFF) {
            // skip to the next 0xFF quickly
            const void* p = std::memchr(data + i, 0xFF, lim - i);
            if (p == nullptr) break;
            i = static_cast<const uint8_t*>(p) - data;
        }
        if ((data[i + 1] & 0xFE) != 0xF8) continue;
        const uint32_t b0 = data[i + 4];
        int extra = 0;                      // coded-number continuation
        for (uint32_t m = 0x80; m && (b0 & m); m >>= 1) ++extra;
        if (extra > 0) --extra;
        const uint32_t code = data[i + 2];
        const uint32_t bs_code = code >> 4;
        const uint32_t sr_code = code & 0xF;
        if (bs_code == 0) continue;         // reserved
        const int64_t hdr_len = 5 + extra
            + (bs_code == 6 ? 1 : bs_code == 7 ? 2 : 0)
            + (sr_code == 12 ? 1 : (sr_code == 13 || sr_code == 14) ? 2 : 0);
        if (i + hdr_len >= nbytes) continue;
        uint8_t crc = 0;
        for (int64_t j = 0; j < hdr_len; ++j)
            crc = table8[data[i + j] ^ crc];
        if (data[i + hdr_len] != crc) continue;
        // coded-number decode with continuation validation
        int64_t num = extra == 0
            ? static_cast<int64_t>(b0)
            : static_cast<int64_t>(b0 & (0xFFu >> (extra + 2)));
        bool ok = true;
        for (int j = 1; j <= extra; ++j) {
            const uint32_t cont = data[i + 4 + j];
            if ((cont & 0xC0) != 0x80) { ok = false; break; }
            num = (num << 6) | (cont & 0x3F);
        }
        if (!ok) continue;
        int64_t bsize = kBsLut[bs_code];
        const int64_t pos_bs = i + 5 + extra;
        if (bs_code == 6) bsize = static_cast<int64_t>(data[pos_bs]) + 1;
        else if (bs_code == 7)
            bsize = ((static_cast<int64_t>(data[pos_bs]) << 8)
                     | data[pos_bs + 1]) + 1;
        offs[count] = i;
        nums[count] = num;
        strats[count] = data[i + 1] & 1;
        bsizes[count] = bsize;
        ++count;
    }
    return count;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// FLAC frame parser: the decode-side host runtime.
//
// Parses a batch of equal-block-size frames into structure-of-arrays form
// (flacx_torch/hostdec.py); predictor reconstruction then runs on the
// device (flacx_torch/kernels/reconstruct.py).  Grammar per RFC 9639.

namespace {

struct BitCursor {
    const uint8_t* d;
    int64_t nbytes;
    int64_t pos;  // bit offset

    inline uint64_t window() const {
        // 64 bits starting at pos (MSB-first), zero-padded past the end
        int64_t byte0 = pos >> 3;
        uint64_t w = 0;
        for (int i = 0; i < 9; ++i) {
            uint64_t b = (byte0 + i < nbytes) ? d[byte0 + i] : 0;
            if (i < 8) w = (w << 8) | b;
            else {
                int sh = static_cast<int>(pos & 7);
                if (sh) w = (w << sh) | (b >> (8 - sh));
            }
        }
        return w;
    }

    inline uint64_t read(int n) {
        if (n == 0) return 0;
        uint64_t v = window() >> (64 - n);
        pos += n;
        return v;
    }

    inline int64_t read_signed(int n) {
        if (n == 0) return 0;
        int64_t x = static_cast<int64_t>(read(n));
        if (x >> (n - 1)) x -= (int64_t(1) << n);
        return x;
    }

    inline int64_t read_unary() {
        int64_t q = 0;
        for (;;) {
            uint64_t w = window();
            if (w == 0) {
                q += 64;
                pos += 64;
                if (pos > nbytes * 8 + 64) return -1;  // corrupt
                continue;
            }
            int lz = __builtin_clzll(w);
            pos += lz + 1;
            return q + lz;
        }
    }
};

const int kFixedTaps[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0},
    {3, -3, 1, 0}, {4, -6, 4, -1}};

// Frame-header sample-size codes (RFC 9639 §9.1.3): 0 = from streaminfo,
// 3 reserved.
const int kSampleSize[8] = {0, 8, 12, -1, 16, 20, 24, 32};

}  // namespace

extern "C" {

// Returns 0 on success, (row + 1) on a parse error in that row.
int64_t fxt_parse_frames(const uint8_t* data, int64_t n_rows,
                           int64_t row_stride, const int64_t* start_bits,
                           int32_t block_size, int32_t channels, int32_t bps,
                           int32_t* channel_code, int32_t* kind,
                           int32_t* order, int32_t* shift, int32_t* wasted,
                           int32_t* taps /* [F,C,32] */,
                           int64_t* residual /* [F,C,N] */,
                           int64_t* end_bits /* [F] */,
                           int32_t* fbps /* [F] or null */) {
    const int64_t n = block_size;
    for (int64_t r = 0; r < n_rows; ++r) {
        BitCursor cur{data + r * row_stride, row_stride, start_bits[r]};

        // ---- frame header (sync/CRC already validated by the scanner)
        cur.read(16);                       // sync + blocking strategy
        uint32_t bs_code = static_cast<uint32_t>(cur.read(4));
        uint32_t sr_code = static_cast<uint32_t>(cur.read(4));
        uint32_t ch_code = static_cast<uint32_t>(cur.read(4));
        // per-frame sample-size override (code 0 = from streaminfo)
        uint32_t ss_code = static_cast<uint32_t>(cur.read(3));
        cur.read(1);                        // reserved
        if (ss_code == 3) return r + 1;
        const int fb = ss_code ? kSampleSize[ss_code] : bps;
        if (fbps) fbps[r] = fb;
        uint32_t b0 = static_cast<uint32_t>(cur.read(8));
        int extra = 0;                      // coded-number continuation
        for (uint32_t m = 0x80; m && (b0 & m); m >>= 1) ++extra;
        if (extra > 0) --extra;
        cur.read(8 * extra);
        if (bs_code == 6) cur.read(8);
        else if (bs_code == 7) cur.read(16);
        if (sr_code == 12) cur.read(8);
        else if (sr_code == 13 || sr_code == 14) cur.read(16);
        cur.read(8);                        // header CRC

        channel_code[r] = static_cast<int32_t>(ch_code);
        int decorr[8] = {0};
        if (channels == 2) {
            if (ch_code == 8) decorr[1] = 1;        // L/S
            else if (ch_code == 9) decorr[0] = 1;   // S/R
            else if (ch_code == 10) decorr[1] = 1;  // M/S
        }

        for (int c = 0; c < channels; ++c) {
            const int64_t sub = (r * channels + c);
            int64_t* res = residual + sub * n;
            int32_t* tp = taps + sub * 32;

            if (cur.read(1) != 0) return r + 1;
            uint32_t type_code = static_cast<uint32_t>(cur.read(6));
            int w = 0;
            if (cur.read(1) == 1) {
                int64_t u = cur.read_unary();
                if (u < 0) return r + 1;
                w = static_cast<int>(u) + 1;
            }
            wasted[sub] = w;
            int eff = fb + decorr[c] - w;

            int k, o;
            if (type_code == 0) { k = 0; o = 0; }
            else if (type_code == 1) { k = 1; o = 0; }
            else if (type_code >= 8 && type_code <= 12) {
                k = 2; o = static_cast<int>(type_code & 7);
            } else if (type_code >= 32) {
                k = 3; o = static_cast<int>(type_code & 31) + 1;
            } else return r + 1;
            kind[sub] = k;
            order[sub] = o;
            shift[sub] = 0;

            if (k == 0) {                    // constant
                int64_t v = cur.read_signed(eff);
                for (int64_t i = 0; i < n; ++i) res[i] = v;
                continue;
            }
            if (k == 1) {                    // verbatim
                for (int64_t i = 0; i < n; ++i)
                    res[i] = cur.read_signed(eff);
                continue;
            }
            for (int i = 0; i < o; ++i)      // warmup
                res[i] = cur.read_signed(eff);
            if (k == 3) {                    // LPC meta + coefficients
                int prec = static_cast<int>(cur.read(4));
                if (prec == 15) return r + 1;
                ++prec;
                // the shift field is coded signed but RFC 9639 forbids
                // negative values
                int64_t sh = cur.read_signed(5);
                if (sh < 0) return r + 1;
                shift[sub] = static_cast<int32_t>(sh);
                for (int i = 0; i < o; ++i)
                    tp[i] = static_cast<int32_t>(cur.read_signed(prec));
            } else {
                for (int i = 0; i < 4; ++i) tp[i] = kFixedTaps[o][i];
            }

            // residual partitions
            uint32_t method = static_cast<uint32_t>(cur.read(2));
            if (method > 1) return r + 1;
            int width = method == 0 ? 4 : 5;
            uint32_t escape = (1u << width) - 1;
            int po = static_cast<int>(cur.read(4));
            int64_t nparts = int64_t(1) << po;
            if (n % nparts || (n >> po) <= o) return r + 1;
            int64_t psize = n >> po;
            int64_t i = o;
            for (int64_t p = 0; p < nparts; ++p) {
                int64_t limit = (p + 1) * psize;
                uint32_t param = static_cast<uint32_t>(cur.read(width));
                if (param == escape) {
                    int esc = static_cast<int>(cur.read(5));
                    for (; i < limit; ++i) res[i] = cur.read_signed(esc);
                } else {
                    for (; i < limit; ++i) {
                        int64_t q = cur.read_unary();
                        if (q < 0) return r + 1;
                        uint64_t u = (static_cast<uint64_t>(q) << param)
                                     | cur.read(param);
                        res[i] = static_cast<int64_t>(u >> 1)
                                 ^ -static_cast<int64_t>(u & 1);
                    }
                }
            }
        }
        // end_bits is the pre-padding cursor; padding content is covered
        // by the frame CRC check
        end_bits[r] = cur.pos;
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Structure walker: the host half of the device decode path.
//
// Parses frame/subframe headers, warmup samples and LPC coefficients, then
// WALKS the residual symbols (one clz per Rice code, no value extraction,
// no stores) emitting a checkpoint of the bit cursor + partition state
// every `ckpt_interval` samples.  The device kernel
// (flacx_torch/kernels/csrc/bit_unpack.cu) then decodes all chunks of a
// batch in parallel from the checkpoints.  Replaces the value-extracting
// serial parse for the hot path; grammar per RFC 9639.

namespace {

struct FastCursor {
    const uint8_t* d;
    int64_t nbytes;
    int64_t pos;  // bit offset

    inline uint64_t win() const {
        // 64 bits starting at pos (MSB-first), zero-padded past the end
        const int64_t b = pos >> 3;
        uint64_t w;
        if (b + 9 <= nbytes) {
            std::memcpy(&w, d + b, 8);
            w = __builtin_bswap64(w);
            const int sh = static_cast<int>(pos & 7);
            if (sh) w = (w << sh) | (d[b + 8] >> (8 - sh));
        } else {
            w = 0;
            for (int i = 0; i < 8; ++i)
                w = (w << 8) | (b + i < nbytes ? d[b + i] : 0);
            const int sh = static_cast<int>(pos & 7);
            if (sh) {
                const uint64_t nb = (b + 8 < nbytes) ? d[b + 8] : 0;
                w = (w << sh) | (nb >> (8 - sh));
            }
        }
        return w;
    }

    inline uint64_t read(int n) {
        if (n == 0) return 0;
        const uint64_t v = win() >> (64 - n);
        pos += n;
        return v;
    }

    inline int64_t read_signed(int n) {
        if (n == 0) return 0;
        int64_t x = static_cast<int64_t>(read(n));
        if (x >> (n - 1)) x -= (int64_t(1) << n);
        return x;
    }

    inline int64_t read_unary() {
        int64_t q = 0;
        for (;;) {
            const uint64_t w = win();
            if (w == 0) {
                q += 64;
                pos += 64;
                if (pos > nbytes * 8 + 64) return -1;  // corrupt
                continue;
            }
            const int lz = __builtin_clzll(w);
            pos += lz + 1;
            return q + lz;
        }
    }
};

// One step of the inline reconstruction IIR: val + (Σ_t tp[t]·hp[-1-t] >>
// sh), the history H int32 (every sample of the stream fits it) or int64.
// The int64 MAC and add run in uint64, so a malformed stream wraps mod
// 2^64 as the reconstruct kernel's does, where signed overflow would be
// undefined.  OB: tap-count bucket — taps are zero past the true order, so
// the fixed-trip MAC over OB entries is exact for any order <= OB and
// lets the compiler unroll/vectorize it.
template <int OB, typename H>
inline H iir_step(int64_t val, const int32_t* tp, int32_t sh, const H* hp) {
    if constexpr (sizeof(H) == 4) {
        int64_t acc = 0;
        for (int t = 0; t < OB; ++t)
            acc += static_cast<int64_t>(tp[t]) * hp[-1 - t];
        return static_cast<int32_t>(val + (acc >> sh));
    } else {
        uint64_t acc = 0;
        for (int t = 0; t < OB; ++t)
            acc += static_cast<uint64_t>(static_cast<int64_t>(tp[t]))
                   * static_cast<uint64_t>(hp[-1 - t]);
        return static_cast<int64_t>(
            static_cast<uint64_t>(val)
            + static_cast<uint64_t>(static_cast<int64_t>(acc) >> sh));
    }
}

// Advance (and with WS, decode + reconstruct) `count` residual samples of
// one Rice/escape segment — the event-free inner loop of the walker.  The
// caller has segmented the walk so that no checkpoint, sample-state or
// partition boundary falls strictly inside the run: no per-sample modulo
// or boundary checks remain here.
//
// WS: maintain the decoded-sample history `hp` (the inline reconstruction
// IIR, hp[i] = x[j+i]) by iir_step over the OB-tap bucket.
template <bool WS, int OB, typename H>
inline bool walk_run(FastCursor& cur, int64_t count, bool inesc,
                     int64_t param, int64_t esc, const int32_t* tp,
                     int32_t sh, H* hp) {
    if (inesc) {
        if (!WS) {
            cur.pos += esc * count;
            return true;
        }
        for (int64_t i = 0; i < count; ++i) {
            const int64_t val = cur.read_signed(static_cast<int>(esc));
            hp[i] = iir_step<OB>(val, tp, sh, hp + i);
        }
        return true;
    }
    const uint64_t vmask = (param ? ((1ull << param) - 1) : 0);
    for (int64_t i = 0; i < count; ++i) {
        const uint64_t w = cur.win();
        int64_t q;
        uint64_t u = 0;
        if (__builtin_expect(w == 0, 0)) {   // long unary run (rare)
            q = cur.read_unary();
            if (q < 0) return false;
            if (WS) u = (static_cast<uint64_t>(q) << param)
                        | cur.read(static_cast<int>(param));
        } else {
            q = __builtin_clzll(w);
            const int64_t total = q + 1 + param;
            if (__builtin_expect(total <= 64, 1)) {
                // quotient and value bits from the SAME window: one
                // win() per sample instead of two
                if (WS) u = (static_cast<uint64_t>(q) << param)
                            | ((w >> (64 - total)) & vmask);
                cur.pos += total;
            } else {
                cur.pos += q + 1;
                if (WS) u = (static_cast<uint64_t>(q) << param)
                            | cur.read(static_cast<int>(param));
                else cur.pos += param;
            }
        }
        if (WS) {
            const int64_t val = static_cast<int64_t>(u >> 1)
                                ^ -static_cast<int64_t>(u & 1);
            hp[i] = iir_step<OB>(val, tp, sh, hp + i);
        }
    }
    return true;
}

// Order-bucket dispatch for the state-maintaining run.
template <typename H>
inline bool walk_run_ws(int ob, FastCursor& cur, int64_t count, bool inesc,
                        int64_t param, int64_t esc, const int32_t* tp,
                        int32_t sh, H* hp) {
    switch (ob) {
        case 4:  return walk_run<true, 4>(cur, count, inesc, param, esc,
                                          tp, sh, hp);
        case 8:  return walk_run<true, 8>(cur, count, inesc, param, esc,
                                          tp, sh, hp);
        case 12: return walk_run<true, 12>(cur, count, inesc, param, esc,
                                           tp, sh, hp);
        case 16: return walk_run<true, 16>(cur, count, inesc, param, esc,
                                           tp, sh, hp);
        default: return walk_run<true, 32>(cur, count, inesc, param, esc,
                                           tp, sh, hp);
    }
}

}  // namespace

extern "C" {

// Returns 0 on success, (row + 1) on a parse error in that row.
// K = (block_size + ckpt_interval - 1) / ckpt_interval checkpoints per
// subframe; checkpoint j state is the cursor BEFORE any partition
// parameter field read at sample j*ckpt_interval.
//
// When state_interval > 0 the walker additionally DECODES residual values
// and runs the integer reconstruction IIR inline (same semantics as
// flacx_torch/ops/reconstruct.py: x[i] = r[i] + (Σ_j c_j·x[i-1-j] >> shift)
// for i >= order, warmup verbatim below),
// emitting the last-32-samples window before every state_interval
// boundary into ckpt_state [F, C, Ks, 32] (Ks = ceil(n/state_interval)).
// These sample-state checkpoints let the device reconstruct all
// state_interval-sample chunks of a batch IN PARALLEL instead of one
// block-length serial scan.  One pointer, two widths: with state_wide = 0
// the history and ckpt_state are int32 (a valid stream's samples fit it
// whenever bps + 1 <= 31: the caller's rule is bps + (a stereo side
// channel) <= 31), with state_wide = 1 both are int64 (every width up to a
// 33-bit side channel), their MAC and add wrapping mod 2^64.
int64_t fxt_scan_frames(const uint8_t* data, int64_t n_rows,
                          int64_t row_stride, const int64_t* start_bits,
                          int32_t block_size, int32_t channels, int32_t bps,
                          int32_t ckpt_interval, int32_t state_interval,
                          int32_t state_wide,
                          int32_t* channel_code,          // [F]
                          int32_t* kind, int32_t* order,  // [F,C]
                          int32_t* shift, int32_t* wasted,
                          int32_t* po, int32_t* width,    // [F,C]
                          int32_t* taps,                  // [F,C,32]
                          int64_t* warmup,                // [F,C,32]
                          int64_t* const_val,             // [F,C]
                          int32_t* ckpt_pos,              // [F,C,K]
                          int32_t* ckpt_param,            // [F,C,K]
                          int32_t* ckpt_esc,              // [F,C,K]
                          int32_t* ckpt_inesc,            // [F,C,K]
                          void* ckpt_state,               // [F,C,Ks,32]
                          int64_t* end_bits,              // [F]
                          int32_t* fbps) {                // [F] or null
    const int64_t n = block_size;
    const int S = ckpt_interval;
    const int64_t K = (n + S - 1) / S;
    const int SS = state_interval;
    const int64_t KS = SS > 0 ? (n + SS - 1) / SS : 0;
    // Per-row body; rows are fully independent (each writes disjoint
    // output slices), so the batch walk is threaded across cores below.
    // `hist` is a per-thread scratch of 32 zeros + n decoded samples of
    // the history type H (the 32-slot zero lead backs both the MAC's
    // pre-warmup reads and the device contract that pre-stream state is
    // zero).
    auto scan_one = [&](int64_t r, auto* hist) -> int64_t {
        using H = std::remove_pointer_t<decltype(hist)>;
        FastCursor cur{data + r * row_stride, row_stride, start_bits[r]};

        // ---- frame header (sync/CRC already validated by the scanner)
        cur.read(16);                       // sync + blocking strategy
        uint32_t bs_code = static_cast<uint32_t>(cur.read(4));
        uint32_t sr_code = static_cast<uint32_t>(cur.read(4));
        uint32_t ch_code = static_cast<uint32_t>(cur.read(4));
        // per-frame sample-size override (code 0 = from streaminfo)
        uint32_t ss_code = static_cast<uint32_t>(cur.read(3));
        cur.read(1);                        // reserved
        if (ss_code == 3) return r + 1;
        const int fb = ss_code ? kSampleSize[ss_code] : bps;
        if (fbps) fbps[r] = fb;
        uint32_t b0 = static_cast<uint32_t>(cur.read(8));
        int extra = 0;                      // coded-number continuation
        for (uint32_t m = 0x80; m && (b0 & m); m >>= 1) ++extra;
        if (extra > 0) --extra;
        cur.read(8 * extra);
        if (bs_code == 6) cur.read(8);
        else if (bs_code == 7) cur.read(16);
        if (sr_code == 12) cur.read(8);
        else if (sr_code == 13 || sr_code == 14) cur.read(16);
        cur.read(8);                        // header CRC

        channel_code[r] = static_cast<int32_t>(ch_code);
        int decorr[8] = {0};
        if (channels == 2) {
            if (ch_code == 8) decorr[1] = 1;        // L/S
            else if (ch_code == 9) decorr[0] = 1;   // S/R
            else if (ch_code == 10) decorr[1] = 1;  // M/S
        }

        for (int c = 0; c < channels; ++c) {
            const int64_t sub = (r * channels + c);
            int32_t* tp = taps + sub * 32;
            int64_t* wu = warmup + sub * 32;
            int32_t* cpos = ckpt_pos + sub * K;
            int32_t* cpar = ckpt_param + sub * K;
            int32_t* cesc = ckpt_esc + sub * K;
            int32_t* cine = ckpt_inesc + sub * K;
            H* cst = SS > 0 ? static_cast<H*>(ckpt_state) + sub * KS * 32
                            : nullptr;

            if (cur.read(1) != 0) return r + 1;
            uint32_t type_code = static_cast<uint32_t>(cur.read(6));
            int w = 0;
            if (cur.read(1) == 1) {
                int64_t u = cur.read_unary();
                if (u < 0) return r + 1;
                w = static_cast<int>(u) + 1;
            }
            wasted[sub] = w;
            const int eff = fb + decorr[c] - w;
            if (eff <= 0 || eff > 33) return r + 1;

            int k, o;
            if (type_code == 0) { k = 0; o = 0; }
            else if (type_code == 1) { k = 1; o = 0; }
            else if (type_code >= 8 && type_code <= 12) {
                k = 2; o = static_cast<int>(type_code & 7);
            } else if (type_code >= 32) {
                k = 3; o = static_cast<int>(type_code & 31) + 1;
            } else return r + 1;
            kind[sub] = k;
            order[sub] = o;
            shift[sub] = 0;
            po[sub] = 0;
            width[sub] = 4;
            const_val[sub] = 0;

            if (k == 0) {                    // constant: one value, no walk
                const_val[sub] = cur.read_signed(eff);
                for (int64_t m = 0; m < K; ++m) {
                    cpos[m] = 0; cpar[m] = 0; cesc[m] = 0; cine[m] = 0;
                }
                continue;                    // state stays zero (unused)
            }
            if (k == 1) {                    // verbatim: eff bits per sample
                for (int64_t m = 0; m < K; ++m) {
                    cpos[m] = static_cast<int32_t>(cur.pos
                                                   + m * S * int64_t(eff));
                    cpar[m] = 0; cesc[m] = eff; cine[m] = 1;
                }
                cur.pos += n * int64_t(eff);
                continue;
            }
            for (int i = 0; i < o; ++i)      // warmup
                wu[i] = cur.read_signed(eff);
            if (k == 3) {                    // LPC meta + coefficients
                int prec = static_cast<int>(cur.read(4));
                if (prec == 15) return r + 1;
                ++prec;
                int64_t sh = cur.read_signed(5);
                if (sh < 0) return r + 1;    // forbidden by RFC 9639
                shift[sub] = static_cast<int32_t>(sh);
                for (int i = 0; i < o; ++i)
                    tp[i] = static_cast<int32_t>(cur.read_signed(prec));
            } else {
                for (int i = 0; i < 4; ++i) tp[i] = kFixedTaps[o][i];
            }

            // residual walk with checkpoints
            uint32_t method = static_cast<uint32_t>(cur.read(2));
            if (method > 1) return r + 1;
            const int wd = method == 0 ? 4 : 5;
            const uint32_t escape = (1u << wd) - 1;
            const int p_order = static_cast<int>(cur.read(4));
            const int64_t nparts = int64_t(1) << p_order;
            if (n % nparts || (n >> p_order) <= o) return r + 1;
            const int64_t psize = n >> p_order;
            po[sub] = p_order;
            width[sub] = wd;

            int64_t param = 0, esc = 0;
            bool inesc = false;
            const int64_t bit_limit = row_stride * 8;
            const bool want_state = cst != nullptr;
            // smallest tap bucket covering the order (taps are zero past
            // the true order, so the bucketed MAC is exact)
            const int ob = o <= 4 ? 4 : o <= 8 ? 8 : o <= 12 ? 12
                           : o <= 16 ? 16 : 32;
            H* h = hist + 32;                // 32-slot zero lead
            if (want_state)
                for (int i = 0; i < 32; ++i) hist[i] = 0;

            // The walk is segmented at its EVENT positions — checkpoint
            // boundaries (every S), sample-state boundaries (every SS)
            // and partition boundaries — so the per-sample inner loop
            // (walk_run) carries no modulo or boundary checks at all.
            int64_t next_ckpt = 0;
            const int64_t never = int64_t(1) << 62;
            int64_t next_state = want_state ? 0 : never;
            auto emit_events = [&](int64_t j) {
                if (j == next_ckpt) {
                    const int64_t m = j / S;
                    cpos[m] = static_cast<int32_t>(cur.pos);
                    cpar[m] = static_cast<int32_t>(param);
                    cesc[m] = static_cast<int32_t>(esc);
                    cine[m] = inesc ? 1 : 0;
                    next_ckpt += S;
                }
                if (j == next_state) {
                    // window BEFORE sample j: slot i = x[j-32+i] (the
                    // zero lead supplies zeros for j < 32, matching the
                    // device scan's zero init)
                    H* w32 = cst + (j / SS) * 32;
                    for (int i = 0; i < 32; ++i) w32[i] = h[j - 32 + i];
                    next_state += SS;
                }
            };

            for (int64_t j = 0; j < o; ++j) {  // warmup positions
                emit_events(j);
                if (want_state) h[j] = static_cast<H>(wu[j]);
            }
            int64_t j = o;
            for (int64_t p = 0; p < nparts; ++p) {
                const int64_t limit = (p + 1) * psize;
                emit_events(j);              // boundary state is the
                                             // cursor BEFORE this field
                const uint32_t pf = static_cast<uint32_t>(cur.read(wd));
                if (pf == escape) { esc = cur.read(5); inesc = true; }
                else { param = pf; inesc = false; }
                while (j < limit) {
                    int64_t run_end = limit < next_ckpt ? limit : next_ckpt;
                    if (next_state < run_end) run_end = next_state;
                    const bool okr = want_state
                        ? walk_run_ws(ob, cur, run_end - j, inesc, param,
                                      esc, tp, shift[sub], h + j)
                        : walk_run<false, 4, H>(cur, run_end - j, inesc,
                                                param, esc, nullptr, 0,
                                                nullptr);
                    if (!okr || cur.pos > bit_limit) return r + 1;
                    j = run_end;
                    if (j < limit) emit_events(j);
                }
            }
        }
        end_bits[r] = cur.pos;
        return 0;
    };

    const unsigned hw = std::thread::hardware_concurrency();
    const int nt = (n_rows >= 64 && hw > 1)
        ? static_cast<int>(std::min<int64_t>(std::min<unsigned>(hw, 16),
                                             n_rows / 16))
        : 1;
    const size_t hist_len = static_cast<size_t>(n) + 32;
    // the batch walk with history type H (a value of it selects it)
    auto scan_rows = [&](auto h_type) -> int64_t {
        using H = decltype(h_type);
        if (nt <= 1) {
            std::vector<H> hist(hist_len);
            for (int64_t r = 0; r < n_rows; ++r) {
                const int64_t e = scan_one(r, hist.data());
                if (e) return e;
            }
            return 0;
        }
        std::atomic<int64_t> first_err{0};
        std::vector<std::thread> threads;
        const int64_t chunk = (n_rows + nt - 1) / nt;
        for (int t = 0; t < nt; ++t) {
            const int64_t lo = t * chunk;
            const int64_t hi = std::min<int64_t>(lo + chunk, n_rows);
            if (lo >= hi) break;
            threads.emplace_back([&, lo, hi]() {
                std::vector<H> hist(hist_len);
                for (int64_t r = lo; r < hi; ++r) {
                    if (first_err.load(std::memory_order_relaxed)) return;
                    const int64_t e = scan_one(r, hist.data());
                    if (e) {
                        int64_t cur_e = first_err.load();
                        while ((cur_e == 0 || e < cur_e)
                               && !first_err.compare_exchange_weak(cur_e,
                                                                   e)) {
                        }
                        return;
                    }
                }
            });
        }
        for (auto& th : threads) th.join();
        return first_err.load();
    };
    return state_wide ? scan_rows(int64_t{0}) : scan_rows(int32_t{0});
}

}  // extern "C"
