// Open canonical syncmer scanner — native host hot loop.
//
// Exact port of this package's scalar oracle semantics
// (taxor_jax/hash/syncmer.py, which mirrors the reference scanner
// src/hashing/syncmer.cpp:80-155): rolling 2-bit canonical k-mer/s-mer
// encode, stateful window minimum with leftmost-first / rightmost-on-pop
// tie-breaking, emission at offset t, N reset, wyhash64 of the canonical
// k-mer value.
//
// C ABI, driven from Python via ctypes.  One call scans one sequence; the
// Python layer parallelizes across sequences with threads (the call
// releases the GIL by virtue of being a plain C call).

#include <cstdint>
#include <cstddef>

namespace {

constexpr uint64_t WYCONST = 0x9E3779B97F4A7C15ULL;

static inline uint64_t wyhash64(uint64_t x) {
    __uint128_t p = (__uint128_t)x * WYCONST;
    return (uint64_t)p ^ (uint64_t)(p >> 64);
}

}  // namespace

extern "C" {

// codes: values 0..3 are bases, >=4 resets (N / padding).
// out: capacity >= n entries; returns number of emitted hashes
// (duplicates included; caller dedups).
long syncmer_scan(const uint8_t* codes, long n, int k, int s, int t,
                  uint64_t* out) {
    const uint64_t kmask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
    const uint64_t smask = (s < 32) ? ((1ULL << (2 * s)) - 1) : ~0ULL;
    const int kshift = (k - 1) * 2;
    const int sshift = (s - 1) * 2;
    const int w = k - s + 1;

    // ring buffer of the last w s-mer values
    uint64_t ring[64];  // w = k-s+1 <= 30 for k<=30; 64 is ample
    int ring_n = 0;     // s-mers currently in the window (<= w)
    long step = 0;      // s-mers pushed since last reset

    uint64_t xk0 = 0, xk1 = 0, xs0 = 0, xs1 = 0;
    long l = 0;
    uint64_t qmin_val = ~0ULL;
    long qmin_pos = -1;
    long out_n = 0;

    for (long i = 0; i < n; ++i) {
        const int c = codes[i];
        if (c < 4) {
            xk0 = ((xk0 << 2) | (uint64_t)c) & kmask;
            xk1 = (xk1 >> 2) | ((uint64_t)(3 - c) << kshift);
            xs0 = ((xs0 << 2) | (uint64_t)c) & smask;
            xs1 = (xs1 >> 2) | ((uint64_t)(3 - c) << sshift);
            if (++l < s) continue;

            const uint64_t ys = xs0 < xs1 ? xs0 : xs1;
            ring[step % w] = ys;
            ++step;
            if (step < w) continue;

            if (step == w) {
                // first full window: leftmost minimum (strict <)
                for (int j = 0; j < w; ++j) {
                    const uint64_t v = ring[(step - w + j) % w];
                    if (v < qmin_val) {
                        qmin_val = v;
                        qmin_pos = i - k + j + 1;
                    }
                }
            } else {
                if (qmin_pos == i - k) {
                    // popped the minimum: rightmost minimum rescan
                    qmin_val = ~0ULL;
                    qmin_pos = i - s + 1;
                    for (int j = w - 1; j >= 0; --j) {
                        const uint64_t v = ring[(step - w + j) % w];
                        if (v < qmin_val) {
                            qmin_val = v;
                            qmin_pos = i - k + j + 1;
                        }
                    }
                } else if (ys < qmin_val) {
                    qmin_val = ys;
                    qmin_pos = i - s + 1;
                }
            }
            if (qmin_pos == i - k + t) {
                const uint64_t yk = xk0 < xk1 ? xk0 : xk1;
                out[out_n++] = wyhash64(yk);
            }
        } else {
            qmin_val = ~0ULL;
            qmin_pos = -1;
            l = 0;
            xk0 = xk1 = xs0 = xs1 = 0;
            ring_n = 0;
            step = 0;
        }
    }
    (void)ring_n;
    return out_n;
}

// Batched variant over a padded [rows, stride] code matrix; emissions per
// row written into out[row*stride ...]; counts into out_counts[row].
void syncmer_scan_batch(const uint8_t* codes, const long* lengths,
                        long rows, long stride, int k, int s, int t,
                        uint64_t* out, long* out_counts) {
    for (long r = 0; r < rows; ++r) {
        out_counts[r] = syncmer_scan(codes + r * stride, lengths[r], k, s,
                                     t, out + r * stride);
    }
}

// dna4 2-bit packer: A/a->0 C/c->1 G/g->2 T/t/U/u->3, everything else
// (incl. N) -> 0, four bases per output byte (base i at bits 2*(i%4)).
// Matches hash/encode.encode_dna4 + hash/device_syncmer.pack_reads.
static const uint8_t* dna4_table() {
    static uint8_t tbl[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; ++i) tbl[i] = 0;
        tbl['A'] = tbl['a'] = 0;
        tbl['C'] = tbl['c'] = 1;
        tbl['G'] = tbl['g'] = 2;
        tbl['T'] = tbl['t'] = 3;
        tbl['U'] = tbl['u'] = 3;
        init = true;
    }
    return tbl;
}

// seqs: array of nreads pointers to raw read bytes; lens: read lengths;
// out: zero-initialized [nreads, L/4] row-major buffer.
void pack_reads_2bit(const uint8_t** seqs, const long* lens, long nreads,
                     long L, uint8_t* out) {
    const uint8_t* T = dna4_table();
    const long W = L / 4;
    for (long r = 0; r < nreads; ++r) {
        const uint8_t* s = seqs[r];
        const long n = lens[r] < L ? lens[r] : L;
        uint8_t* o = out + r * W;
        long i = 0;
        for (; i + 4 <= n; i += 4) {
            o[i >> 2] = (uint8_t)(T[s[i]] | (T[s[i + 1]] << 2) |
                                  (T[s[i + 2]] << 4) | (T[s[i + 3]] << 6));
        }
        if (i < n) {
            uint8_t b = 0;
            for (int j = 0; i + j < n; ++j) b |= T[s[i + j]] << (2 * j);
            o[i >> 2] = b;
        }
    }
}

}  // extern "C"
