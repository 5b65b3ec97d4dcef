// sda-tpu native host kernels.
//
// The reference's native-performance surface is libsodium (C) and the
// threshold-secret-sharing Rust crate; the port carries its own sealed boxes
// (sda_tpu_torch/crypto/csrc/sodium.c, linked into this library) and re-owns
// the field math here: an exact C++ oracle for the modular
// matmul kernels (independent of numpy/XLA, used for bit-exactness audits)
// plus fast ChaCha20 mask PRGs implementing both CHACHA_PRG_V1 and the
// rand-0.3-compatible CHACHA_PRG_RAND03 (sda_tpu_torch/fields/chacha.py) for the
// recipient's seed re-expansion hot loop (reference:
// client/src/receive.rs:102-118, masking/chacha.rs:57-77).
//
// Build: g++ -O2 -shared -fPIC with crypto/csrc/sodium.c
// (fields/_build.build_host). ABI: plain C, int64/uint32 buffers owned by
// the caller.

#include <cstdint>
#include <cstring>

#include <vector>

extern "C" {

// (a[m,k] @ b[k,n]) mod p with exact 128-bit accumulation.
// Entries must be canonical residues in [0, p); p < 2^62.
// Returns 0 on success, nonzero on bad arguments.
int sda_modmatmul_i64(const int64_t* a, const int64_t* b, int64_t* out,
                      int64_t m, int64_t k, int64_t n, int64_t p) {
    if (p <= 0 || m < 0 || k < 0 || n < 0) return 1;
    for (int64_t i = 0; i < m; ++i) {
        for (int64_t j = 0; j < n; ++j) {
            unsigned __int128 acc = 0;
            for (int64_t t = 0; t < k; ++t) {
                acc += (unsigned __int128)(uint64_t)a[i * k + t] *
                       (uint64_t)b[t * n + j];
                // lazy reduction: fold down before the 128-bit accumulator
                // can overflow (p^2 < 2^124, so at most 8 products fit)
                if ((t & 7) == 7) acc %= (uint64_t)p;
            }
            out[i * n + j] = (int64_t)(acc % (uint64_t)p);
        }
    }
    return 0;
}

// Elementwise sum mod m over the leading axis: x[rows, n] -> out[n].
int sda_modsum_axis0(const int64_t* x, int64_t* out, int64_t rows, int64_t n,
                     int64_t m) {
    if (m <= 0 || rows < 0 || n < 0) return 1;
    for (int64_t j = 0; j < n; ++j) out[j] = 0;
    for (int64_t i = 0; i < rows; ++i) {
        const int64_t* row = x + i * n;
        for (int64_t j = 0; j < n; ++j) {
            int64_t v = out[j] + row[j] % m;
            out[j] = v >= m ? v - m : v;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// ChaCha20 (CHACHA_PRG_V1): RFC-7539 constants, key = seed words 0..7
// (zero-padded), block counter in word 12, words 13..15 zero, 20 rounds.

static inline uint32_t rotl32(uint32_t x, int n) {
    return (x << n) | (x >> (32 - n));
}

#define SDA_QR(a, b, c, d)                                                   \
    a += b; d ^= a; d = rotl32(d, 16);                                       \
    c += d; b ^= c; b = rotl32(b, 12);                                       \
    a += b; d ^= a; d = rotl32(d, 8);                                        \
    c += d; b ^= c; b = rotl32(b, 7);

static void chacha_block(const uint32_t key[8], uint32_t counter,
                         uint32_t out[16]) {
    uint32_t s[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                      key[0], key[1], key[2], key[3],
                      key[4], key[5], key[6], key[7],
                      counter, 0u, 0u, 0u};
    uint32_t x[16];
    std::memcpy(x, s, sizeof(x));
    for (int i = 0; i < 10; ++i) {
        SDA_QR(x[0], x[4], x[8], x[12]);
        SDA_QR(x[1], x[5], x[9], x[13]);
        SDA_QR(x[2], x[6], x[10], x[14]);
        SDA_QR(x[3], x[7], x[11], x[15]);
        SDA_QR(x[0], x[5], x[10], x[15]);
        SDA_QR(x[1], x[6], x[11], x[12]);
        SDA_QR(x[2], x[7], x[8], x[13]);
        SDA_QR(x[3], x[4], x[9], x[14]);
    }
    for (int i = 0; i < 16; ++i) out[i] = x[i] + s[i];
}

// Expand a seed into `dim` uniform draws in [0, modulus) by rejection
// sampling over u64 lanes (two keystream words each, low word first) —
// bit-identical to sda_tpu_torch.fields.chacha.expand_mask.
int sda_chacha_expand_mask(const uint32_t* seed, int64_t seed_words,
                           int64_t dim, int64_t modulus, int64_t* out) {
    if (modulus <= 0 || dim < 0 || seed_words < 0 || seed_words > 8) return 1;
    uint32_t key[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int64_t i = 0; i < seed_words; ++i) key[i] = seed[i];
    const uint64_t m = (uint64_t)modulus;
    // accept v <= zone where zone+1 is the largest multiple of m <= 2^64
    const uint64_t zone =
        (uint64_t)(((((unsigned __int128)1) << 64) / m) * m - 1);
    uint32_t counter = 0;
    int64_t filled = 0;
    uint32_t words[16];
    while (filled < dim) {
        chacha_block(key, counter++, words);
        for (int lane = 0; lane < 8 && filled < dim; ++lane) {
            uint64_t lo = words[2 * lane];
            uint64_t hi = words[2 * lane + 1];
            uint64_t v = (hi << 32) | lo;
            if (v <= zone) out[filled++] = (int64_t)(v % m);
        }
    }
    return 0;
}

// The exact rand-0.3 ChaChaRng stream (CHACHA_PRG_RAND03) — what the
// reference's masker actually draws (client/src/crypto/masking/
// chacha.rs:37-41 via rand 0.3's chacha.rs + distributions/range.rs).
// Same block function; u64 draws take the FIRST keystream word as the
// HIGH half (rand 0.3's default next_u64) and the acceptance zone is
// UINT64_MAX - UINT64_MAX % m, exclusive. Bit-identical to
// sda_tpu_torch.fields.chacha.expand_mask_rand03.
int sda_chacha_expand_mask_r03(const uint32_t* seed, int64_t seed_words,
                               int64_t dim, int64_t modulus, int64_t* out) {
    if (modulus <= 0 || dim < 0 || seed_words < 0 || seed_words > 8) return 1;
    uint32_t key[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int64_t i = 0; i < seed_words; ++i) key[i] = seed[i];
    const uint64_t m = (uint64_t)modulus;
    const uint64_t zone_excl = UINT64_MAX - UINT64_MAX % m;  // accept v < zone
    uint32_t counter = 0;
    int64_t filled = 0;
    uint32_t words[16];
    while (filled < dim) {
        chacha_block(key, counter++, words);
        for (int lane = 0; lane < 8 && filled < dim; ++lane) {
            uint64_t hi = words[2 * lane];
            uint64_t lo = words[2 * lane + 1];
            uint64_t v = (hi << 32) | lo;
            if (v < zone_excl) out[filled++] = (int64_t)(v % m);
        }
    }
    return 0;
}

// Sum of many expanded masks mod m — the recipient hot loop in one call:
// seeds[n_seeds, seed_words] (as i64 per wire convention) -> out[dim].
// `expand` selects the PRG (shared body for the V1 and rand-0.3 entry
// points below).
typedef int (*sda_expand_fn)(const uint32_t*, int64_t, int64_t, int64_t,
                             int64_t*);

static int combine_masks_with(sda_expand_fn expand, const int64_t* seeds,
                              int64_t n_seeds, int64_t seed_words,
                              int64_t dim, int64_t modulus, int64_t* scratch,
                              int64_t* out) {
    if (modulus <= 0) return 1;
    for (int64_t j = 0; j < dim; ++j) out[j] = 0;
    uint32_t seed32[8];
    for (int64_t s = 0; s < n_seeds; ++s) {
        if (seed_words > 8) return 1;
        for (int64_t w = 0; w < seed_words; ++w)
            seed32[w] = (uint32_t)(uint64_t)seeds[s * seed_words + w];
        int rc = expand(seed32, seed_words, dim, modulus, scratch);
        if (rc) return rc;
        for (int64_t j = 0; j < dim; ++j) {
            int64_t v = out[j] + scratch[j];
            out[j] = v >= modulus ? v - modulus : v;
        }
    }
    return 0;
}

int sda_chacha_combine_masks(const int64_t* seeds, int64_t n_seeds,
                             int64_t seed_words, int64_t dim, int64_t modulus,
                             int64_t* scratch, int64_t* out) {
    return combine_masks_with(sda_chacha_expand_mask, seeds, n_seeds,
                              seed_words, dim, modulus, scratch, out);
}

int sda_chacha_combine_masks_r03(const int64_t* seeds, int64_t n_seeds,
                                 int64_t seed_words, int64_t dim,
                                 int64_t modulus, int64_t* scratch,
                                 int64_t* out) {
    return combine_masks_with(sda_chacha_expand_mask_r03, seeds, n_seeds,
                              seed_words, dim, modulus, scratch, out);
}

// ---------------------------------------------------------------------------
// Big-integer Montgomery modular exponentiation — the Paillier hot op.
//
// CPython's pow() on 2048-bit operands runs 30-bit digit arithmetic; this
// CIOS Montgomery ladder on 64-bit limbs (4-bit window, dedicated
// squaring) measures ~3.5-5x faster — 347ms -> ~75ms per Paillier
// encryption at 2048-bit keys (see docs/crypto.md envelope). Limb arrays
// are little-endian uint64, caller-owned; the modulus must be odd (n and
// n^2 always are) with a nonzero top limb.

namespace {

// -n^-1 mod 2^64 via Newton iteration (n odd).
static uint64_t mont_n0inv(uint64_t n0) {
    uint64_t x = 1;
    for (int i = 0; i < 6; ++i) x *= 2 - n0 * x;  // doubles correct bits
    return ~x + 1;  // negate mod 2^64
}

// out = a*b*R^-1 mod n (CIOS), R = 2^(64*nl). a, b < n. scratch t[nl+2].
static void mont_mul(const uint64_t* a, const uint64_t* b, const uint64_t* n,
                     uint64_t n0inv, int64_t nl, uint64_t* t, uint64_t* out) {
    for (int64_t i = 0; i < nl + 2; ++i) t[i] = 0;
    for (int64_t i = 0; i < nl; ++i) {
        // t += a[i] * b
        unsigned __int128 carry = 0;
        for (int64_t j = 0; j < nl; ++j) {
            carry += (unsigned __int128)a[i] * b[j] + t[j];
            t[j] = (uint64_t)carry;
            carry >>= 64;
        }
        carry += t[nl];
        t[nl] = (uint64_t)carry;
        t[nl + 1] = (uint64_t)(carry >> 64);
        // t += m * n, where m = t[0] * n0inv mod 2^64; then t >>= 64
        uint64_t m = t[0] * n0inv;
        carry = (unsigned __int128)m * n[0] + t[0];
        carry >>= 64;
        for (int64_t j = 1; j < nl; ++j) {
            carry += (unsigned __int128)m * n[j] + t[j];
            t[j - 1] = (uint64_t)carry;
            carry >>= 64;
        }
        carry += t[nl];
        t[nl - 1] = (uint64_t)carry;
        t[nl] = t[nl + 1] + (uint64_t)(carry >> 64);
    }
    // conditional subtract: t may be in [0, 2n)
    uint64_t borrow = 0;
    for (int64_t j = 0; j < nl; ++j) {
        unsigned __int128 d =
            (unsigned __int128)t[j] - n[j] - borrow;
        out[j] = (uint64_t)d;
        borrow = (uint64_t)(d >> 64) ? 1 : 0;
    }
    if (t[nl] == 0 && borrow) {  // t < n: keep t
        for (int64_t j = 0; j < nl; ++j) out[j] = t[j];
    }
}

// Montgomery squaring: the ladder is ~5 squares per multiply, and a
// schoolbook square needs only the upper-triangle products doubled —
// ~35% fewer 128-bit multiplies than mont_mul. Computes the full 2nl-limb
// square into s, then a separate REDC pass. scratch s[2*nl+1].
static void mont_sqr(const uint64_t* a, const uint64_t* n, uint64_t n0inv,
                     int64_t nl, uint64_t* s, uint64_t* out) {
    for (int64_t i = 0; i < 2 * nl + 1; ++i) s[i] = 0;
    // off-diagonal products once
    for (int64_t i = 0; i < nl; ++i) {
        unsigned __int128 carry = 0;
        for (int64_t j = i + 1; j < nl; ++j) {
            carry += (unsigned __int128)a[i] * a[j] + s[i + j];
            s[i + j] = (uint64_t)carry;
            carry >>= 64;
        }
        s[i + nl] += (uint64_t)carry;  // no overflow: slot untouched so far
    }
    // double, then add the diagonal
    uint64_t carry1 = 0;
    for (int64_t i = 0; i < 2 * nl; ++i) {
        uint64_t v = s[i];
        s[i] = (v << 1) | carry1;
        carry1 = v >> 63;
    }
    unsigned __int128 carry = 0;
    for (int64_t i = 0; i < nl; ++i) {
        carry += (unsigned __int128)a[i] * a[i] + s[2 * i];
        s[2 * i] = (uint64_t)carry;
        carry = (carry >> 64) + s[2 * i + 1];
        s[2 * i + 1] = (uint64_t)carry;
        carry >>= 64;
    }
    // REDC: nl rounds of m = s[i]*n0inv; s += m*n << (64*i)
    for (int64_t i = 0; i < nl; ++i) {
        uint64_t m = s[i] * n0inv;
        unsigned __int128 c2 = (unsigned __int128)m * n[0] + s[i];
        c2 >>= 64;
        for (int64_t j = 1; j < nl; ++j) {
            c2 += (unsigned __int128)m * n[j] + s[i + j];
            s[i + j] = (uint64_t)c2;
            c2 >>= 64;
        }
        // propagate the carry into the high limbs
        for (int64_t j = i + nl; c2 && j <= 2 * nl; ++j) {
            c2 += s[j];
            s[j] = (uint64_t)c2;
            c2 >>= 64;
        }
    }
    // result = s[nl .. 2nl] (may be >= n once)
    uint64_t borrow = 0;
    for (int64_t j = 0; j < nl; ++j) {
        unsigned __int128 d =
            (unsigned __int128)s[nl + j] - n[j] - borrow;
        out[j] = (uint64_t)d;
        borrow = (uint64_t)(d >> 64) ? 1 : 0;
    }
    if (s[2 * nl] == 0 && borrow) {
        for (int64_t j = 0; j < nl; ++j) out[j] = s[nl + j];
    }
}

// R^2 mod n by 2*64*nl doublings of 1 (cheap next to the ladder).
static void mont_rr(const uint64_t* n, int64_t nl, uint64_t* rr) {
    for (int64_t i = 0; i < nl; ++i) rr[i] = 0;
    rr[0] = 1;
    // rr < n invariant; double with conditional subtract
    for (int64_t bit = 0; bit < 2 * 64 * nl; ++bit) {
        uint64_t carry = 0;
        for (int64_t j = 0; j < nl; ++j) {
            uint64_t v = rr[j];
            rr[j] = (v << 1) | carry;
            carry = v >> 63;
        }
        // subtract n if rr >= n (or the shift overflowed)
        bool ge = carry != 0;
        if (!ge) {
            ge = true;
            for (int64_t j = nl - 1; j >= 0; --j) {
                if (rr[j] != n[j]) { ge = rr[j] > n[j]; break; }
            }
        }
        if (ge) {
            uint64_t borrow = 0;
            for (int64_t j = 0; j < nl; ++j) {
                unsigned __int128 d =
                    (unsigned __int128)rr[j] - n[j] - borrow;
                rr[j] = (uint64_t)d;
                borrow = (uint64_t)(d >> 64) ? 1 : 0;
            }
        }
    }
}

}  // namespace

// out = base^exp mod n. Little-endian uint64 limbs; base/out have nl limbs
// (base < n), exp has el limbs, n odd with n[nl-1] != 0. Fixed 4-bit
// window. scratch must hold 22 * nl + 3 limbs; pass null to have the
// function refuse (keeps the ABI allocation-free).
//
// NOT constant-time: the ladder skips leading zero windows, multiplies
// only on nonzero windows, and the Montgomery reductions take
// data-dependent conditional subtracts — execution time leaks the
// exponent's zero-window pattern and effective bit length. CPython's
// pow (the fallback path) is variable-time too. Acceptable for this
// repo's threat model (Paillier decrypt runs on the clerk's own
// machine; the wire carries ciphertexts, not timings), but a deployment
// where an adversary can time individual decryptions at high resolution
// should use a constant-time bignum library instead. See docs/crypto.md.
int sda_powmod(const uint64_t* base, const uint64_t* exp, int64_t el,
               const uint64_t* n, int64_t nl, uint64_t* scratch,
               uint64_t* out) {
    if (!base || !exp || !n || !out || !scratch) return 1;
    if (nl <= 0 || el < 0 || (n[0] & 1) == 0 || n[nl - 1] == 0) return 1;
    uint64_t n0inv = mont_n0inv(n[0]);
    uint64_t* table = scratch;             // 16 * nl: window powers (mont)
    uint64_t* rr = table + 16 * nl;        // nl
    uint64_t* acc = rr + nl;               // nl
    uint64_t* tmp = acc + nl;              // nl
    uint64_t* t = tmp + nl;                // nl + 2 (CIOS scratch)
    uint64_t* sq = t + nl + 2;             // 2 * nl + 1 (squaring scratch)
    mont_rr(n, nl, rr);
    // table[1] = base in Montgomery form; table[0] = 1 in Montgomery form
    mont_mul(base, rr, n, n0inv, nl, t, table + nl);
    uint64_t* one = tmp;
    for (int64_t j = 0; j < nl; ++j) one[j] = (j == 0);
    mont_mul(one, rr, n, n0inv, nl, t, table);  // mont(1) = R mod n
    for (int w = 2; w < 16; ++w)
        mont_mul(table + (w - 1) * nl, table + nl, n, n0inv, nl, t,
                 table + w * nl);
    // top-down 4-bit ladder
    for (int64_t j = 0; j < nl; ++j) acc[j] = table[j];  // mont(1)
    int64_t top = el - 1;
    while (top >= 0 && exp[top] == 0) --top;
    bool started = false;
    for (int64_t i = top; i >= 0; --i) {
        for (int shift = 60; shift >= 0; shift -= 4) {
            int w = (int)((exp[i] >> shift) & 0xF);
            if (started) {
                mont_sqr(acc, n, n0inv, nl, sq, acc);
                mont_sqr(acc, n, n0inv, nl, sq, acc);
                mont_sqr(acc, n, n0inv, nl, sq, acc);
                mont_sqr(acc, n, n0inv, nl, sq, acc);
            }
            if (w != 0) {
                mont_mul(acc, table + w * nl, n, n0inv, nl, t, acc);
                started = true;
            } else if (!started) {
                continue;  // skip leading zeros entirely
            }
        }
    }
    // leave Montgomery form: acc * 1
    mont_mul(acc, one, n, n0inv, nl, t, out);
    return 0;
}

// Batch variant: `count` bases against one (exp, n) — the Paillier premix
// and clerk-batch shapes. bases/outs are [count, nl].
int sda_powmod_batch(const uint64_t* bases, int64_t count, const uint64_t* exp,
                     int64_t el, const uint64_t* n, int64_t nl,
                     uint64_t* scratch, uint64_t* outs) {
    for (int64_t i = 0; i < count; ++i) {
        int rc = sda_powmod(bases + i * nl, exp, el, n, nl, scratch,
                            outs + i * nl);
        if (rc) return rc;
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Embeddable participant core.
//
// The reference declares (and never released) an /embeddable-client that
// "wraps client and client-http to expose the client functionality in a
// C-friendly" API for mobile/embedded apps (reference README.md:196-204).
// This is the TPU build's analog of its compute half: the COMPLETE
// participant crypto — canonicalize -> mask (none/full/chacha) ->
// additive-share -> zigzag-varint -> sealed boxes — behind one
// C call, wire-compatible with the Python clerks/recipient (same varint
// and sealedbox formats, crypto/varint.py + crypto/sodium.py). Transport
// stays with the embedding host, exactly the split the reference intended
// (its embeddable client wrapped client-http separately).
//
// The sealed boxes and the random draws come from the port's host crypto
// (crypto/csrc/sodium.c), compiled into this library.

extern "C" {
int sda_randombytes(void* buf, uint64_t n);
int sda_box_seal(uint8_t* c, const uint8_t* m, uint64_t mlen,
                 const uint8_t* pk);
}

namespace {

const int64_t kSealBytes = 48;  // crypto_box_SEALBYTES (x25519 pk + MAC)

// exact uniform draws in [0, m): rejection over u64 (no modulo bias),
// bulk-filled — one getrandom-backed fill per vector, per-lane redraw only
// on rejection (probability < 2^-32 for the moduli in play). Returns 0, or
// 5 when the system's random source fails.
static int uniform_fill(uint64_t m, int64_t* dst, int64_t n) {
    const uint64_t zone =
        (uint64_t)(((((unsigned __int128)1) << 64) / m) * m - 1);
    std::vector<uint64_t> buf((size_t)n);
    if (sda_randombytes(buf.data(), (uint64_t)n * sizeof(uint64_t))) return 5;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t v = buf[(size_t)i];
        while (v > zone)
            if (sda_randombytes(&v, sizeof v)) return 5;
        dst[i] = (int64_t)(v % m);
    }
    return 0;
}

// zigzag + LEB128, matching sda_tpu_torch.crypto.varint (the reference's
// integer-encoding VarInt inside sealed boxes, encryption/sodium.rs:36-45)
static void varint_append(std::vector<uint8_t>& out, int64_t x) {
    uint64_t u = ((uint64_t)x << 1) ^ (uint64_t)(x >> 63);
    do {
        uint8_t b = u & 0x7F;
        u >>= 7;
        if (u) b |= 0x80;
        out.push_back(b);
    } while (u);
}

// (row . vals) mod m with u128 accumulation; entries canonical < m < 2^62.
// The fold cadence keeps partials exact: 8 products of (2^62-1)^2 plus a
// carried residue stay under 2^127 — the ONE place this invariant lives.
static uint64_t moddot_row(const int64_t* row, const uint64_t* vals,
                           int32_t n, uint64_t m) {
    unsigned __int128 acc = 0;
    int cnt = 0;
    for (int32_t j = 0; j < n; ++j) {
        acc += (unsigned __int128)(uint64_t)row[j] * vals[j];
        if (++cnt == 8) {
            acc %= m;
            cnt = 0;
        }
    }
    return (uint64_t)(acc % m);
}

static int seal_blob(const std::vector<uint8_t>& msg,
                     const uint8_t* pk, uint8_t* out, int64_t cap,
                     int64_t* written) {
    int64_t need = (int64_t)msg.size() + kSealBytes;
    if (need > cap) return 2;
    if (sda_box_seal(out, msg.data(), (uint64_t)msg.size(), pk) != 0)
        return 4;
    *written = need;
    return 0;
}

// Canonicalize the secrets into `masked`, apply the masking scheme, and
// seal the recipient payload (mask vector / chacha seed) at `out`.
// Shared by the additive and Shamir entry points; *rec_written = 0 for
// masking none. Returns the usual embed rc.
static int mask_phase(const int64_t* secret, int64_t dim,
                      int64_t modulus, int32_t masking_kind,
                      int32_t seed_bits, const uint8_t* recipient_pk,
                      uint8_t* out, int64_t out_cap,
                      std::vector<int64_t>& masked, int64_t* rec_written) {
    const uint64_t m = (uint64_t)modulus;
    masked.resize((size_t)dim);
    for (int64_t i = 0; i < dim; ++i) {
        int64_t c = secret[i] % modulus;
        if (c < 0) c += modulus;
        masked[(size_t)i] = c;
    }
    *rec_written = 0;
    if (masking_kind == 0) return 0;
    std::vector<uint8_t> payload;
    if (masking_kind == 1) {
        payload.reserve((size_t)dim * 5);
        std::vector<int64_t> mask((size_t)dim);
        if (uniform_fill(m, mask.data(), dim)) return 5;
        for (int64_t i = 0; i < dim; ++i) {
            uint64_t v = (uint64_t)masked[(size_t)i]
                       + (uint64_t)mask[(size_t)i];
            if (v >= m) v -= m;
            masked[(size_t)i] = (int64_t)v;
            varint_append(payload, mask[(size_t)i]);
        }
    } else {
        // ceil to whole 32-bit words, matching chacha.random_seed: any
        // seed_bitsize the Python client accepts must work embedded too
        if (seed_bits <= 0 || seed_bits > 256) return 3;
        int words = (seed_bits + 31) / 32;
        uint32_t seed[8] = {0};
        if (sda_randombytes(seed, (uint64_t)words * 4)) return 5;
        std::vector<int64_t> mask((size_t)dim);
        // kind 2 = CHACHA_PRG_V1, kind 3 = CHACHA_PRG_RAND03 (the stream a
        // bare Rust-shaped scheme implies; rand-0.3 interop)
        int rc_expand = masking_kind == 3
            ? sda_chacha_expand_mask_r03(seed, words, dim, modulus, mask.data())
            : sda_chacha_expand_mask(seed, words, dim, modulus, mask.data());
        if (rc_expand)
            return 3;
        for (int64_t i = 0; i < dim; ++i) {
            uint64_t v = (uint64_t)masked[(size_t)i]
                       + (uint64_t)mask[(size_t)i];
            if (v >= m) v -= m;
            masked[(size_t)i] = (int64_t)v;
        }
        // the uploaded "mask" is the seed itself (masking/chacha.rs
        // semantics): the recipient re-expands it
        for (int w = 0; w < words; ++w)
            varint_append(payload, (int64_t)seed[w]);
    }
    return seal_blob(payload, recipient_pk, out, out_cap, rec_written);
}

}  // namespace

extern "C" {

// Full participant compute for one aggregation input.
//
//   secret[dim]    any int64 values; canonicalized mod `modulus`
//   masking_kind   0 = none, 1 = full, 2 = chacha CHACHA_PRG_V1,
//                  3 = chacha CHACHA_PRG_RAND03 (seed_bits in 32..256,
//                  multiple of 32)
//   recipient_pk   32-byte Curve25519 pk (ignored for masking none)
//   clerk_pks      share_count x 32 bytes, committee order
//   out/out_cap    packed output: [recipient blob][clerk 0 blob]...[n-1]
//   out_lens       int64[1 + share_count]: recipient blob length (0 when
//                  masking none), then each clerk blob length
//
// Sharing here is additive; Shamir committees use the sibling
// sda_embed_participate_shamir below (host-computed share matrix).
// Returns 0 ok, 2 out_cap too small, 3 bad arguments, 4 sealing failure,
// 5 the system's random source failed.
int sda_embed_participate(
    const int64_t* secret, int64_t dim, int64_t modulus,
    int32_t share_count, int32_t masking_kind, int32_t seed_bits,
    const uint8_t* recipient_pk, const uint8_t* clerk_pks,
    uint8_t* out, int64_t out_cap, int64_t* out_lens) {
    if (dim < 0 || modulus <= 0 || share_count < 1) return 3;
    if (masking_kind < 0 || masking_kind > 3) return 3;
    const uint64_t m = (uint64_t)modulus;
    std::vector<int64_t> masked;
    std::vector<uint8_t> payload;
    int64_t pos = 0, written = 0;
    int rc0 = mask_phase(secret, dim, modulus, masking_kind, seed_bits,
                         recipient_pk, out, out_cap, masked, &written);
    if (rc0) return rc0;
    out_lens[0] = written;
    pos += written;
    // additive shares: clerks 0..n-2 draw uniformly; the last share makes
    // the column sums telescope to the masked secret (additive.rs:32-52)
    std::vector<int64_t> acc((size_t)dim, 0);
    std::vector<int64_t> share((size_t)dim);
    for (int32_t c = 0; c < share_count; ++c) {
        payload.clear();
        if (c + 1 < share_count) {
            if (uniform_fill(m, share.data(), dim)) return 5;
            for (int64_t i = 0; i < dim; ++i) {
                uint64_t a = (uint64_t)acc[(size_t)i]
                           + (uint64_t)share[(size_t)i];
                if (a >= m) a -= m;
                acc[(size_t)i] = (int64_t)a;
            }
        } else {
            for (int64_t i = 0; i < dim; ++i) {
                int64_t v = masked[(size_t)i] - acc[(size_t)i];
                if (v < 0) v += modulus;
                share[(size_t)i] = v;
            }
        }
        for (int64_t i = 0; i < dim; ++i)
            varint_append(payload, share[(size_t)i]);
        int rc = seal_blob(payload, clerk_pks + (size_t)c * 32,
                           out + pos, out_cap - pos, &written);
        if (rc) return rc;
        out_lens[1 + c] = written;
        pos += written;
    }
    return 0;
}

// Packed-Shamir variant: the share MATRIX is computed host-side (the
// NTT/Vandermonde number theory stays in fields/numtheory.py) and passed
// in as canonical residues; the core batches the masked vector into
// ceil(dim/k) columns of k secrets (batched.rs:18-53 semantics: values
// vector per batch = [0, secrets_k, randomness_t]), evaluates shares as
// [n, m2] @ [m2] modmuls with 128-bit accumulation, and streams clerk i's
// per-batch share into its sealed payload. modulus < 2^62.
//
//   share_modulus the sharing prime p: shares/partial sums live mod p
//   mask_modulus  the masking ring (<= p): the CLI/protocol policy draws
//                 masks mod the AGGREGATION modulus while Shamir shares
//                 ride a larger NTT prime with participant-sum headroom
//                 (masked values < mask_modulus <= p are shared verbatim;
//                 pass mask_modulus == share_modulus when they coincide)
//   m_host        n_shares x m2 canonical residues, row-major
//   m2            1 + secret_count + privacy_threshold
//   out_lens      int64[1 + n_shares], as in sda_embed_participate
int sda_embed_participate_shamir(
    const int64_t* secret, int64_t dim, int64_t share_modulus,
    int64_t mask_modulus,
    const int64_t* m_host, int32_t n_shares, int32_t m2, int32_t k,
    int32_t masking_kind, int32_t seed_bits,
    const uint8_t* recipient_pk, const uint8_t* clerk_pks,
    uint8_t* out, int64_t out_cap, int64_t* out_lens) {
    if (dim < 0 || share_modulus <= 0 || n_shares < 1) return 3;
    if (mask_modulus <= 0 || mask_modulus > share_modulus) return 3;
    if (k < 1 || m2 < k + 1) return 3;
    if (share_modulus >= (int64_t)1 << 62) return 3;  // u128 accum bound
    if (masking_kind < 0 || masking_kind > 3) return 3;
    const uint64_t m = (uint64_t)share_modulus;
    std::vector<int64_t> masked;
    int64_t pos = 0, written = 0;
    int rc0 = mask_phase(secret, dim, mask_modulus, masking_kind,
                         seed_bits, recipient_pk, out, out_cap, masked,
                         &written);
    if (rc0) return rc0;
    out_lens[0] = written;
    pos += written;
    const int32_t t = m2 - 1 - k;
    const int64_t B = (dim + k - 1) / k;
    std::vector<std::vector<uint8_t>> clerk_payloads((size_t)n_shares);
    for (auto& p : clerk_payloads) p.reserve((size_t)B * 5);
    std::vector<int64_t> rands((size_t)(B * t));
    if (t > 0 && uniform_fill(m, rands.data(), B * t)) return 5;
    std::vector<uint64_t> vals((size_t)m2);
    for (int64_t b = 0; b < B; ++b) {
        vals[0] = 0;  // the share matrix's fixed zero column
        for (int32_t j = 0; j < k; ++j) {
            int64_t idx = b * k + j;  // zero-padded final batch
            vals[(size_t)(1 + j)] =
                idx < dim ? (uint64_t)masked[(size_t)idx] : 0;
        }
        for (int32_t j = 0; j < t; ++j)
            vals[(size_t)(1 + k + j)] = (uint64_t)rands[(size_t)(b * t + j)];
        for (int32_t i = 0; i < n_shares; ++i) {
            varint_append(
                clerk_payloads[(size_t)i],
                (int64_t)moddot_row(m_host + (size_t)i * m2, vals.data(),
                                    m2, m));
        }
    }
    for (int32_t i = 0; i < n_shares; ++i) {
        int rc = seal_blob(clerk_payloads[(size_t)i],
                           clerk_pks + (size_t)i * 32,
                           out + pos, out_cap - pos, &written);
        if (rc) return rc;
        out_lens[1 + i] = written;
        pos += written;
    }
    return 0;
}

int sda_native_abi_version() { return 6; }

}  // extern "C"
