/* The port's host crypto: the six libsodium calls the protocol makes,
 * byte-compatible with libsodium 1.0.18, built from this file alone.
 *
 *   crypto_box_keypair / crypto_box_seal / crypto_box_seal_open
 *     X25519 (RFC 7748) + HSalsa20/XSalsa20 + Poly1305; the seal nonce is
 *     BLAKE2b-192(epk || pk) and a sealed box is epk || MAC(16) || c.
 *   crypto_sign_keypair / crypto_sign_detached / crypto_sign_verify_detached
 *     Ed25519 (RFC 8032, deterministic nonce), secret key seed || pk, and
 *     libsodium's verify rules: S < L, R and A not of small order, A
 *     canonical, cofactorless equation [S]B - [h]A == R.
 *   randombytes_buf
 *     getrandom(2), looping on EINTR and short reads.
 *
 * Field elements mod 2^255-19 are five 51-bit limbs multiplied through
 * unsigned __int128; Salsa20 runs on 32-bit words and Poly1305 on 44-bit
 * limbs, so a 1.5 MB share bundle seals at memory-bound-ish host speed.
 * Secret-dependent branches are avoided in the X25519 ladder (cswap), the
 * Ed25519 fixed-base multiply (cmov) and the MAC compare; verify is
 * variable-time over public data, as libsodium's is.
 *
 * Plain C ABI, every export prefixed sda_; 0 is success, -1 failure.
 * Build: cc -O2 -fPIC -shared (sda_tpu_torch/fields/_build.py host route).
 * No -march=native: the library must load on any x86-64 host.
 */

#include <errno.h>
#include <stdint.h>
#include <string.h>
#include <sys/random.h>

typedef unsigned __int128 u128;

static uint64_t load64_le(const uint8_t *p) {
    uint64_t v;
    memcpy(&v, p, 8); /* x86-64 and aarch64 hosts are little-endian */
    return v;
}

static void store64_le(uint8_t *p, uint64_t v) { memcpy(p, &v, 8); }

static uint32_t load32_le(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

static void store32_le(uint8_t *p, uint32_t v) { memcpy(p, &v, 4); }

static uint64_t load64_be(const uint8_t *p) {
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v = (v << 8) | p[i];
    return v;
}

static void store64_be(uint8_t *p, uint64_t v) {
    for (int i = 7; i >= 0; --i) {
        p[i] = (uint8_t)v;
        v >>= 8;
    }
}

static void wipe(void *p, size_t n) {
    volatile uint8_t *v = (volatile uint8_t *)p;
    while (n--) *v++ = 0;
}

/* ------------------------------------------------------------------ */
/* randomness                                                          */

int sda_randombytes(void *buf, uint64_t n) {
    uint8_t *p = (uint8_t *)buf;
    while (n > 0) {
        size_t want = n > (1u << 20) ? (1u << 20) : (size_t)n;
        ssize_t got = getrandom(p, want, 0);
        if (got < 0) {
            if (errno == EINTR) continue;
            return -1;
        }
        p += got;
        n -= (uint64_t)got;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* SHA-512 (FIPS 180-4)                                                */

static const uint64_t SHA512_K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL, 0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL, 0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL, 0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL, 0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL, 0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL, 0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL, 0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
    0xca273eceea26619cULL, 0xd186b8c721c0c207ULL, 0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, 0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

/* SHA-512's initial hash value; BLAKE2b uses the same eight words as IV */
static const uint64_t SHA512_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL, 0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

typedef struct {
    uint64_t h[8];
    uint8_t buf[128];
    size_t fill;
    uint64_t total;
} sha512_ctx;

static uint64_t ror64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

static void sha512_block(uint64_t h[8], const uint8_t *p) {
    uint64_t w[80];
    for (int i = 0; i < 16; ++i) w[i] = load64_be(p + 8 * i);
    for (int i = 16; i < 80; ++i) {
        uint64_t s0 = ror64(w[i - 15], 1) ^ ror64(w[i - 15], 8) ^ (w[i - 15] >> 7);
        uint64_t s1 = ror64(w[i - 2], 19) ^ ror64(w[i - 2], 61) ^ (w[i - 2] >> 6);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint64_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint64_t e = h[4], f = h[5], g = h[6], k = h[7];
    for (int i = 0; i < 80; ++i) {
        uint64_t S1 = ror64(e, 14) ^ ror64(e, 18) ^ ror64(e, 41);
        uint64_t ch = (e & f) ^ (~e & g);
        uint64_t t1 = k + S1 + ch + SHA512_K[i] + w[i];
        uint64_t S0 = ror64(a, 28) ^ ror64(a, 34) ^ ror64(a, 39);
        uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
        uint64_t t2 = S0 + maj;
        k = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += k;
}

static void sha512_init(sha512_ctx *s) {
    memcpy(s->h, SHA512_IV, sizeof s->h);
    s->fill = 0;
    s->total = 0;
}

static void sha512_update(sha512_ctx *s, const uint8_t *m, uint64_t n) {
    s->total += n;
    if (s->fill) {
        size_t take = 128 - s->fill;
        if (take > n) take = (size_t)n;
        memcpy(s->buf + s->fill, m, take);
        s->fill += take;
        m += take;
        n -= take;
        if (s->fill < 128) return;
        sha512_block(s->h, s->buf);
        s->fill = 0;
    }
    for (; n >= 128; m += 128, n -= 128) sha512_block(s->h, m);
    memcpy(s->buf, m, (size_t)n);
    s->fill = (size_t)n;
}

static void sha512_final(sha512_ctx *s, uint8_t out[64]) {
    uint64_t bits = s->total << 3;
    uint8_t pad = 0x80;
    sha512_update(s, &pad, 1);
    pad = 0;
    while (s->fill != 112) sha512_update(s, &pad, 1);
    uint8_t len[16] = {0};
    store64_be(len + 8, bits); /* messages stay below 2^61 bytes */
    sha512_update(s, len, 16);
    for (int i = 0; i < 8; ++i) store64_be(out + 8 * i, s->h[i]);
    wipe(s, sizeof *s);
}

/* ------------------------------------------------------------------ */
/* BLAKE2b (RFC 7693), unkeyed, variable output                        */

static const uint8_t BLAKE2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

static void blake2b_compress(uint64_t h[8], const uint8_t block[128],
                             uint64_t t, int last) {
    uint64_t m[16], v[16];
    for (int i = 0; i < 16; ++i) m[i] = load64_le(block + 8 * i);
    for (int i = 0; i < 8; ++i) {
        v[i] = h[i];
        v[i + 8] = SHA512_IV[i];
    }
    v[12] ^= t; /* inputs here stay below 2^64 bytes: the high word is 0 */
    if (last) v[14] = ~v[14];
#define B2G(a, b, c, d, x, y)                 \
    do {                                      \
        v[a] = v[a] + v[b] + (x);             \
        v[d] = ror64(v[d] ^ v[a], 32);        \
        v[c] = v[c] + v[d];                   \
        v[b] = ror64(v[b] ^ v[c], 24);        \
        v[a] = v[a] + v[b] + (y);             \
        v[d] = ror64(v[d] ^ v[a], 16);        \
        v[c] = v[c] + v[d];                   \
        v[b] = ror64(v[b] ^ v[c], 63);        \
    } while (0)
    for (int r = 0; r < 12; ++r) {
        const uint8_t *s = BLAKE2B_SIGMA[r];
        B2G(0, 4, 8, 12, m[s[0]], m[s[1]]);
        B2G(1, 5, 9, 13, m[s[2]], m[s[3]]);
        B2G(2, 6, 10, 14, m[s[4]], m[s[5]]);
        B2G(3, 7, 11, 15, m[s[6]], m[s[7]]);
        B2G(0, 5, 10, 15, m[s[8]], m[s[9]]);
        B2G(1, 6, 11, 12, m[s[10]], m[s[11]]);
        B2G(2, 7, 8, 13, m[s[12]], m[s[13]]);
        B2G(3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
#undef B2G
    for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

static void blake2b(uint8_t *out, size_t outlen, const uint8_t *m, size_t n) {
    uint64_t h[8];
    uint8_t block[128];
    memcpy(h, SHA512_IV, sizeof h);
    h[0] ^= 0x01010000ULL ^ (uint64_t)outlen; /* fanout 1, depth 1, no key */
    uint64_t t = 0;
    while (n > 128) {
        t += 128;
        blake2b_compress(h, m, t, 0);
        m += 128;
        n -= 128;
    }
    memset(block, 0, sizeof block);
    memcpy(block, m, n);
    t += n;
    blake2b_compress(h, block, t, 1);
    uint8_t full[64];
    for (int i = 0; i < 8; ++i) store64_le(full + 8 * i, h[i]);
    memcpy(out, full, outlen);
}

/* ------------------------------------------------------------------ */
/* Salsa20 family                                                      */

static uint32_t rol32(uint32_t x, int n) { return (x << n) | (x >> (32 - n)); }

static const uint32_t SIGMA[4] = {0x61707865, 0x3320646e, 0x79622d32,
                                  0x6b206574}; /* "expand 32-byte k" */

static void salsa20_rounds(uint32_t x[16]) {
    for (int i = 0; i < 20; i += 2) {
        x[4] ^= rol32(x[0] + x[12], 7);   x[8] ^= rol32(x[4] + x[0], 9);
        x[12] ^= rol32(x[8] + x[4], 13);  x[0] ^= rol32(x[12] + x[8], 18);
        x[9] ^= rol32(x[5] + x[1], 7);    x[13] ^= rol32(x[9] + x[5], 9);
        x[1] ^= rol32(x[13] + x[9], 13);  x[5] ^= rol32(x[1] + x[13], 18);
        x[14] ^= rol32(x[10] + x[6], 7);  x[2] ^= rol32(x[14] + x[10], 9);
        x[6] ^= rol32(x[2] + x[14], 13);  x[10] ^= rol32(x[6] + x[2], 18);
        x[3] ^= rol32(x[15] + x[11], 7);  x[7] ^= rol32(x[3] + x[15], 9);
        x[11] ^= rol32(x[7] + x[3], 13);  x[15] ^= rol32(x[11] + x[7], 18);
        x[1] ^= rol32(x[0] + x[3], 7);    x[2] ^= rol32(x[1] + x[0], 9);
        x[3] ^= rol32(x[2] + x[1], 13);   x[0] ^= rol32(x[3] + x[2], 18);
        x[6] ^= rol32(x[5] + x[4], 7);    x[7] ^= rol32(x[6] + x[5], 9);
        x[4] ^= rol32(x[7] + x[6], 13);   x[5] ^= rol32(x[4] + x[7], 18);
        x[11] ^= rol32(x[10] + x[9], 7);  x[8] ^= rol32(x[11] + x[10], 9);
        x[9] ^= rol32(x[8] + x[11], 13);  x[10] ^= rol32(x[9] + x[8], 18);
        x[12] ^= rol32(x[15] + x[14], 7); x[13] ^= rol32(x[12] + x[15], 9);
        x[14] ^= rol32(x[13] + x[12], 13); x[15] ^= rol32(x[14] + x[13], 18);
    }
}

/* state words: constants at 0, 5, 10, 15; key at 1-4 and 11-14; the
 * 16-byte input (nonce || counter for Salsa20) at 6-9 */
static void salsa20_setup(uint32_t x[16], const uint8_t key[32],
                          const uint8_t in[16]) {
    x[0] = SIGMA[0]; x[5] = SIGMA[1]; x[10] = SIGMA[2]; x[15] = SIGMA[3];
    for (int i = 0; i < 4; ++i) {
        x[1 + i] = load32_le(key + 4 * i);
        x[11 + i] = load32_le(key + 16 + 4 * i);
        x[6 + i] = load32_le(in + 4 * i);
    }
}

static void hsalsa20(uint8_t out[32], const uint8_t in[16],
                     const uint8_t key[32]) {
    uint32_t x[16];
    salsa20_setup(x, key, in);
    salsa20_rounds(x);
    static const int pick[8] = {0, 5, 10, 15, 6, 7, 8, 9};
    for (int i = 0; i < 8; ++i) store32_le(out + 4 * i, x[pick[i]]);
    wipe(x, sizeof x);
}

/* out = in ^ Salsa20(key, nonce8) starting at 64-byte block `block`;
 * in == NULL writes the keystream itself */
static void salsa20_xor(uint8_t *out, const uint8_t *in, uint64_t n,
                        const uint8_t nonce8[8], uint64_t block,
                        const uint8_t key[32]) {
    uint8_t iv[16];
    uint32_t s[16], x[16];
    memcpy(iv, nonce8, 8);
    store64_le(iv + 8, block);
    salsa20_setup(s, key, iv);
    while (n > 0) {
        memcpy(x, s, sizeof x);
        salsa20_rounds(x);
        for (int i = 0; i < 16; ++i) x[i] += s[i];
        uint64_t take = n < 64 ? n : 64;
        if (take == 64) {
            for (int i = 0; i < 16; ++i) {
                uint32_t w = x[i];
                if (in) w ^= load32_le(in + 4 * i);
                store32_le(out + 4 * i, w);
            }
        } else {
            uint8_t ks[64];
            for (int i = 0; i < 16; ++i) store32_le(ks + 4 * i, x[i]);
            for (uint64_t i = 0; i < take; ++i)
                out[i] = (uint8_t)(in ? in[i] ^ ks[i] : ks[i]);
            wipe(ks, sizeof ks);
        }
        if (++s[8] == 0) ++s[9];
        out += take;
        if (in) in += take;
        n -= take;
    }
    wipe(s, sizeof s);
    wipe(x, sizeof x);
}

/* ------------------------------------------------------------------ */
/* Poly1305, three 44/44/42-bit limbs                                  */

#define M44 0xfffffffffffULL
#define M42 0x3ffffffffffULL

static void poly1305(uint8_t mac[16], const uint8_t *m, uint64_t n,
                     const uint8_t key[32]) {
    uint64_t t0 = load64_le(key), t1 = load64_le(key + 8);
    const uint64_t r0 = t0 & 0xffc0fffffffULL;
    const uint64_t r1 = ((t0 >> 44) | (t1 << 20)) & 0xfffffc0ffffULL;
    const uint64_t r2 = (t1 >> 24) & 0x00ffffffc0fULL;
    const uint64_t s1 = r1 * (5 << 2), s2 = r2 * (5 << 2);
    uint64_t h0 = 0, h1 = 0, h2 = 0, c;
    uint8_t last[16];
    while (n > 0) {
        const uint8_t *p = m;
        uint64_t hibit = 1ULL << 40;
        if (n < 16) {
            memset(last, 0, sizeof last);
            memcpy(last, m, (size_t)n);
            last[n] = 1;
            p = last;
            hibit = 0;
        }
        t0 = load64_le(p);
        t1 = load64_le(p + 8);
        h0 += t0 & M44;
        h1 += ((t0 >> 44) | (t1 << 20)) & M44;
        h2 += ((t1 >> 24) & M42) | hibit;
        u128 d0 = (u128)h0 * r0 + (u128)h1 * s2 + (u128)h2 * s1;
        u128 d1 = (u128)h0 * r1 + (u128)h1 * r0 + (u128)h2 * s2;
        u128 d2 = (u128)h0 * r2 + (u128)h1 * r1 + (u128)h2 * r0;
        c = (uint64_t)(d0 >> 44); h0 = (uint64_t)d0 & M44;
        d1 += c; c = (uint64_t)(d1 >> 44); h1 = (uint64_t)d1 & M44;
        d2 += c; c = (uint64_t)(d2 >> 42); h2 = (uint64_t)d2 & M42;
        h0 += c * 5; c = h0 >> 44; h0 &= M44;
        h1 += c;
        uint64_t take = n < 16 ? n : 16;
        m += take;
        n -= take;
    }
    c = h1 >> 44; h1 &= M44;
    h2 += c; c = h2 >> 42; h2 &= M42;
    h0 += c * 5; c = h0 >> 44; h0 &= M44;
    h1 += c; c = h1 >> 44; h1 &= M44;
    h2 += c; c = h2 >> 42; h2 &= M42;
    h0 += c * 5; c = h0 >> 44; h0 &= M44;
    h1 += c;
    /* h - p = h + 5 - 2^130: keep it when it does not go negative */
    uint64_t g0 = h0 + 5; c = g0 >> 44; g0 &= M44;
    uint64_t g1 = h1 + c; c = g1 >> 44; g1 &= M44;
    uint64_t g2 = h2 + c - (1ULL << 42);
    c = (g2 >> 63) - 1; /* all ones when h >= p */
    h0 = (h0 & ~c) | (g0 & c);
    h1 = (h1 & ~c) | (g1 & c);
    h2 = (h2 & ~c) | (g2 & c);
    t0 = load64_le(key + 16);
    t1 = load64_le(key + 24);
    h0 += t0 & M44; c = h0 >> 44; h0 &= M44;
    h1 += (((t0 >> 44) | (t1 << 20)) & M44) + c; c = h1 >> 44; h1 &= M44;
    h2 += ((t1 >> 24) & M42) + c; h2 &= M42;
    store64_le(mac, h0 | (h1 << 44));
    store64_le(mac + 8, (h1 >> 20) | (h2 << 24));
    wipe(last, sizeof last);
}

static int verify16(const uint8_t *a, const uint8_t *b) {
    uint32_t d = 0;
    for (int i = 0; i < 16; ++i) d |= (uint32_t)(a[i] ^ b[i]);
    return (int)((1 & ((d - 1) >> 8)) - 1); /* 0 equal, -1 differ */
}

/* ------------------------------------------------------------------ */
/* GF(2^255 - 19), five 51-bit limbs                                   */

typedef uint64_t fe[5];
#define M51 0x7ffffffffffffULL

static void fe_copy(fe h, const fe f) { memcpy(h, f, sizeof(fe)); }

static void fe_0(fe h) { memset(h, 0, sizeof(fe)); }

static void fe_1(fe h) {
    fe_0(h);
    h[0] = 1;
}

static void fe_carry(fe h) {
    uint64_t c;
    c = h[0] >> 51; h[0] &= M51; h[1] += c;
    c = h[1] >> 51; h[1] &= M51; h[2] += c;
    c = h[2] >> 51; h[2] &= M51; h[3] += c;
    c = h[3] >> 51; h[3] &= M51; h[4] += c;
    c = h[4] >> 51; h[4] &= M51; h[0] += c * 19;
}

static void fe_add(fe h, const fe f, const fe g) {
    for (int i = 0; i < 5; ++i) h[i] = f[i] + g[i];
    fe_carry(h);
}

/* f - g + 4p keeps every limb positive for carried inputs */
static void fe_sub(fe h, const fe f, const fe g) {
    h[0] = f[0] + 0x1fffffffffffb4ULL - g[0];
    for (int i = 1; i < 5; ++i) h[i] = f[i] + 0x1ffffffffffffcULL - g[i];
    fe_carry(h);
}

static void fe_neg(fe h, const fe f) {
    fe z;
    fe_0(z);
    fe_sub(h, z, f);
}

static void fe_mul(fe h, const fe f, const fe g) {
    uint64_t f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3], f4 = f[4];
    uint64_t g0 = g[0], g1 = g[1], g2 = g[2], g3 = g[3], g4 = g[4];
    uint64_t g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3, g4_19 = 19 * g4;
    u128 t0 = (u128)f0 * g0 + (u128)f1 * g4_19 + (u128)f2 * g3_19 +
              (u128)f3 * g2_19 + (u128)f4 * g1_19;
    u128 t1 = (u128)f0 * g1 + (u128)f1 * g0 + (u128)f2 * g4_19 +
              (u128)f3 * g3_19 + (u128)f4 * g2_19;
    u128 t2 = (u128)f0 * g2 + (u128)f1 * g1 + (u128)f2 * g0 +
              (u128)f3 * g4_19 + (u128)f4 * g3_19;
    u128 t3 = (u128)f0 * g3 + (u128)f1 * g2 + (u128)f2 * g1 +
              (u128)f3 * g0 + (u128)f4 * g4_19;
    u128 t4 = (u128)f0 * g4 + (u128)f1 * g3 + (u128)f2 * g2 +
              (u128)f3 * g1 + (u128)f4 * g0;
    uint64_t c;
    t1 += (uint64_t)(t0 >> 51); h[0] = (uint64_t)t0 & M51;
    t2 += (uint64_t)(t1 >> 51); h[1] = (uint64_t)t1 & M51;
    t3 += (uint64_t)(t2 >> 51); h[2] = (uint64_t)t2 & M51;
    t4 += (uint64_t)(t3 >> 51); h[3] = (uint64_t)t3 & M51;
    c = (uint64_t)(t4 >> 51); h[4] = (uint64_t)t4 & M51;
    h[0] += c * 19;
    c = h[0] >> 51; h[0] &= M51; h[1] += c;
}

static void fe_sq(fe h, const fe f) { fe_mul(h, f, f); }

static void fe_mul_small(fe h, const fe f, uint64_t s) {
    u128 t;
    uint64_t c = 0;
    for (int i = 0; i < 5; ++i) {
        t = (u128)f[i] * s + c;
        h[i] = (uint64_t)t & M51;
        c = (uint64_t)(t >> 51);
    }
    h[0] += c * 19;
    c = h[0] >> 51; h[0] &= M51; h[1] += c;
}

/* f^e for a public 256-bit little-endian exponent */
static void fe_pow(fe h, const fe f, const uint8_t e[32]) {
    fe r, b;
    fe_1(r);
    fe_copy(b, f);
    int started = 0;
    for (int i = 255; i >= 0; --i) {
        if (started) fe_sq(r, r);
        if ((e[i >> 3] >> (i & 7)) & 1) {
            fe_mul(r, r, b);
            started = 1;
        }
    }
    fe_copy(h, r);
}

static void fe_invert(fe h, const fe f) {
    uint8_t e[32]; /* p - 2 = 2^255 - 21 */
    memset(e, 0xff, 32);
    e[0] = 0xeb;
    e[31] = 0x7f;
    fe_pow(h, f, e);
}

static void fe_pow22523(fe h, const fe f) {
    uint8_t e[32]; /* (p - 5) / 8 = 2^252 - 3 */
    memset(e, 0xff, 32);
    e[0] = 0xfd;
    e[31] = 0x0f;
    fe_pow(h, f, e);
}

static void fe_frombytes(fe h, const uint8_t s[32]) {
    uint64_t w0 = load64_le(s), w1 = load64_le(s + 8);
    uint64_t w2 = load64_le(s + 16), w3 = load64_le(s + 24);
    h[0] = w0 & M51;
    h[1] = ((w0 >> 51) | (w1 << 13)) & M51;
    h[2] = ((w1 >> 38) | (w2 << 26)) & M51;
    h[3] = ((w2 >> 25) | (w3 << 39)) & M51;
    h[4] = (w3 >> 12) & M51; /* the top bit is ignored */
}

static void fe_tobytes(uint8_t s[32], const fe f) {
    fe h;
    fe_copy(h, f);
    fe_carry(h);
    fe_carry(h);
    /* h < 2^255 + small: subtract p when h >= p */
    uint64_t q = (h[0] + 19) >> 51;
    q = (h[1] + q) >> 51;
    q = (h[2] + q) >> 51;
    q = (h[3] + q) >> 51;
    q = (h[4] + q) >> 51;
    h[0] += 19 * q;
    uint64_t c;
    c = h[0] >> 51; h[0] &= M51; h[1] += c;
    c = h[1] >> 51; h[1] &= M51; h[2] += c;
    c = h[2] >> 51; h[2] &= M51; h[3] += c;
    c = h[3] >> 51; h[3] &= M51; h[4] += c;
    h[4] &= M51;
    store64_le(s, h[0] | (h[1] << 51));
    store64_le(s + 8, (h[1] >> 13) | (h[2] << 38));
    store64_le(s + 16, (h[2] >> 26) | (h[3] << 25));
    store64_le(s + 24, (h[3] >> 39) | (h[4] << 12));
}

static int fe_iszero(const fe f) {
    uint8_t s[32];
    uint8_t d = 0;
    fe_tobytes(s, f);
    for (int i = 0; i < 32; ++i) d |= s[i];
    return d == 0;
}

static int fe_isnegative(const fe f) {
    uint8_t s[32];
    fe_tobytes(s, f);
    return s[0] & 1;
}

static void fe_cswap(fe f, fe g, uint64_t b) {
    uint64_t mask = 0 - b;
    for (int i = 0; i < 5; ++i) {
        uint64_t x = mask & (f[i] ^ g[i]);
        f[i] ^= x;
        g[i] ^= x;
    }
}

static void fe_cmov(fe f, const fe g, uint64_t b) {
    uint64_t mask = 0 - b;
    for (int i = 0; i < 5; ++i) f[i] ^= mask & (f[i] ^ g[i]);
}

/* ------------------------------------------------------------------ */
/* X25519 (RFC 7748)                                                   */

static const uint8_t X25519_BASE[32] = {9};

/* q = clamp(n) * u; -1 when the result is all zero (a small-order u),
 * as crypto_scalarmult_curve25519 returns */
static int x25519(uint8_t q[32], const uint8_t n[32], const uint8_t p[32]) {
    uint8_t e[32];
    memcpy(e, n, 32);
    e[0] &= 248;
    e[31] &= 127;
    e[31] |= 64;
    fe x1, x2, z2, x3, z3, a, aa, b, bb, ee, c, d, da, cb, t;
    fe_frombytes(x1, p);
    fe_1(x2);
    fe_0(z2);
    fe_copy(x3, x1);
    fe_1(z3);
    uint64_t swap = 0;
    for (int pos = 254; pos >= 0; --pos) {
        uint64_t bit = (e[pos >> 3] >> (pos & 7)) & 1;
        swap ^= bit;
        fe_cswap(x2, x3, swap);
        fe_cswap(z2, z3, swap);
        swap = bit;
        fe_add(a, x2, z2);
        fe_sq(aa, a);
        fe_sub(b, x2, z2);
        fe_sq(bb, b);
        fe_sub(ee, aa, bb);
        fe_add(c, x3, z3);
        fe_sub(d, x3, z3);
        fe_mul(da, d, a);
        fe_mul(cb, c, b);
        fe_add(t, da, cb);
        fe_sq(x3, t);
        fe_sub(t, da, cb);
        fe_sq(t, t);
        fe_mul(z3, x1, t);
        fe_mul(x2, aa, bb);
        fe_mul_small(t, ee, 121665);
        fe_add(t, aa, t);
        fe_mul(z2, ee, t);
    }
    fe_cswap(x2, x3, swap);
    fe_cswap(z2, z3, swap);
    fe_invert(z2, z2);
    fe_mul(x2, x2, z2);
    fe_tobytes(q, x2);
    wipe(e, sizeof e);
    uint8_t acc = 0;
    for (int i = 0; i < 32; ++i) acc |= q[i];
    return -(int)(1 & ((acc - 1) >> 8));
}

int sda_box_public(uint8_t pk[32], const uint8_t sk[32]) {
    return x25519(pk, sk, X25519_BASE);
}

int sda_box_keypair(uint8_t pk[32], uint8_t sk[32]) {
    if (sda_randombytes(sk, 32) != 0) return -1;
    return sda_box_public(pk, sk);
}

/* crypto_box_beforenm: HSalsa20 of the X25519 secret under a zero input */
static int box_beforenm(uint8_t k[32], const uint8_t pk[32],
                        const uint8_t sk[32]) {
    static const uint8_t zero[16] = {0};
    uint8_t s[32];
    if (x25519(s, sk, pk) != 0) return -1;
    hsalsa20(k, zero, s);
    wipe(s, sizeof s);
    return 0;
}

static void seal_nonce(uint8_t nonce[24], const uint8_t epk[32],
                       const uint8_t pk[32]) {
    uint8_t in[64];
    memcpy(in, epk, 32);
    memcpy(in + 32, pk, 32);
    blake2b(nonce, 24, in, 64);
}

#define SEALBYTES 48

int sda_box_seal_with_ephemeral(uint8_t *c, const uint8_t *m, uint64_t mlen,
                                const uint8_t pk[32], const uint8_t esk[32]) {
    uint8_t epk[32], nonce[24], k[32], subkey[32], block0[32];
    if (sda_box_public(epk, esk) != 0) return -1;
    if (box_beforenm(k, pk, esk) != 0) return -1;
    seal_nonce(nonce, epk, pk);
    hsalsa20(subkey, nonce, k);
    /* keystream bytes 0-31 are the Poly1305 key; the message starts at 32 */
    salsa20_xor(block0, NULL, 32, nonce + 16, 0, subkey);
    uint8_t *body = c + SEALBYTES;
    uint64_t head = mlen < 32 ? mlen : 32;
    uint8_t first[64];
    memset(first, 0, 32);
    memcpy(first + 32, m, (size_t)head);
    salsa20_xor(first, first, 32 + head, nonce + 16, 0, subkey);
    memcpy(body, first + 32, (size_t)head);
    if (mlen > head)
        salsa20_xor(body + head, m + head, mlen - head, nonce + 16, 1, subkey);
    memcpy(c, epk, 32);
    poly1305(c + 32, body, mlen, block0);
    wipe(k, sizeof k);
    wipe(subkey, sizeof subkey);
    wipe(block0, sizeof block0);
    wipe(first, sizeof first);
    return 0;
}

int sda_box_seal(uint8_t *c, const uint8_t *m, uint64_t mlen,
                 const uint8_t pk[32]) {
    uint8_t esk[32];
    if (sda_randombytes(esk, 32) != 0) return -1;
    int rc = sda_box_seal_with_ephemeral(c, m, mlen, pk, esk);
    wipe(esk, sizeof esk);
    return rc;
}

int sda_box_seal_open(uint8_t *m, const uint8_t *c, uint64_t clen,
                      const uint8_t pk[32], const uint8_t sk[32]) {
    uint8_t nonce[24], k[32], subkey[32], block0[32], mac[16];
    if (clen < SEALBYTES) return -1;
    if (box_beforenm(k, c, sk) != 0) return -1;
    seal_nonce(nonce, c, pk);
    hsalsa20(subkey, nonce, k);
    salsa20_xor(block0, NULL, 32, nonce + 16, 0, subkey);
    const uint8_t *body = c + SEALBYTES;
    uint64_t mlen = clen - SEALBYTES;
    poly1305(mac, body, mlen, block0);
    int rc = verify16(mac, c + 32);
    if (rc == 0) {
        uint64_t head = mlen < 32 ? mlen : 32;
        uint8_t first[64];
        memset(first, 0, 32);
        memcpy(first + 32, body, (size_t)head);
        salsa20_xor(first, first, 32 + head, nonce + 16, 0, subkey);
        memcpy(m, first + 32, (size_t)head);
        if (mlen > head)
            salsa20_xor(m + head, body + head, mlen - head, nonce + 16, 1,
                        subkey);
        wipe(first, sizeof first);
    }
    wipe(k, sizeof k);
    wipe(subkey, sizeof subkey);
    wipe(block0, sizeof block0);
    return rc;
}

/* ------------------------------------------------------------------ */
/* Edwards25519: -x^2 + y^2 = 1 + d x^2 y^2, extended coordinates      */

typedef struct {
    fe X, Y, Z, T;
} ge;

static const fe ED_D2 = {0x69b9426b2f159ULL, 0x35050762add7aULL, 0x3cf44c0038052ULL,
                         0x6738cc7407977ULL, 0x2406d9dc56dffULL};
static const fe ED_D = {0x34dca135978a3ULL, 0x1a8283b156ebdULL, 0x5e7a26001c029ULL,
                        0x739c663a03cbbULL, 0x52036cee2b6ffULL};
static const fe ED_SQRTM1 = {0x61b274a0ea0b0ULL, 0x0d5a5fc8f189dULL, 0x7ef5e9cbd0c60ULL,
                             0x78595a6804c9eULL, 0x2b8324804fc1dULL};
static const ge ED_B = {
    {0x62d608f25d51aULL, 0x412a4b4f6592aULL, 0x75b7171a4b31dULL, 0x1ff60527118feULL,
     0x216936d3cd6e5ULL},
    {0x6666666666658ULL, 0x4ccccccccccccULL, 0x1999999999999ULL, 0x3333333333333ULL,
     0x6666666666666ULL},
    {1, 0, 0, 0, 0},
    {0x68ab3a5b7dda3ULL, 0x00eea2a5eadbbULL, 0x2af8df483c27eULL, 0x332b375274732ULL,
     0x67875f0fd78b7ULL},
};

static void ge_identity(ge *h) {
    fe_0(h->X);
    fe_1(h->Y);
    fe_1(h->Z);
    fe_0(h->T);
}

/* add-2008-hwcd-3: complete for a = -1 and non-square d, so it doubles too */
static void ge_add(ge *r, const ge *p, const ge *q) {
    fe a, b, c, d, e, f, g, h, t;
    fe_sub(a, p->Y, p->X);
    fe_sub(t, q->Y, q->X);
    fe_mul(a, a, t);
    fe_add(b, p->Y, p->X);
    fe_add(t, q->Y, q->X);
    fe_mul(b, b, t);
    fe_mul(c, p->T, q->T);
    fe_mul(c, c, ED_D2);
    fe_mul(d, p->Z, q->Z);
    fe_add(d, d, d);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_mul(r->X, e, f);
    fe_mul(r->Y, g, h);
    fe_mul(r->T, e, h);
    fe_mul(r->Z, f, g);
}

static void ge_cmov(ge *p, const ge *q, uint64_t b) {
    fe_cmov(p->X, q->X, b);
    fe_cmov(p->Y, q->Y, b);
    fe_cmov(p->Z, q->Z, b);
    fe_cmov(p->T, q->T, b);
}

static void ge_tobytes(uint8_t s[32], const ge *p) {
    fe zi, x, y;
    fe_invert(zi, p->Z);
    fe_mul(x, p->X, zi);
    fe_mul(y, p->Y, zi);
    fe_tobytes(s, y);
    s[31] ^= (uint8_t)(fe_isnegative(x) << 7);
}

/* [a]B for a secret 256-bit scalar, without secret-dependent branches */
static void ge_scalarmult_base(ge *h, const uint8_t a[32]) {
    ge q, t;
    ge_identity(&q);
    for (int i = 255; i >= 0; --i) {
        ge_add(&q, &q, &q);
        ge_add(&t, &q, &ED_B);
        ge_cmov(&q, &t, (a[i >> 3] >> (i & 7)) & 1);
    }
    *h = q;
    wipe(&t, sizeof t);
}

/* libsodium's ge25519_frombytes_negate_vartime: -A from its encoding */
static int ge_frombytes_negate_vartime(ge *h, const uint8_t s[32]) {
    fe u, v, v3, vxx, check, one;
    fe_1(one);
    fe_frombytes(h->Y, s);
    fe_1(h->Z);
    fe_sq(u, h->Y);
    fe_mul(v, u, ED_D);
    fe_sub(u, u, one); /* y^2 - 1 */
    fe_add(v, v, one); /* d y^2 + 1 */
    fe_sq(v3, v);
    fe_mul(v3, v3, v); /* v^3 */
    fe_sq(h->X, v3);
    fe_mul(h->X, h->X, v);
    fe_mul(h->X, h->X, u); /* u v^7 */
    fe_pow22523(h->X, h->X);
    fe_mul(h->X, h->X, v3);
    fe_mul(h->X, h->X, u); /* u v^3 (u v^7)^((p-5)/8) */
    fe_sq(vxx, h->X);
    fe_mul(vxx, vxx, v);
    fe_sub(check, vxx, u);
    if (!fe_iszero(check)) {
        fe_add(check, vxx, u);
        if (!fe_iszero(check)) return -1;
        fe_mul(h->X, h->X, ED_SQRTM1);
    }
    if (fe_isnegative(h->X) == (s[31] >> 7)) fe_neg(h->X, h->X);
    fe_mul(h->T, h->X, h->Y);
    return 0;
}

/* libsodium's blacklist of small-order encodings, sign bit ignored:
 * 0, 1, the two order-8 y values, p-1, p and p+1 */
static int ge_has_small_order(const uint8_t s[32]) {
    static const uint8_t bad[7][32] = {
        {0},
        {1},
        {0x26, 0xe8, 0x95, 0x8f, 0xc2, 0xb2, 0x27, 0xb0, 0x45, 0xc3, 0xf4,
         0x89, 0xf2, 0xef, 0x98, 0xf0, 0xd5, 0xdf, 0xac, 0x05, 0xd3, 0xc6,
         0x33, 0x39, 0xb1, 0x38, 0x02, 0x88, 0x6d, 0x53, 0xfc, 0x05},
        {0xc7, 0x17, 0x6a, 0x70, 0x3d, 0x4d, 0xd8, 0x4f, 0xba, 0x3c, 0x0b,
         0x76, 0x0d, 0x10, 0x67, 0x0f, 0x2a, 0x20, 0x53, 0xfa, 0x2c, 0x39,
         0xcc, 0xc6, 0x4e, 0xc7, 0xfd, 0x77, 0x92, 0xac, 0x03, 0x7a},
        {0xec, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
         0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
         0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x7f},
        {0xed, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
         0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
         0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x7f},
        {0xee, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
         0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
         0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x7f},
    };
    for (int i = 0; i < 7; ++i) {
        uint8_t d = (uint8_t)((s[31] & 0x7f) ^ bad[i][31]);
        for (int j = 0; j < 31; ++j) d |= (uint8_t)(s[j] ^ bad[i][j]);
        if (d == 0) return 1;
    }
    return 0;
}

/* y < p, the sign bit aside */
static int ge_is_canonical(const uint8_t s[32]) {
    if ((s[31] & 0x7f) != 0x7f) return 1;
    for (int i = 30; i > 0; --i)
        if (s[i] != 0xff) return 1;
    return s[0] < 0xed;
}

/* ------------------------------------------------------------------ */
/* scalars mod L = 2^252 + 27742317777372353535851937790883648493      */

static const uint64_t SC_L[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                                 0x0000000000000000ULL, 0x1000000000000000ULL};

/* r = x mod L for a little-endian x of n 64-bit words, one bit at a time:
 * r = 2r + bit, minus L when that does not borrow (r < 2L < 2^254) */
static void sc_reduce_words(uint8_t out[32], const uint64_t *x, int n) {
    uint64_t r[4] = {0, 0, 0, 0};
    for (int i = 64 * n - 1; i >= 0; --i) {
        r[3] = (r[3] << 1) | (r[2] >> 63);
        r[2] = (r[2] << 1) | (r[1] >> 63);
        r[1] = (r[1] << 1) | (r[0] >> 63);
        r[0] = (r[0] << 1) | ((x[i >> 6] >> (i & 63)) & 1);
        uint64_t t[4], borrow = 0;
        for (int j = 0; j < 4; ++j) {
            u128 d = (u128)r[j] - SC_L[j] - borrow;
            t[j] = (uint64_t)d;
            borrow = (uint64_t)(d >> 64) & 1;
        }
        uint64_t keep = borrow - 1; /* all ones when r >= L */
        for (int j = 0; j < 4; ++j) r[j] = (r[j] & ~keep) | (t[j] & keep);
    }
    for (int j = 0; j < 4; ++j) store64_le(out + 8 * j, r[j]);
}

static void sc_reduce64(uint8_t out[32], const uint8_t in[64]) {
    uint64_t x[8];
    for (int i = 0; i < 8; ++i) x[i] = load64_le(in + 8 * i);
    sc_reduce_words(out, x, 8);
}

/* s = (a * b + c) mod L */
static void sc_muladd(uint8_t s[32], const uint8_t a[32], const uint8_t b[32],
                      const uint8_t c[32]) {
    uint64_t A[4], B[4], x[9] = {0};
    for (int i = 0; i < 4; ++i) {
        A[i] = load64_le(a + 8 * i);
        B[i] = load64_le(b + 8 * i);
    }
    for (int i = 0; i < 4; ++i) {
        uint64_t carry = 0;
        for (int j = 0; j < 4; ++j) {
            u128 t = (u128)A[i] * B[j] + x[i + j] + carry;
            x[i + j] = (uint64_t)t;
            carry = (uint64_t)(t >> 64);
        }
        x[i + 4] = carry;
    }
    uint64_t carry = 0;
    for (int i = 0; i < 9; ++i) {
        u128 t = (u128)x[i] + (i < 4 ? load64_le(c + 8 * i) : 0) + carry;
        x[i] = (uint64_t)t;
        carry = (uint64_t)(t >> 64);
    }
    sc_reduce_words(s, x, 9);
}

/* s < L (libsodium's sc25519_is_canonical) */
static int sc_is_canonical(const uint8_t s[32]) {
    for (int j = 3; j >= 0; --j) {
        uint64_t w = load64_le(s + 8 * j);
        if (w != SC_L[j]) return w < SC_L[j];
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* Ed25519                                                             */

int sda_sign_seed_keypair(uint8_t pk[32], uint8_t sk[64],
                          const uint8_t seed[32]) {
    uint8_t az[64];
    sha512_ctx h;
    sha512_init(&h);
    sha512_update(&h, seed, 32);
    sha512_final(&h, az);
    az[0] &= 248;
    az[31] &= 127;
    az[31] |= 64;
    ge A;
    ge_scalarmult_base(&A, az);
    ge_tobytes(pk, &A);
    memmove(sk, seed, 32);
    memmove(sk + 32, pk, 32);
    wipe(az, sizeof az);
    return 0;
}

int sda_sign_keypair(uint8_t pk[32], uint8_t sk[64]) {
    uint8_t seed[32];
    if (sda_randombytes(seed, 32) != 0) return -1;
    int rc = sda_sign_seed_keypair(pk, sk, seed);
    wipe(seed, sizeof seed);
    return rc;
}

/* RFC 8032's deterministic nonce; like libsodium, the public half of the
 * signature's hash is read from sk[32..64], not recomputed */
int sda_sign_detached(uint8_t sig[64], const uint8_t *m, uint64_t mlen,
                      const uint8_t sk[64]) {
    uint8_t az[64], nonce64[64], nonce[32], hram64[64], hram[32];
    sha512_ctx h;
    sha512_init(&h);
    sha512_update(&h, sk, 32);
    sha512_final(&h, az);
    sha512_init(&h);
    sha512_update(&h, az + 32, 32);
    sha512_update(&h, m, mlen);
    sha512_final(&h, nonce64);
    sc_reduce64(nonce, nonce64);
    ge R;
    ge_scalarmult_base(&R, nonce);
    ge_tobytes(sig, &R);
    memmove(sig + 32, sk + 32, 32);
    sha512_init(&h);
    sha512_update(&h, sig, 64);
    sha512_update(&h, m, mlen);
    sha512_final(&h, hram64);
    sc_reduce64(hram, hram64);
    az[0] &= 248;
    az[31] &= 127;
    az[31] |= 64;
    sc_muladd(sig + 32, hram, az, nonce);
    wipe(az, sizeof az);
    wipe(nonce64, sizeof nonce64);
    wipe(nonce, sizeof nonce);
    return 0;
}

int sda_sign_verify_detached(const uint8_t sig[64], const uint8_t *m,
                             uint64_t mlen, const uint8_t pk[32]) {
    if (!sc_is_canonical(sig + 32) || ge_has_small_order(sig)) return -1;
    if (!ge_is_canonical(pk) || ge_has_small_order(pk)) return -1;
    ge negA;
    if (ge_frombytes_negate_vartime(&negA, pk) != 0) return -1;
    uint8_t h64[64], hram[32];
    sha512_ctx h;
    sha512_init(&h);
    sha512_update(&h, sig, 32);
    sha512_update(&h, pk, 32);
    sha512_update(&h, m, mlen);
    sha512_final(&h, h64);
    sc_reduce64(hram, h64);
    /* [S]B + [h](-A), double-and-add over public scalars */
    const uint8_t *S = sig + 32;
    ge q;
    ge_identity(&q);
    for (int i = 255; i >= 0; --i) {
        ge_add(&q, &q, &q);
        if ((S[i >> 3] >> (i & 7)) & 1) ge_add(&q, &q, &ED_B);
        if ((hram[i >> 3] >> (i & 7)) & 1) ge_add(&q, &q, &negA);
    }
    uint8_t rcheck[32];
    ge_tobytes(rcheck, &q);
    uint8_t d = 0;
    for (int i = 0; i < 32; ++i) d |= (uint8_t)(rcheck[i] ^ sig[i]);
    return d == 0 ? 0 : -1;
}
