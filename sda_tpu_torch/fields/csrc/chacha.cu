// K3: ChaCha20 seed-mask expansion and combine, for NVIDIA Hopper (sm_90a).
//
// Replaces sda_tpu/fields/chacha_jax.py (jnp, not Pallas: the JAX package
// runs it as XLA lanes on the TPU): chacha_block_words, _expand_no_reject,
// _combine_no_reject and the windowed CHACHA_PRG_V1 stream of
// stream_u64_at with FieldOps.from_u64 fused in. Each ChaCha20 block
// (counter c, key = the seed's 8 words, nonce 0) yields 16 words, read as 8
// u64 draws; draw i of a stream is draw i mod 8 of block counter0 + i / 8.
// Two layouts: CHACHA_PRG_V1 takes word 2j as the low half of draw j,
// rand 0.3's stream (CHACHA_PRG_RAND03) takes it as the high half. Every
// draw is reduced to its canonical residue v mod m, m < 2^62, exactly
// (Barrett with the host's floor((2^64 - 1) / m)), and tested against the
// host spec's acceptance zone (v > zone means the host would have redrawn):
// a seed with such a draw among its first d is flagged, and the host
// replays it (sda_tpu_torch/fields/chacha_device.py).
//
// What bounds it on this card: integer operations. A block is 20 rounds of
// 4 quarter-rounds of 4 adds, 4 xors and 4 rotates (one funnel shift each),
// 960 operations, plus the feed-forward and, per draw, the reduction and
// the zone test; its 8 draws are 64 bytes of int64 output at most (the
// combine writes one [d] row for S seeds). See benchmarks/bounds.py.
//
// Design: one thread a ChaCha block, its 16 state words in registers, the
// 10 double rounds unrolled. The combine gives each thread one block of 8
// columns and loops over all S seeds, keeping each column's sum below m
// with a conditional subtract: no atomics and no second pass. The seed
// words are read from device memory by every thread of a warp at once
// (one broadcast load a word). The kernels allocate nothing; each C entry
// launches on the caller's stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxGridY = 65535;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

#define QUARTER(a, b, c, d)                \
  a += b; d = rotl(d ^ a, 16);             \
  c += d; b = rotl(b ^ c, 12);             \
  a += b; d = rotl(d ^ a, 8);              \
  c += d; b = rotl(b ^ c, 7);

struct Key {
  uint32_t w[8];
};

// The 16 keystream words of block `counter` under key k.
__device__ __forceinline__ void chacha_block(const uint32_t k[8],
                                             uint32_t counter,
                                             uint32_t out[16]) {
  const uint32_t c0 = 0x61707865u, c1 = 0x3320646Eu, c2 = 0x79622D32u,
                 c3 = 0x6B206574u;
  uint32_t x0 = c0, x1 = c1, x2 = c2, x3 = c3;
  uint32_t x4 = k[0], x5 = k[1], x6 = k[2], x7 = k[3];
  uint32_t x8 = k[4], x9 = k[5], x10 = k[6], x11 = k[7];
  uint32_t x12 = counter, x13 = 0, x14 = 0, x15 = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    QUARTER(x0, x4, x8, x12)
    QUARTER(x1, x5, x9, x13)
    QUARTER(x2, x6, x10, x14)
    QUARTER(x3, x7, x11, x15)
    QUARTER(x0, x5, x10, x15)
    QUARTER(x1, x6, x11, x12)
    QUARTER(x2, x7, x8, x13)
    QUARTER(x3, x4, x9, x14)
  }
  out[0] = x0 + c0;  out[1] = x1 + c1;  out[2] = x2 + c2;  out[3] = x3 + c3;
  out[4] = x4 + k[0];  out[5] = x5 + k[1];  out[6] = x6 + k[2];
  out[7] = x7 + k[3];  out[8] = x8 + k[4];  out[9] = x9 + k[5];
  out[10] = x10 + k[6];  out[11] = x11 + k[7];
  out[12] = x12 + counter;  out[13] = x13;  out[14] = x14;  out[15] = x15;
}

// Draw j (0..7) of a block's words in the stream's layout.
template <bool HI_FIRST>
__device__ __forceinline__ uint64_t draw(const uint32_t w[16], int j) {
  const uint64_t a = w[2 * j], b = w[2 * j + 1];
  return HI_FIRST ? (a << 32) | b : (b << 32) | a;
}

struct Modulus {
  uint64_t m;     // the modulus, 0 < m < 2^62
  uint64_t mu;    // floor((2^64 - 1) / m)
  uint64_t zone;  // largest draw the host spec accepts
};

// v mod m, exact: q = floor(v * mu / 2^64) is at most 2 below v / m, so
// v - q m < 3 m < 2^64 and two conditional subtracts canonicalise it.
__device__ __forceinline__ uint64_t reduce(uint64_t v, const Modulus& md) {
  uint64_t r = v - __umul64hi(v, md.mu) * md.m;
  r = r >= md.m ? r - md.m : r;
  return r >= md.m ? r - md.m : r;
}

__device__ __forceinline__ void load_key(const uint32_t* seeds, long long s,
                                         uint32_t k[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) k[j] = __ldg(seeds + 8 * s + j);
}

__global__ void __launch_bounds__(kThreads)
chacha_blocks_kernel(Key key, uint32_t counter0, long long nblocks,
                     uint32_t* __restrict__ out) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  uint32_t w[16];
  chacha_block(key.w, counter0 + (uint32_t)b, w);
#pragma unroll
  for (int j = 0; j < 16; ++j) out[16 * b + j] = w[j];
}

// out[s, i] = draw i of seed s's stream from block counter0, mod m, for
// i < d; flags[s] = 1 when one of them lies above the zone (flags may be
// null: the windowed stream has no rejection).
template <bool HI_FIRST>
__global__ void __launch_bounds__(kThreads)
chacha_expand_kernel(const uint32_t* __restrict__ seeds, int S,
                     uint32_t counter0, long long d, long long nblocks,
                     Modulus md, long long* __restrict__ out,
                     int* __restrict__ flags) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  for (long long s = blockIdx.y; s < S; s += gridDim.y) {
    uint32_t k[8], w[16];
    load_key(seeds, s, k);
    chacha_block(k, counter0 + (uint32_t)b, w);
    bool rejected = false;
    long long* row = out + s * d;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long i = 8 * b + j;
      if (i < d) {
        const uint64_t v = draw<HI_FIRST>(w, j);
        rejected |= v > md.zone;
        row[i] = (long long)reduce(v, md);
      }
    }
    if (flags != nullptr && rejected) flags[s] = 1;
  }
}

// total[i] = sum over the S seeds of draw i of each stream (from block 0),
// mod m, for i < d; flags as above. One thread owns 8 columns.
template <bool HI_FIRST>
__global__ void __launch_bounds__(kThreads)
chacha_combine_kernel(const uint32_t* __restrict__ seeds, int S, long long d,
                      long long nblocks, Modulus md,
                      long long* __restrict__ total,
                      int* __restrict__ flags) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  const int live = d - 8 * b < 8 ? (int)(d - 8 * b) : 8;
  uint64_t acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0;
  for (int s = 0; s < S; ++s) {
    uint32_t k[8], w[16];
    load_key(seeds, s, k);
    chacha_block(k, (uint32_t)b, w);
    bool rejected = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t v = draw<HI_FIRST>(w, j);
      rejected |= j < live && v > md.zone;
      const uint64_t a = acc[j] + reduce(v, md);
      acc[j] = a >= md.m ? a - md.m : a;
    }
    if (rejected) flags[s] = 1;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < live) total[8 * b + j] = (long long)acc[j];
}

dim3 grid_of(long long nblocks, long long seeds) {
  return dim3((unsigned)((nblocks + kThreads - 1) / kThreads),
              (unsigned)(seeds < kMaxGridY ? seeds : kMaxGridY));
}

}  // namespace

// [nblocks, 16] keystream words from block counter0 (counters wrap mod
// 2^32); key: 8 words in host memory.
extern "C" int sda_chacha_blocks(const uint32_t* key, uint32_t counter0,
                                 long long nblocks, uint32_t* out,
                                 cudaStream_t stream) {
  if (nblocks < 0 || key == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (nblocks == 0) return (int)cudaSuccess;
  Key k;
  for (int j = 0; j < 8; ++j) k.w[j] = key[j];
  chacha_blocks_kernel<<<grid_of(nblocks, 1), kThreads, 0, stream>>>(
      k, counter0, nblocks, out);
  return (int)cudaGetLastError();
}

// [S, d] residues of S streams from block counter0, and rejection flags
// (null for none). seeds: [S, 8] words on the device.
extern "C" int sda_chacha_expand(const uint32_t* seeds, int S,
                                 uint32_t counter0, long long d,
                                 unsigned long long m, unsigned long long mu,
                                 unsigned long long zone, int hi_first,
                                 long long* out, int* flags,
                                 cudaStream_t stream) {
  if (S < 0 || d < 0 || m == 0 || m >= (1ull << 62))
    return (int)cudaErrorInvalidValue;
  if (S == 0 || d == 0) return (int)cudaSuccess;
  const long long nblocks = (d + 7) / 8;
  const Modulus md{m, mu, zone};
  const dim3 grid = grid_of(nblocks, S);
  if (hi_first)
    chacha_expand_kernel<true><<<grid, kThreads, 0, stream>>>(
        seeds, S, counter0, d, nblocks, md, out, flags);
  else
    chacha_expand_kernel<false><<<grid, kThreads, 0, stream>>>(
        seeds, S, counter0, d, nblocks, md, out, flags);
  return (int)cudaGetLastError();
}

// [d] sum mod m of S streams (from block 0) and [S] rejection flags.
extern "C" int sda_chacha_combine(const uint32_t* seeds, int S, long long d,
                                  unsigned long long m, unsigned long long mu,
                                  unsigned long long zone, int hi_first,
                                  long long* total, int* flags,
                                  cudaStream_t stream) {
  if (S < 0 || d < 0 || m == 0 || m >= (1ull << 62) || flags == nullptr)
    return (int)cudaErrorInvalidValue;
  if (d == 0) return (int)cudaSuccess;
  const long long nblocks = (d + 7) / 8;
  const Modulus md{m, mu, zone};
  const dim3 grid = grid_of(nblocks, 1);
  if (hi_first)
    chacha_combine_kernel<true><<<grid, kThreads, 0, stream>>>(
        seeds, S, d, nblocks, md, total, flags);
  else
    chacha_combine_kernel<false><<<grid, kThreads, 0, stream>>>(
        seeds, S, d, nblocks, md, total, flags);
  return (int)cudaGetLastError();
}
