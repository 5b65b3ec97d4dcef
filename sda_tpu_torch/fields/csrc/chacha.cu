// K3: ChaCha20 seed masks for NVIDIA Hopper (sm_90a): the keystream, the
// expansion, the combine and the fused mask stage.
//
// Replaces sda_tpu/fields/chacha_jax.py (jnp, not Pallas: the JAX package
// runs it as XLA lanes on the TPU): chacha_block_words, _expand_no_reject,
// _combine_no_reject and the windowed CHACHA_PRG_V1 stream of
// stream_u64_at with FieldOps.from_u64 fused in; and the ChaCha branch of
// sda_tpu/mesh/simpod.py::_mask_stage (stream_u64_at -> from_u64 -> add
// and sum, one fused XLA pass there). Each ChaCha20 block (counter c, key
// = the seed's 8 words, nonce 0) yields 16 words, read as 8 u64 draws;
// draw i of a stream is draw i mod 8 of block counter0 + i / 8 (counters
// wrap mod 2^32). Two layouts: CHACHA_PRG_V1 takes word 2j as the low half
// of draw j, rand 0.3's stream (CHACHA_PRG_RAND03) takes it as the high
// half. Every draw is reduced to its canonical residue v mod m, m < 2^62,
// exactly (Barrett with the host's floor((2^64 - 1) / m)), and tested
// against the host spec's acceptance zone (v > zone means the host would
// have redrawn): a seed with such a draw among its first d is flagged, and
// the host replays it (sda_tpu_torch/fields/chacha_device.py).
//
// Operations:
// - blocks: [nblocks, 16] keystream words of one key;
// - expand: [S, d] residues of S streams from block counter0, and flags;
// - combine: [d] sum mod m of S streams from block 0, and flags;
// - mask: x [S, d] any int64 (d a multiple of 8) -> masked =
//   (x + w) mod m as int32 or int64, and mask_sum = sum_s w mod m [d],
//   where w is the V1 window of each seed from block counter0. One pass:
//   each element of x is read once and reduced mod m in registers (the
//   residue pass of the round's step folded in: raw_residue), each element
//   of masked written once; no [S, d] mask exists. Two options make it the
//   whole ChaCha part of the reference's jitted streamed step
//   (sda_tpu/mesh/streaming.py:482-512): the seeds' keys derived in the
//   kernel from the round seed (sda_tpu/mesh/simpod.py:192
//   _chacha_seed_words, here the port's Philox form: derive_keys), in
//   place of an [S, 8] tensor of them; and mask_sum added mod m into the
//   caller's [d] accumulator in place (the step's donated accumulate,
//   streaming.py:503-505), in place of a fresh vector.
//
// What bounds it on this card: integer operations. A block is 20 rounds
// of 4 quarter-rounds of 4 adds, 4 xors and 4 rotates, 960 operations,
// plus the feed-forward and, per draw, the reduction, the zone test and
// the accumulates; its 8 draws move 64 bytes of int64 at most (x read and
// masked written by the mask op: 96 or 128). The xors and rotates (LOP3,
// SHF.L.W) have only the ALU pipe, which binds; ptxas issues the adds on
// the FMA pipe (IMAD.IADD) by itself, and an explicit IMAD there was
// slower. The residue arithmetic after the block is what the ALU pipe
// carries beyond its 640: for m < 2^30 it runs in 32-bit words (Res<true>,
// unsigned min for each conditional subtract). See benchmarks/bounds.py.
//
// Design: one thread a ChaCha block (8 columns) of a column strip, its 16
// state words in registers, the 10 double rounds unrolled; the thread
// loops over a chunk of seeds. The seeds are split into chunks across
// gridDim.y so that the grid fills kWaves waves of resident blocks; the
// combine's and the mask's column sums stay in registers (a conditional
// subtract keeps each below m), chunk 0 writes them to the result and the
// others to a [chunks - 1, d] scratch that a second launch folds in chunk
// order, so the result needs no atomics. The keys of a block's seeds are
// staged in shared memory kKeyBatch seeds at a time (each key read once a
// block). A warp's 256 columns move through shared memory: the mask op's
// x rows arrive by 16-byte cp.async two seeds ahead in a 3-slot ring (the
// loads overlap the quarter-rounds), and every output row (expand, mask)
// is staged and leaves as coalesced 16-byte stores, consecutive lanes on
// consecutive addresses. Slots are XOR-swizzled so that a lane's 16-byte
// reads and writes of its own 8 columns hit distinct banks. Everything a
// warp stages is its own, so __syncwarp orders it; __syncthreads guards
// only the keys. The kernels allocate nothing; each C entry launches on
// the caller's stream and returns cudaGetLastError().

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;      // chacha_blocks_kernel, the fold
constexpr int kStrip = 128;        // the strip kernels: 4 warps a block
constexpr int kWarps = kStrip / 32;
constexpr int kStages = 3;         // the mask op's x ring: 2 seeds in flight
constexpr int kKeyBatch = 128;     // seeds whose keys a block stages at once
constexpr int kWaves = 4;          // waves of resident blocks a grid fills
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
  uint64_t fold;  // -2^63 mod m (the mask op's raw x)
};

// Residues mod m in 64-bit words (any m < 2^62) or, with SMALL, 32-bit
// ones (m < 2^30: the Solinas primes of the K1 lane and the flagship):
// fewer ALU-pipe instructions a draw than the ChaCha block's 640.
template <bool SMALL>
struct Res {
  using T = uint64_t;
  // v mod m, exact: q = floor(v * mu / 2^64) is at most 2 below v / m, so
  // v - q m < 3 m < 2^64 and two conditional subtracts canonicalise it.
  __device__ __forceinline__ static T reduce(uint64_t v, const Modulus& md) {
    T r = v - __umul64hi(v, md.mu) * md.m;
    r = r >= md.m ? r - md.m : r;
    return r >= md.m ? r - md.m : r;
  }
  // a + b mod m for canonical a, b (a + b < 2^63).
  __device__ __forceinline__ static T add(T a, T b, const Modulus& md) {
    const T s = a + b;
    return s >= md.m ? s - md.m : s;
  }
};

template <>
struct Res<true> {
  using T = uint32_t;
  // As above, in the low 32 bits: v - q m < 3 m < 2^32 is the same number
  // mod 2^32, so only q's and v's low words enter; min(r, r - m) is r mod
  // m for r < 2m (r - m wraps above r when r < m).
  __device__ __forceinline__ static T reduce(uint64_t v, const Modulus& md) {
    const T m = (T)md.m;
    T r = (T)v - (T)__umul64hi(v, md.mu) * m;
    r = min(r, r - m);
    return min(r, r - m);
  }
  __device__ __forceinline__ static T add(T a, T b, const Modulus& md) {
    const T s = a + b;  // < 2m < 2^31
    return min(s, s - (T)md.m);
  }
};

// The floor mod m of an int64 x given as its 64-bit word w (the mask op's
// raw input): w with its sign bit flipped is x + 2^63, in [0, 2^64), which
// the draws' reduction takes exactly; adding md.fold = -2^63 mod m gives
// x mod m. A fold of the sign by 2^63 costs one xor, where the 32-bit
// halves' form hi (2^32 mod m) + lo would still leave a 62-bit value to
// reduce.
template <bool SMALL>
__device__ __forceinline__ typename Res<SMALL>::T raw_residue(
    uint64_t w, const Modulus& md) {
  using R = Res<SMALL>;
  return R::add(R::reduce(w ^ (1ull << 63), md), (typename R::T)md.fold, md);
}

// The keys of seeds [s0, s0 + n), n <= kKeyBatch, into shared memory (two
// uint4 a seed), by the whole block.
__device__ __forceinline__ void stage_keys(const uint32_t* __restrict__ seeds,
                                           long long s0, int n, uint4* keys) {
  const uint4* src = reinterpret_cast<const uint4*>(seeds) + 2 * s0;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x)
    keys[i] = __ldg(src + i);
}

// The mask op's derived keys: seed s's 8 key words are Philox4x32-10 of
// counter (gid mod 2^32, gid >> 32, kSeedTag, pair) under the round seed's
// round keys, gid = pid_base + s, words 0-3 from pair 0 and 4-7 from pair
// 1, words from `words` on zero (the host's zero-padded key of
// ceil(seed_bitsize / 32) words). Twin: chacha_device.chacha_seed_words.
constexpr uint32_t kSeedTag = 0x5EED;

struct Derive {
  PhiloxKeys key;               // the round seed's round keys
  unsigned long long pid_base;  // global id of seed 0
  int words;                    // key words kept, 0..8
};

// The derived keys of seeds [s0, s0 + n), n <= kKeyBatch, into shared
// memory as stage_keys leaves them: one Philox block a uint4.
__device__ __forceinline__ void derive_keys(const Derive& dv, long long s0,
                                            int n, uint4* keys) {
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    const unsigned long long gid =
        dv.pid_base + (unsigned long long)(s0 + (i >> 1));
    const int pair = i & 1, w0 = 4 * pair;
    uint32_t c0 = (uint32_t)gid, c1 = (uint32_t)(gid >> 32), c2 = kSeedTag,
             c3 = (uint32_t)pair;
    philox4x32_10(c0, c1, c2, c3, dv.key);
    keys[i] = make_uint4(w0 < dv.words ? c0 : 0u, w0 + 1 < dv.words ? c1 : 0u,
                         w0 + 2 < dv.words ? c2 : 0u,
                         w0 + 3 < dv.words ? c3 : 0u);
  }
}

__device__ __forceinline__ void key_of(const uint4* keys, int i,
                                       uint32_t k[8]) {
  const uint4 a = keys[2 * i], b = keys[2 * i + 1];
  k[0] = a.x; k[1] = a.y; k[2] = a.z; k[3] = a.w;
  k[4] = b.x; k[5] = b.y; k[6] = b.z; k[7] = b.w;
}

// A warp stages its 256 columns as 16-byte slots: logical slot c holds
// int64 columns 2c, 2c + 1 (lane c / 4's block), or int32 columns 4c ..
// 4c + 3 (lane c / 2's). The swizzles put the slots a quarter-warp of
// lanes touches at once in distinct banks, whether each lane walks its own
// block's slots or consecutive lanes walk consecutive slots.
__device__ __forceinline__ int swz64(int c) {
  return (c & ~3) | ((c ^ (c >> 3)) & 3);
}
__device__ __forceinline__ int swz32(int c) {
  return (c & ~1) | ((c ^ (c >> 3)) & 1);
}

__device__ __forceinline__ uint4 pack64(uint64_t a, uint64_t b) {
  return make_uint4((uint32_t)a, (uint32_t)(a >> 32), (uint32_t)b,
                    (uint32_t)(b >> 32));
}
__device__ __forceinline__ uint64_t lo64(uint4 v) {
  return ((uint64_t)v.y << 32) | v.x;
}
__device__ __forceinline__ uint64_t hi64(uint4 v) {
  return ((uint64_t)v.w << 32) | v.z;
}

// cp.async of 16 bytes into shared memory, bypassing L1 (x is read once),
// and its group fences.
__device__ __forceinline__ void copy16(uint4* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A warp's staged int64 columns [col0, col0 + 256) of a row, those below
// d, to row[col0 ..]: 16-byte stores where the row is 16-byte aligned at
// col0, 8-byte ones otherwise (odd d), consecutive lanes on consecutive
// addresses either way.
__device__ __forceinline__ void store64(const uint4* st, long long* row,
                                        long long col0, long long d,
                                        int lane) {
  const long long left = d - col0;
  long long* dst = row + col0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      if (2 * c + 1 < left)
        *reinterpret_cast<uint4*>(dst + 2 * c) = st[swz64(c)];
      else if (2 * c < left)
        dst[2 * c] = (long long)lo64(st[swz64(c)]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = lane + 32 * q;
      if (e < left) {
        const uint4 v = st[swz64(e >> 1)];
        dst[e] = (long long)((e & 1) ? hi64(v) : lo64(v));
      }
    }
  }
}

// A block's ChaCha, reduced: r[j] = draw j mod m; returns whether one of
// the first `live` draws lies above the zone.
template <bool HI_FIRST, bool SMALL>
__device__ __forceinline__ bool residues(const uint32_t k[8],
                                         uint32_t counter, const Modulus& md,
                                         int live,
                                         typename Res<SMALL>::T r[8]) {
  uint32_t w[16];
  chacha_block(k, counter, w);
  bool rejected = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint64_t v = draw<HI_FIRST>(w, j);
    rejected |= j < live && v > md.zone;
    r[j] = Res<SMALL>::reduce(v, md);
  }
  return rejected;
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
// null: the windowed stream has no rejection). Block y of the grid's
// second dimension takes seeds [y * per, (y + 1) * per).
template <bool HI_FIRST, bool SMALL>
__global__ void __launch_bounds__(kStrip)
chacha_expand_kernel(const uint32_t* __restrict__ seeds, int S, int per,
                     uint32_t counter0, long long d, long long nblocks,
                     Modulus md, long long* __restrict__ out,
                     int* __restrict__ flags) {
  __shared__ uint4 keys[2 * kKeyBatch];
  __shared__ uint4 stage[kWarps][128];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long wb0 = (long long)blockIdx.x * kStrip + warp * 32;
  const long long b = wb0 + lane;
  const bool in = b < nblocks;
  const int live = !in ? 0 : (d - 8 * b < 8 ? (int)(d - 8 * b) : 8);
  const long long s0 = (long long)blockIdx.y * per;
  const int n = (int)min((long long)per, (long long)S - s0);
  uint4* st = stage[warp];
  for (int i0 = 0; i0 < n; i0 += kKeyBatch) {
    const int nb = min(kKeyBatch, n - i0);
    __syncthreads();
    stage_keys(seeds, s0 + i0, nb, keys);
    __syncthreads();
    for (int i = 0; i < nb; ++i) {
      const long long s = s0 + i0 + i;
      if (in) {
        uint32_t k[8];
        typename Res<SMALL>::T r[8];
        key_of(keys, i, k);
        if (residues<HI_FIRST, SMALL>(k, counter0 + (uint32_t)b, md, live,
                                      r) &&
            flags != nullptr)
          flags[s] = 1;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          st[swz64(4 * lane + q)] = pack64(r[2 * q], r[2 * q + 1]);
      }
      __syncwarp();
      store64(st, out + s * d, 8 * wb0, d, lane);
      __syncwarp();
    }
  }
}

// total[i] = sum over the S seeds of draw i of each stream (from block 0),
// mod m, for i < d; flags as above. One thread owns 8 columns; block y of
// the grid's second dimension sums seeds [y * per, (y + 1) * per) into
// total (y = 0) or partials row y - 1.
template <bool HI_FIRST, bool SMALL>
__global__ void __launch_bounds__(kStrip)
chacha_combine_kernel(const uint32_t* __restrict__ seeds, int S, int per,
                      long long d, long long nblocks, Modulus md,
                      long long* __restrict__ total,
                      long long* __restrict__ partials,
                      int* __restrict__ flags) {
  using R = Res<SMALL>;
  __shared__ uint4 keys[2 * kKeyBatch];
  const long long b = (long long)blockIdx.x * kStrip + threadIdx.x;
  const bool in = b < nblocks;
  const int live = !in ? 0 : (d - 8 * b < 8 ? (int)(d - 8 * b) : 8);
  const long long s0 = (long long)blockIdx.y * per;
  const int n = (int)min((long long)per, (long long)S - s0);
  typename R::T acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0;
  for (int i0 = 0; i0 < n; i0 += kKeyBatch) {
    const int nb = min(kKeyBatch, n - i0);
    __syncthreads();
    stage_keys(seeds, s0 + i0, nb, keys);
    __syncthreads();
    if (!in) continue;
    for (int i = 0; i < nb; ++i) {
      uint32_t k[8];
      typename R::T r[8];
      key_of(keys, i, k);
      if (residues<HI_FIRST, SMALL>(k, (uint32_t)b, md, live, r))
        flags[s0 + i0 + i] = 1;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = R::add(acc[j], r[j], md);
    }
  }
  if (!in) return;
  long long* dst = blockIdx.y == 0
                       ? total
                       : partials + (long long)(blockIdx.y - 1) * d;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < live) dst[8 * b + j] = (long long)acc[j];
}

// The mask op on a chunk of seeds (block y: seeds [y * per, (y + 1) *
// per)): out[s, i] = (x[s, i] mod m + w[s, i]) mod m as int32 (OUT32) or
// int64, and the chunk's mask sum into sums (y = 0) or partials row y - 1.
// d is a multiple of 8 (every block whole); x rows are x_stride apart and
// 16-byte aligned, and hold x_blocks blocks (<= d / 8): the columns past
// them read as zeros. With seeds null the keys are derived (dv); with
// `accumulate` chunk 0 adds its sum mod m to what sums holds.
template <bool OUT32, bool SMALL>
__global__ void __launch_bounds__(kStrip)
chacha_mask_kernel(const uint32_t* __restrict__ seeds, const Derive dv,
                   int S, int per, uint32_t counter0, long long d,
                   long long nblocks, Modulus md,
                   const long long* __restrict__ x, long long x_stride,
                   long long x_blocks, void* __restrict__ out,
                   long long* __restrict__ sums, int accumulate,
                   long long* __restrict__ partials) {
  using R = Res<SMALL>;
  constexpr int kOutSlots = OUT32 ? 64 : 128;
  __shared__ uint4 keys[2 * kKeyBatch];
  __shared__ uint4 ring[kWarps][kStages][128];
  __shared__ uint4 stage[kWarps][kOutSlots];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long wb0 = (long long)blockIdx.x * kStrip + warp * 32;
  const long long b = wb0 + lane;
  const bool in = b < nblocks;
  const long long col0 = 8 * wb0;
  const long long s0 = (long long)blockIdx.y * per;
  const int n = (int)min((long long)per, (long long)S - s0);
  // the warp's whole blocks inside the row: 4 x slots, 2 or 4 out slots each;
  // of them those inside x (a ragged tile's x ends at block x_blocks, and
  // its columns past that read as zeros)
  const int blocks = (int)max(0LL, min(32LL, nblocks - wb0));
  const int x_live = (int)max(0LL, min(32LL, x_blocks - wb0));
  const bool in_x = b < x_blocks;
  uint4* st = stage[warp];

  // seed i's x tile into ring slot i mod kStages (an empty group past n)
  auto fetch = [&](int i) {
    if (i < n) {
      const long long* src = x + (s0 + i) * x_stride + col0;
      uint4* dst = ring[warp][i % kStages];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q;
        if (c < 4 * x_live) copy16(dst + swz64(c), src + 2 * c);
      }
    }
    copy_commit();
  };
  fetch(0);
  fetch(1);
  typename R::T acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0;
  for (int i = 0; i < n; ++i) {
    if (i % kKeyBatch == 0) {
      __syncthreads();
      if (seeds != nullptr)
        stage_keys(seeds, s0 + i, min(kKeyBatch, n - i), keys);
      else
        derive_keys(dv, s0 + i, min(kKeyBatch, n - i), keys);
      __syncthreads();
    }
    copy_wait<1>();  // seed i's tile has landed (this lane's copies) ...
    __syncwarp();    // ... and every lane's; slot (i - 1) mod 3 is free
    fetch(i + 2);
    const long long s = s0 + i;
    if (in) {
      uint32_t k[8];
      typename R::T r[8], v[8];
      key_of(keys, i % kKeyBatch, k);
      residues<false, SMALL>(k, counter0 + (uint32_t)b, md, 0, r);
      const uint4* xt = ring[warp][i % kStages];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (in_x) {
          const uint4 t = xt[swz64(4 * lane + q)];
          v[2 * q] = raw_residue<SMALL>(lo64(t), md);
          v[2 * q + 1] = raw_residue<SMALL>(hi64(t), md);
        } else {
          v[2 * q] = v[2 * q + 1] = 0;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j] = R::add(acc[j], r[j], md);
        v[j] = R::add(v[j], r[j], md);
      }
      if (OUT32) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          st[swz32(2 * lane + q)] =
              make_uint4((uint32_t)v[4 * q], (uint32_t)v[4 * q + 1],
                         (uint32_t)v[4 * q + 2], (uint32_t)v[4 * q + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          st[swz64(4 * lane + q)] = pack64(v[2 * q], v[2 * q + 1]);
      }
    }
    __syncwarp();
    if (OUT32) {
      uint4* row = reinterpret_cast<uint4*>(
          static_cast<int32_t*>(out) + s * d + col0);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = lane + 32 * q;
        if (c < 2 * blocks) row[c] = st[swz32(c)];
      }
    } else {
      uint4* row = reinterpret_cast<uint4*>(
          static_cast<long long*>(out) + s * d + col0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q;
        if (c < 4 * blocks) row[c] = st[swz64(c)];
      }
    }
  }
  copy_wait<0>();
  if (!in) return;
  if (blockIdx.y == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      typename R::T v = acc[j];
      if (accumulate)
        v = R::add(R::reduce((uint64_t)sums[8 * b + j], md), v, md);
      sums[8 * b + j] = (long long)v;
    }
    return;
  }
  long long* dst = partials + (long long)(blockIdx.y - 1) * d;
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[8 * b + j] = (long long)acc[j];
}

// total[i] = (total[i] + partials[0, i] + ... + partials[rows - 1, i])
// mod m, in row order.
__global__ void __launch_bounds__(kThreads)
chacha_fold_kernel(const long long* __restrict__ partials, int rows,
                   long long d, Modulus md, long long* __restrict__ total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d) return;
  uint64_t acc = (uint64_t)total[i];
  for (int r = 0; r < rows; ++r)
    acc = Res<false>::add(acc, (uint64_t)partials[r * d + i], md);
  total[i] = (long long)acc;
}

enum Op { kExpand = 0, kCombine = 1, kMask32 = 2, kMask64 = 3 };

// Whether m takes the 32-bit residues (Res<true>).
bool small(uint64_t m) { return m < (1ull << 30); }

template <class Kernel>
cudaError_t resident(int* per_sm, Kernel kernel) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kStrip,
                                                       0);
}

// Resident blocks an SM of op's kernel for modulus m (the V1 layout's).
cudaError_t resident_blocks(int op, uint64_t m, int* per_sm) {
  const bool sm = small(m);
  switch (op) {
    case kExpand:
      return sm ? resident(per_sm, chacha_expand_kernel<false, true>)
                : resident(per_sm, chacha_expand_kernel<false, false>);
    case kCombine:
      return sm ? resident(per_sm, chacha_combine_kernel<false, true>)
                : resident(per_sm, chacha_combine_kernel<false, false>);
    case kMask32:
      return sm ? resident(per_sm, chacha_mask_kernel<true, true>)
                : resident(per_sm, chacha_mask_kernel<true, false>);
    default:
      return sm ? resident(per_sm, chacha_mask_kernel<false, true>)
                : resident(per_sm, chacha_mask_kernel<false, false>);
  }
}

// Chunks of seeds for `op` on S seeds of nblocks blocks mod m: enough to
// fill kWaves waves of resident blocks on the current device, at most S
// and kMaxGridY. 0 on a CUDA error.
int plan(int op, int S, long long nblocks, uint64_t m) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = resident_blocks(op, m, &per_sm);
  if (e != cudaSuccess) return 0;
  const long long grid_x = (nblocks + kStrip - 1) / kStrip;
  long long chunks = ((long long)kWaves * per_sm * sms + grid_x - 1) / grid_x;
  chunks = chunks < S ? chunks : S;
  chunks = chunks < (long long)kMaxGridY ? chunks : (long long)kMaxGridY;
  return chunks < 1 ? 1 : (int)chunks;
}

// The grid of a strip kernel over `chunks` chunks of S seeds, and the
// seeds a chunk (the last may hold fewer; none is empty).
dim3 strip_grid(long long nblocks, int S, int chunks, int* per) {
  *per = (S + chunks - 1) / chunks;
  return dim3((unsigned)((nblocks + kStrip - 1) / kStrip),
              (unsigned)((S + *per - 1) / *per));
}

// f(A, B) with A, B std::true_type or std::false_type as a and b are: a
// kernel instance chosen at run time.
template <class F>
void dispatch(bool a, bool b, F f) {
  using Y = std::true_type;
  using N = std::false_type;
  if (a) {
    if (b) f(Y{}, Y{}); else f(Y{}, N{});
  } else {
    if (b) f(N{}, Y{}); else f(N{}, N{});
  }
}

int fold(const dim3& grid, const long long* partials, long long d,
         const Modulus& md, long long* total, cudaStream_t stream) {
  if (grid.y > 1)
    chacha_fold_kernel<<<(unsigned)((d + kThreads - 1) / kThreads), kThreads,
                         0, stream>>>(partials, (int)grid.y - 1, d, md, total);
  return (int)cudaGetLastError();
}

}  // namespace

// Chunks of seeds the combine (op 1) and the mask op (2: int32 out, 3:
// int64) split S seeds of width d mod m into on the current device: the
// caller allocates their [chunks - 1, d] int64 scratch. Op 0: the
// expand's.
extern "C" int sda_chacha_chunks(int op, int S, long long d,
                                 unsigned long long m, int* chunks) {
  if (op < kExpand || op > kMask64 || S < 0 || d < 0 || m == 0 ||
      chunks == nullptr)
    return (int)cudaErrorInvalidValue;
  *chunks = S == 0 || d == 0 ? 1 : plan(op, S, (d + 7) / 8, m);
  return *chunks == 0 ? (int)cudaGetLastError() : (int)cudaSuccess;
}

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
  chacha_blocks_kernel<<<(unsigned)((nblocks + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(k, counter0, nblocks, out);
  return (int)cudaGetLastError();
}

// [S, d] residues of S streams from block counter0, and rejection flags
// (null for none). seeds: [S, 8] words on the device, 16-byte aligned.
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
  const int chunks = plan(kExpand, S, nblocks, m);
  if (chunks == 0) return (int)cudaGetLastError();
  int per = 0;
  const dim3 grid = strip_grid(nblocks, S, chunks, &per);
  const Modulus md{m, mu, zone};
  dispatch(hi_first, small(m), [&](auto hi, auto sm) {
    chacha_expand_kernel<decltype(hi)::value, decltype(sm)::value>
        <<<grid, kStrip, 0, stream>>>(seeds, S, per, counter0, d, nblocks, md,
                                      out, flags);
  });
  return (int)cudaGetLastError();
}

// [d] sum mod m of S streams (from block 0) and [S] rejection flags, in
// `chunks` chunks of seeds (sda_chacha_chunks) whose partial sums go to
// partials [chunks - 1, d] (null when chunks is 1).
extern "C" int sda_chacha_combine(const uint32_t* seeds, int S, long long d,
                                  unsigned long long m, unsigned long long mu,
                                  unsigned long long zone, int hi_first,
                                  long long* total, int* flags, int chunks,
                                  long long* partials, cudaStream_t stream) {
  if (S < 0 || d < 0 || m == 0 || m >= (1ull << 62) || flags == nullptr ||
      chunks < 1 || (chunks > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  if (d == 0) return (int)cudaSuccess;
  if (S == 0)
    return (int)cudaMemsetAsync(total, 0, d * sizeof(long long), stream);
  const long long nblocks = (d + 7) / 8;
  int per = 0;
  const dim3 grid = strip_grid(nblocks, S, chunks, &per);
  const Modulus md{m, mu, zone};
  dispatch(hi_first, small(m), [&](auto hi, auto sm) {
    chacha_combine_kernel<decltype(hi)::value, decltype(sm)::value>
        <<<grid, kStrip, 0, stream>>>(seeds, S, per, d, nblocks, md, total,
                                      partials, flags);
  });
  const int err = (int)cudaGetLastError();
  return err != 0 ? err : fold(grid, partials, d, md, total, stream);
}

// The mask op: out [S, d] (int32 when out32, which needs m < 2^31, else
// int64) = (x + w) mod m and sums [d] = sum_s w mod m (with accumulate:
// sums = (sums + sum_s w) mod m, in place), w the V1 window of each seed
// from block counter0; d a multiple of 8; x [S, x_cols] any int64 (its
// floor mod m taken in the kernel; x_cols <= d, a multiple of 8, and the
// columns from x_cols to d read as zeros: a ragged tile's padding), rows
// x_stride int64 apart and 16-byte aligned; `chunks` and partials as for
// the combine. The seeds' keys are
// the [S, 8] words `seeds` or, with seeds null, derived in the kernel:
// derive_keys under the host [2][10] round keys `round_keys` of the round
// seed (chacha_device.py), gid = pid_base + s, `words` key words kept.
extern "C" int sda_chacha_mask_into(
    const uint32_t* seeds, const unsigned int* round_keys,
    unsigned long long pid_base, int words, int S, uint32_t counter0,
    long long d, unsigned long long m, unsigned long long mu,
    const long long* x, long long x_stride, long long x_cols, int out32,
    void* out, long long* sums, int accumulate, int chunks,
    long long* partials, cudaStream_t stream) {
  if (S < 0 || d < 0 || d % 8 || m == 0 || m >= (1ull << 62) ||
      (out32 && m >= (1ull << 31)) || x_cols < 0 || x_cols > d ||
      x_cols % 8 || x_stride < x_cols || x_stride % 2 ||
      (reinterpret_cast<uintptr_t>(x) & 15) || chunks < 1 ||
      (chunks > 1 && partials == nullptr) ||
      (S > 0 && (seeds == nullptr) == (round_keys == nullptr)) ||
      words < 0 || words > 8 ||
      pid_base > (1ull << 63) - 1 - (unsigned long long)S)
    return (int)cudaErrorInvalidValue;
  if (d == 0 || (S == 0 && accumulate)) return (int)cudaSuccess;
  if (S == 0)
    return (int)cudaMemsetAsync(sums, 0, d * sizeof(long long), stream);
  Derive dv = {};
  if (round_keys != nullptr) {
    for (int r = 0; r < kPhiloxRounds; ++r) {
      dv.key.k0[r] = round_keys[r];
      dv.key.k1[r] = round_keys[kPhiloxRounds + r];
    }
    dv.pid_base = pid_base;
    dv.words = words;
  }
  const long long nblocks = d / 8;
  int per = 0;
  const dim3 grid = strip_grid(nblocks, S, chunks, &per);
  const Modulus md{m, mu, ~0ull, (m - (1ull << 63) % m) % m};
  dispatch(out32, small(m), [&](auto o32, auto sm) {
    chacha_mask_kernel<decltype(o32)::value, decltype(sm)::value>
        <<<grid, kStrip, 0, stream>>>(seeds, dv, S, per, counter0, d,
                                      nblocks, md, x, x_stride,
                                      x_cols / 8, out, sums, accumulate,
                                      partials);
  });
  const int err = (int)cudaGetLastError();
  return err != 0 ? err : fold(grid, partials, d, md, sums, stream);
}

// The mask op on given seeds, fresh sums: sda_chacha_mask_into's first
// interface (the A/B tools bind it on older builds too).
extern "C" int sda_chacha_mask(const uint32_t* seeds, int S,
                               uint32_t counter0, long long d,
                               unsigned long long m, unsigned long long mu,
                               const long long* x, long long x_stride,
                               int out32, void* out, long long* sums,
                               int chunks, long long* partials,
                               cudaStream_t stream) {
  return sda_chacha_mask_into(seeds, nullptr, 0, 8, S, counter0, d, m, mu, x,
                              x_stride, d, out32, out, sums, 0, chunks,
                              partials, stream);
}
