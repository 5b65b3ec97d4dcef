// K4: batched Montgomery multiplication and the Paillier premix fold, for
// NVIDIA Hopper (sm_90a).
//
// Replaces sda_tpu/crypto/paillier_tpu.py (jnp, not Pallas: the JAX package
// runs it as XLA lanes on the TPU): MontgomeryContext.mont_mul_fn and the
// fold of premix_fn. One call computes, for `pairs` x `lanes` independent
// operand pairs, out = a * b * R^-1 mod m, fully reduced to [0, m), with m
// odd, L = ceil(bits(m) / 32) limbs of 32 bits and R = 2^(32 L). The
// premix (sda_tpu_torch/crypto/paillier_tpu.py) folds P rows of ciphertexts
// as a tree, one launch a level, pair k of a level multiplying rows 2k and
// 2k + 1; one last launch multiplies by R^count mod m, which undoes the
// R^-(count - 1) of the count - 1 montmuls (any fold order gives the same
// product mod m).
//
// Layout: limb-major. An operand row is [L, lanes] uint32 (limb j of lane
// x at j * lanes + x), so the 32 lanes of a warp read one limb of 32
// neighbouring operands as one 128-byte line. `b` may instead be one [L]
// constant for every lane (b_lane = 0, b_limb = 1): the fold's fix-up.
//
// What bounds it on this card: integer operations. CIOS takes 2 L^2 + L
// 32x32 -> 64-bit multiplies a montmul (32,896 at L = 128), against 8 L
// bytes of operands read and 4 L written. See benchmarks/bounds.py
// (k4_bound).
//
// Design (first version, not tuned): one thread a montmul, coarse-grained
// CIOS with 64-bit accumulators. For L in {32, 64, 128} (512-, 1024- and
// 2048-bit Paillier keys: n^2 of 1024, 2048 and 4096 bits) the limb loops
// are unrolled, so the L + 2 words of the accumulator stay in registers.
// The modulus limbs and n' = -m^-1 mod 2^32 travel in the kernel's
// parameters (constant bank): an unrolled loop reads each as an operand of
// its multiply, with no load. Each thread first copies operand a's L limbs
// into its own column of shared memory (32 KB a 64-thread block at
// L = 128), where the inner loop reads them at fixed offsets with no
// address arithmetic and no bank conflict; b's limb is read once an outer
// step. No thread reads another's column, so there is no barrier.
//
// Every other L, of any size (a 3072-bit key's n^2 has L = 192), runs the
// wide instance: the modulus is read from device memory and the
// accumulator lives in a caller's workspace of L + 2 words a thread,
// limb-major ([L + 2, threads]) so a warp's accesses coalesce; a
// grid-stride loop bounds the threads, and with them the workspace. The
// kernels allocate nothing; the C entries launch on the caller's stream
// and return cudaGetLastError().

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLimbs = 128;
constexpr int kThreads = 64;

struct Modulus {
  uint32_t m[kMaxLimbs];
  uint32_t n_prime;
  int limbs;
};

template <int L>
__global__ void __launch_bounds__(kThreads)
montmul_kernel(const uint32_t* __restrict__ a, long long a_pair,
               const uint32_t* __restrict__ b, long long b_pair,
               long long b_limb, long long b_lane,
               uint32_t* __restrict__ out, long long out_pair,
               long long lanes, long long pairs, const Modulus md) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= pairs * lanes) return;
  const long long k = g / lanes;
  const long long x = g - k * lanes;
  const uint32_t* ap = a + k * a_pair + x;
  const uint32_t* bp = b + k * b_pair + x * b_lane;
  uint32_t* op = out + k * out_pair + x;

  // limb j of this thread's a at sa[j * kThreads]
  __shared__ uint32_t sa_block[L * kThreads];
  uint32_t* sa = sa_block + threadIdx.x;
  for (int j = 0; j < L; ++j) sa[j * kThreads] = ap[j * lanes];

  uint32_t t[L + 2];
#pragma unroll
  for (int j = 0; j < L + 2; ++j) t[j] = 0;

#pragma unroll 1
  for (int i = 0; i < L; ++i) {
    // t += a * b_i
    const uint64_t bi = bp[i * b_limb];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t s = (uint64_t)sa[j * kThreads] * bi + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[L] + c;
    t[L] = (uint32_t)s;
    t[L + 1] = (uint32_t)(s >> 32);
    // t = (t + q m) / 2^32, q chosen so the low word cancels
    const uint32_t q = t[0] * md.n_prime;
    s = (uint64_t)q * md.m[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      s = (uint64_t)q * md.m[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[L] + c;
    t[L - 1] = (uint32_t)s;
    t[L] = t[L + 1] + (uint32_t)(s >> 32);
  }

  // t < 2m: subtract m once when t >= m (t[L] set, or no borrow below it)
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t d = (uint64_t)t[j] - md.m[j] - borrow;
    borrow = (uint32_t)(d >> 63);
  }
  const uint32_t mask = (t[L] != 0 || borrow == 0) ? 0xFFFFFFFFu : 0u;
  borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t d = (uint64_t)t[j] - (md.m[j] & mask) - borrow;
    op[j * lanes] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
}

// The same montmul for any L, in `threads` threads that stride over the
// pairs x lanes operands; m is L words of device memory and work holds
// (L + 2) x threads words.
__global__ void __launch_bounds__(kThreads)
montmul_wide(const uint32_t* __restrict__ a, long long a_pair,
             const uint32_t* __restrict__ b, long long b_pair,
             long long b_limb, long long b_lane, uint32_t* __restrict__ out,
             long long out_pair, long long lanes, long long pairs,
             const uint32_t* __restrict__ m, int L, uint32_t n_prime,
             uint32_t* __restrict__ work, long long threads) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (tid >= threads) return;
  uint32_t* t = work + tid;  // accumulator word j at t[j * threads]
  const long long ts = threads;
  for (long long g = tid; g < pairs * lanes; g += threads) {
    const long long k = g / lanes;
    const long long x = g - k * lanes;
    const uint32_t* ap = a + k * a_pair + x;
    const uint32_t* bp = b + k * b_pair + x * b_lane;
    for (int j = 0; j < L + 2; ++j) t[j * ts] = 0;
    for (int i = 0; i < L; ++i) {
      const uint64_t bi = bp[i * b_limb];
      uint64_t c = 0;
      for (int j = 0; j < L; ++j) {
        const uint64_t s = (uint64_t)ap[j * lanes] * bi + t[j * ts] + c;
        t[j * ts] = (uint32_t)s;
        c = s >> 32;
      }
      uint64_t s = (uint64_t)t[L * ts] + c;
      t[L * ts] = (uint32_t)s;
      t[(L + 1) * ts] = (uint32_t)(s >> 32);
      const uint32_t q = t[0] * n_prime;
      s = (uint64_t)q * m[0] + t[0];
      c = s >> 32;
      for (int j = 1; j < L; ++j) {
        s = (uint64_t)q * m[j] + t[j * ts] + c;
        t[(j - 1) * ts] = (uint32_t)s;
        c = s >> 32;
      }
      s = (uint64_t)t[L * ts] + c;
      t[(L - 1) * ts] = (uint32_t)s;
      t[L * ts] = t[(L + 1) * ts] + (uint32_t)(s >> 32);
    }
    uint32_t* op = out + k * out_pair + x;
    uint32_t borrow = 0;  // as in montmul_kernel
    for (int j = 0; j < L; ++j) {
      const uint64_t d = (uint64_t)t[j * ts] - m[j] - borrow;
      borrow = (uint32_t)(d >> 63);
    }
    const uint32_t mask =
        (t[L * ts] != 0 || borrow == 0) ? 0xFFFFFFFFu : 0u;
    borrow = 0;
    for (int j = 0; j < L; ++j) {
      const uint64_t d = (uint64_t)t[j * ts] - (m[j] & mask) - borrow;
      op[j * lanes] = (uint32_t)d;
      borrow = (uint32_t)(d >> 63);
    }
  }
}

template <int L>
cudaError_t launch(const uint32_t* a, long long a_pair, const uint32_t* b,
                   long long b_pair, long long b_limb, long long b_lane,
                   uint32_t* out, long long out_pair, long long lanes,
                   long long pairs, const Modulus& md, cudaStream_t stream) {
  const long long n = pairs * lanes;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  montmul_kernel<L><<<(unsigned)blocks, kThreads, 0, stream>>>(
      a, a_pair, b, b_pair, b_limb, b_lane, out, out_pair, lanes, pairs, md);
  return cudaGetLastError();
}

}  // namespace

// out[k] = a[k] * b[k] * R^-1 mod m for k < pairs, each a [limbs, lanes]
// limb-major block: a's row k at a + k * a_pair, out's at out + k * out_pair,
// b's limb i of lane x at b + k * b_pair + i * b_limb + x * b_lane.
// `m` (host memory, `limbs` words, least significant first) must be odd and
// every operand below it. Strides are in uint32 words. Takes limbs in
// {32, 64, 128}; sda_montmul_wide takes any other.
extern "C" int sda_montmul(const uint32_t* a, long long a_pair,
                           const uint32_t* b, long long b_pair,
                           long long b_limb, long long b_lane, uint32_t* out,
                           long long out_pair, long long lanes,
                           long long pairs, const uint32_t* m, int limbs,
                           uint32_t n_prime, void* stream) {
  if ((limbs != 32 && limbs != 64 && limbs != 128) || lanes < 0 ||
      pairs < 0 || m == nullptr || (m[0] & 1u) == 0)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0 || pairs == 0) return (int)cudaSuccess;
  Modulus md;
  std::memset(&md, 0, sizeof(md));
  std::memcpy(md.m, m, sizeof(uint32_t) * limbs);
  md.n_prime = n_prime;
  md.limbs = limbs;
  cudaStream_t s = (cudaStream_t)stream;
  switch (limbs) {
    case 32:
      return (int)launch<32>(a, a_pair, b, b_pair, b_limb, b_lane, out,
                             out_pair, lanes, pairs, md, s);
    case 64:
      return (int)launch<64>(a, a_pair, b, b_pair, b_limb, b_lane, out,
                             out_pair, lanes, pairs, md, s);
    default:
      return (int)launch<128>(a, a_pair, b, b_pair, b_limb, b_lane, out,
                              out_pair, lanes, pairs, md, s);
  }
}

// sda_montmul for any limbs >= 1, with `m` in DEVICE memory (odd, below
// 2^(32 limbs)) and `work` a device workspace of (limbs + 2) * threads
// words; threads >= 1 stride over the pairs x lanes montmuls.
extern "C" int sda_montmul_wide(const uint32_t* a, long long a_pair,
                                const uint32_t* b, long long b_pair,
                                long long b_limb, long long b_lane,
                                uint32_t* out, long long out_pair,
                                long long lanes, long long pairs,
                                const uint32_t* m, int limbs,
                                uint32_t n_prime, uint32_t* work,
                                long long threads, void* stream) {
  if (limbs < 1 || lanes < 0 || pairs < 0 || threads < 1 || m == nullptr ||
      work == nullptr)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0 || pairs == 0) return (int)cudaSuccess;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  montmul_wide<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, a_pair, b, b_pair, b_limb, b_lane, out, out_pair, lanes, pairs, m,
      limbs, n_prime, work, threads);
  return (int)cudaGetLastError();
}
