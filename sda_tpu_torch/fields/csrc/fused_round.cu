// K1: fused mask + share + participant combine of one secure-aggregation
// round, for NVIDIA Hopper (sm_90a).
//
// Replaces sda_tpu/fields/pallas_round.py::fused_mask_share_combine (the
// Pallas kernel). It computes the same function: for each batch column b,
// fold the P participants' inputs, draw k mask and t share-randomness
// residues per participant (2 uint32 words each, residue
// (hi * 2^32 + lo) mod p), add the masks, and contract the n x (k+t) share
// matrix (its zero column dropped) with [sum values; sum randomness]. Out:
// shares [n, B] and mask totals [k, B], canonical residues as int64.
//
// What bounds it on this card: with external bits it reads
// P*(k + 2*draws)*B words once and writes (n+k)*B results, so it is
// bound by device-memory bytes. With internal randomness it draws
// P*2*draws*B words with Philox4x32-10 (4 words from 10 rounds of 2 wide
// multiplies, IMAD.WIDE on the FMA pipe, and 2 three-input xors, LOP3 on
// the ALU pipe: 10 integer instructions a word), which outweighs the
// P*k*B input words: it is bound by 32-bit integer operations.
//
// What the design does about it:
// - Blocks run in parallel on the 132 SMs, so nothing is carried between
//   them: each thread owns one column b and loops over all P participants
//   itself (the Pallas grid walked the participant axis in order over one
//   output block). No atomics, no second pass; reads along b are
//   coalesced across a warp.
// - Sums are linear, so the mod-p work leaves the participant loop:
//   the thread keeps raw uint64 sums of the input words and of the hi and
//   lo words of every drawn row (exact for any P < 2^32), and reduces once
//   per column, since sum_p (hi_p*2^32 + lo_p) = 2^32*sum hi + sum lo.
//   By the same linearity the share contraction runs once per column
//   after the fold (sum_p M v_p = M sum_p v_p). Every output is the
//   canonical residue, so it is bit-identical to the Pallas kernel for
//   any of its block or fold settings.
// - The matrix (at most 32 x 16 residues) travels by value in the kernel
//   arguments; the kernel allocates nothing.
// - Internal randomness is Philox4x32-10, counter (column, participant,
//   value-row pair), key = the 64-bit seed, so draws do not depend on the
//   launch shape. Ragged B is masked at the edge; no padding.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kMaxRows = 16;    // k + t: value rows per column
constexpr int kMaxShares = 32;  // n: clerks
constexpr int kThreads = 256;

struct ShareMatrix {
  // active share-matrix columns (column 0 multiplies the fixed zero and
  // is dropped), canonical residues, [n][k + t]
  uint32_t m[kMaxShares][kMaxRows];
};

// value row c of a column: rows [0, k) are the secrets (plus, when masked,
// mask draws), rows [k, k + t) the share randomness
template <int MAXR, bool kExternal>
__global__ void __launch_bounds__(kThreads)
fused_round_kernel(const uint32_t* __restrict__ x, long long sx_p,
                   long long sx_j, long long sx_b,
                   const uint32_t* __restrict__ bits,
                   long long* __restrict__ shares,
                   long long* __restrict__ mask_tot, int P, int k, int t,
                   int n, long long B, int masked, uint32_t key0,
                   uint32_t key1, unsigned long long p,
                   const ShareMatrix mat) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int rows = k + t;
  const int nmask = masked ? k : 0;
  const int draws = nmask + t;

  unsigned long long xs[MAXR], hs[MAXR], ls[MAXR];
#pragma unroll
  for (int c = 0; c < MAXR; ++c) {
    xs[c] = 0;
    hs[c] = 0;
    ls[c] = 0;
  }

  for (int q = 0; q < P; ++q) {
    const uint32_t* xq = x + q * sx_p + b * sx_b;
#pragma unroll
    for (int c = 0; c < MAXR; ++c) {
      if (c < k) xs[c] += xq[c * sx_j];
    }
    if (kExternal) {
      // the reference's draw layout: a draw of `g` residues starting at
      // residue g0 keeps its hi words in rows [2*g0, 2*g0 + g) and its lo
      // words in rows [2*g0 + g, 2*(g0 + g)); masks are the draw (0, k),
      // randomness the draw (nmask, t)
      const uint32_t* bq = bits + (long long)q * 2 * draws * B + b;
#pragma unroll
      for (int c = 0; c < MAXR; ++c) {
        if (c < nmask) {
          hs[c] += bq[(long long)c * B];
          ls[c] += bq[(long long)(k + c) * B];
        } else if (c >= k && c < rows) {
          const int i = c - k;
          hs[c] += bq[(long long)(2 * nmask + i) * B];
          ls[c] += bq[(long long)(2 * nmask + t + i) * B];
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < MAXR; c += 2) {
        const bool d0 = c < rows && (c >= k || c < nmask);
        const bool d1 = c + 1 < rows && (c + 1 >= k || c + 1 < nmask);
        if (d0 || d1) {
          uint32_t w0 = (uint32_t)b, w1 = (uint32_t)(b >> 32);
          uint32_t w2 = (uint32_t)q, w3 = (uint32_t)(c >> 1);
          philox4x32_10(w0, w1, w2, w3, key0, key1);
          if (d0) {
            hs[c] += w0;
            ls[c] += w1;
          }
          if (d1) {
            hs[c + 1] += w2;
            ls[c + 1] += w3;
          }
        }
      }
    }
  }

  // sum_p ((hi_p * 2^32 + lo_p) mod p) = (2^32 * sum hi + sum lo) mod p
  const unsigned long long c32 = (1ull << 32) % p;
  unsigned long long v[MAXR];
#pragma unroll
  for (int c = 0; c < MAXR; ++c) {
    const unsigned long long drawn = ((hs[c] % p) * c32 + ls[c] % p) % p;
    if (c < k) {
      const unsigned long long m = masked ? drawn : 0ull;
      mask_tot[c * B + b] = (long long)m;
      v[c] = (xs[c] % p + m) % p;
    } else {
      v[c] = c < rows ? drawn : 0ull;
    }
  }
  // products < p^2 < 2^58 and at most 16 of them: the sum fits uint64
  for (int i = 0; i < n; ++i) {
    unsigned long long acc = 0;
#pragma unroll
    for (int c = 0; c < MAXR; ++c) {
      if (c < rows) acc += (unsigned long long)mat.m[i][c] * v[c];
    }
    shares[i * B + b] = (long long)(acc % p);
  }
}

template <int MAXR>
void launch(bool external, dim3 grid, cudaStream_t stream, const uint32_t* x,
            long long sx_p, long long sx_j, long long sx_b,
            const uint32_t* bits, long long* shares, long long* mask_tot,
            int P, int k, int t, int n, long long B, int masked,
            uint32_t key0, uint32_t key1, unsigned long long p,
            const ShareMatrix& mat) {
  if (external) {
    fused_round_kernel<MAXR, true><<<grid, kThreads, 0, stream>>>(
        x, sx_p, sx_j, sx_b, bits, shares, mask_tot, P, k, t, n, B, masked,
        key0, key1, p, mat);
  } else {
    fused_round_kernel<MAXR, false><<<grid, kThreads, 0, stream>>>(
        x, sx_p, sx_j, sx_b, bits, shares, mask_tot, P, k, t, n, B, masked,
        key0, key1, p, mat);
  }
}

}  // namespace

// x: [P, k, B] 32-bit words at element strides (sx_p, sx_j, sx_b);
// bits: null (internal Philox) or contiguous [P, 2*draws, B] words;
// shares: [n, B] int64; mask_tot: [k, B] int64; matrix: host [n][k + t]
// canonical residues. Returns cudaGetLastError() after the launch.
extern "C" int sda_fused_mask_share_combine(
    const void* x, long long sx_p, long long sx_j, long long sx_b,
    const void* bits, void* shares, void* mask_tot, int P, int k, int t,
    int n, long long B, int masked, unsigned long long seed,
    unsigned long long p, const unsigned int* matrix, void* stream) {
  if (k < 1 || t < 0 || k + t > kMaxRows || n < 1 || n > kMaxShares ||
      P < 0 || B < 0 || p < 2) {
    return (int)cudaErrorInvalidValue;
  }
  ShareMatrix mat = {};
  for (int i = 0; i < n; ++i) {
    for (int c = 0; c < k + t; ++c) mat.m[i][c] = matrix[i * (k + t) + c];
  }
  if (B == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((B + kThreads - 1) / kThreads));
  const bool external = bits != nullptr;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xw = static_cast<const uint32_t*>(x);
  const auto* bw = static_cast<const uint32_t*>(bits);
  auto* sh = static_cast<long long*>(shares);
  auto* mt = static_cast<long long*>(mask_tot);
  const uint32_t key0 = (uint32_t)seed, key1 = (uint32_t)(seed >> 32);
  if (k + t <= 8) {
    launch<8>(external, grid, s, xw, sx_p, sx_j, sx_b, bw, sh, mt, P, k, t,
              n, B, masked, key0, key1, p, mat);
  } else {
    launch<16>(external, grid, s, xw, sx_p, sx_j, sx_b, bw, sh, mt, P, k, t,
               n, B, masked, key0, key1, p, mat);
  }
  return (int)cudaGetLastError();
}
