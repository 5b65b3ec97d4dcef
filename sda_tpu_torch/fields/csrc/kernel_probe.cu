// K5: the kernel probe, component variants of K1 (fused_round.cu), for
// NVIDIA Hopper (sm_90a).
//
// Replaces benchmarks/kernel_probe.py::probe_call (the Pallas probe). It
// computes what that function computes: K1's round with each component
// switched on or off, so that the variants' times split K1's time into
// fold, draws, contraction and overhead (solve_budget):
//   DO_X       read and fold the P participants' input words x [P, k, B];
//   DO_PRNG    draw k mask and t share-randomness residues per participant
//              and column (Philox4x32-10, K1's masked internal counter
//              (column, participant, value-row pair) and key = seed);
//   DO_MATMUL  contract the n x (k+t) share matrix (its zero column
//              dropped) with the folded value rows, once per column.
// Output [n, B] int64 canonical residues:
// - With the contraction: K1's shares. Value rows [0, k) are the inputs
//   plus the masks, rows [k, k+t) the randomness; without draws the
//   randomness rows repeat the value rows (row k+i is row i mod k), as the
//   Pallas probe contracts them. With the same seed, DO_X + DO_PRNG +
//   DO_MATMUL gives K1's shares (masked, internal draws) bit for bit.
// - Without it: rows [0, k) hold the value fold, the other rows zero, with
//   one difference from the Pallas probe: with draws, rows [k, k+t) hold
//   the sums of the randomness residues. The Pallas probe leaves them zero
//   and relies on the TPU PRNG being stateful. Here draws whose sums are
//   never stored are removed by the compiler (a store behind a run-time
//   flag does not help: the draws sink into its branch), so the draw-only
//   variants would time a fraction of the Philox work.
//
// SPLIT is the counterpart of the Pallas probe's tree=True. There the tree
// filled idle sublanes, which has no meaning here; the question on this
// card is whether one thread per column, folding all P alone, is the right
// shape for K1. With SPLIT a column gets kGroup threads of a block: thread g
// folds the participants q = g (mod kGroup) into raw uint64 partials, a
// shared-memory halving tree sums them, and one thread runs the epilogue.
// Raw uint64 sums are exact and order-free for P < 2^32, so the output is
// bit-identical to one thread a column.
//
// What bounds it on this card: the fold alone reads P*k*B words once and is
// bound by device-memory bytes; every variant with draws is bound by 32-bit
// integer operations (Philox: 10 instructions a word), as K1 is. The
// structure is K1's (one column a thread, raw uint64 sums in the
// participant loop, one reduction and one contraction a column), so the
// component times subtract cleanly. The participant loop is kept rolled
// (#pragma unroll 1), as the compiler leaves K1's, so each variant's loop
// is one participant's work.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kMaxRows = 16;    // k + t: value rows per column
constexpr int kMaxShares = 32;  // n: clerks
constexpr int kThreads = 256;
constexpr int kGroup = 4;       // threads a column under SPLIT

struct ShareMatrix {
  // active share-matrix columns, canonical residues, [n][k + t]
  uint32_t m[kMaxShares][kMaxRows];
};

struct ProbeArgs {
  const uint32_t* x;             // [P, k, B] words at element strides
  long long sx_p, sx_j, sx_b;
  long long* out;                // [n, B] int64
  int P, k, t, n;
  long long B;
  uint32_t key0, key1;
  unsigned long long p;
  ShareMatrix mat;
};

template <int MAXR, bool DO_X, bool DO_PRNG, bool DO_MATMUL, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const ProbeArgs a) {
  constexpr int G = SPLIT ? kGroup : 1;
  constexpr int kCols = kThreads / G;
  const long long b = blockIdx.x * (long long)kCols + threadIdx.x;
  const int g = SPLIT ? (int)threadIdx.y : 0;
  // under SPLIT every thread of the block reaches the tree's barriers
  if (!SPLIT && b >= a.B) return;
  const bool active = b < a.B;
  const int k = a.k;
  const int rows = a.k + a.t;

  unsigned long long xs[MAXR], hs[MAXR], ls[MAXR];
#pragma unroll
  for (int c = 0; c < MAXR; ++c) {
    xs[c] = 0;
    hs[c] = 0;
    ls[c] = 0;
  }

  if (active) {
#pragma unroll 1
    for (int q = g; q < a.P; q += G) {
      if (DO_X) {
        const uint32_t* xq = a.x + q * a.sx_p + b * a.sx_b;
#pragma unroll
        for (int c = 0; c < MAXR; ++c) {
          if (c < k) xs[c] += xq[c * a.sx_j];
        }
      }
      if (DO_PRNG) {
#pragma unroll
        for (int c = 0; c < MAXR; c += 2) {
          if (c < rows) {
            uint32_t w0 = (uint32_t)b, w1 = (uint32_t)(b >> 32);
            uint32_t w2 = (uint32_t)q, w3 = (uint32_t)(c >> 1);
            philox4x32_10(w0, w1, w2, w3, a.key0, a.key1);
            hs[c] += w0;
            ls[c] += w1;
            if (c + 1 < rows) {
              hs[c + 1] += w2;
              ls[c + 1] += w3;
            }
          }
        }
      }
    }
  }

  if (SPLIT) {
    // partials in [slot][g][column]: xs[c] in slot c, hs[c] in kx + c,
    // ls[c] in kx + rows + c
    extern __shared__ unsigned long long part[];
    const int tid = g * kCols + (int)threadIdx.x;
    const int kx = DO_X ? k : 0;
#pragma unroll
    for (int c = 0; c < MAXR; ++c) {
      if (DO_X && c < k) part[c * kThreads + tid] = xs[c];
      if (DO_PRNG && c < rows) {
        part[(kx + c) * kThreads + tid] = hs[c];
        part[(kx + rows + c) * kThreads + tid] = ls[c];
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = G / 2; h >= 1; h /= 2) {
      if (g < h) {
        const int up = tid + h * kCols;
#pragma unroll
        for (int c = 0; c < MAXR; ++c) {
          if (DO_X && c < k) {
            xs[c] += part[c * kThreads + up];
            part[c * kThreads + tid] = xs[c];
          }
          if (DO_PRNG && c < rows) {
            hs[c] += part[(kx + c) * kThreads + up];
            ls[c] += part[(kx + rows + c) * kThreads + up];
            part[(kx + c) * kThreads + tid] = hs[c];
            part[(kx + rows + c) * kThreads + tid] = ls[c];
          }
        }
      }
      __syncthreads();
    }
    if (g != 0 || !active) return;
  }

  // sum_p ((hi_p * 2^32 + lo_p) mod p) = (2^32 * sum hi + sum lo) mod p
  const unsigned long long p = a.p;
  const unsigned long long c32 = (1ull << 32) % p;
  unsigned long long v[MAXR];
#pragma unroll
  for (int c = 0; c < MAXR; ++c) {
    unsigned long long drawn = 0;
    if (DO_PRNG) drawn = ((hs[c] % p) * c32 + ls[c] % p) % p;
    if (c < k) {
      v[c] = ((DO_X ? xs[c] % p : 0ull) + drawn) % p;
    } else {
      v[c] = c < rows ? drawn : 0ull;
    }
  }
  long long* out = a.out;
  const long long B = a.B;
  if (DO_MATMUL) {
    if (!DO_PRNG) {
      // no draws: randomness row c repeats value row c - k
#pragma unroll
      for (int c = 1; c < MAXR; ++c) {
        unsigned long long r = 0;
#pragma unroll
        for (int j = 0; j < c; ++j) {
          if (j + k == c) r = v[j];
        }
        if (c >= k && c < rows) v[c] = r;
      }
    }
    // products < p^2 < 2^58 and at most 16 of them: the sum fits uint64
    for (int i = 0; i < a.n; ++i) {
      unsigned long long acc = 0;
#pragma unroll
      for (int c = 0; c < MAXR; ++c) {
        if (c < rows) acc += (unsigned long long)a.mat.m[i][c] * v[c];
      }
      out[i * B + b] = (long long)(acc % p);
    }
  } else {
    const int stored = DO_PRNG ? rows : k;
#pragma unroll
    for (int i = 0; i < MAXR; ++i) {
      if (i < a.n) out[i * B + b] = i < stored ? (long long)v[i] : 0ll;
    }
#pragma unroll
    for (int i = MAXR; i < kMaxShares; ++i) {
      if (i < a.n) out[i * B + b] = 0ll;
    }
  }
}

template <int MAXR, bool DX, bool DP, bool DM, bool SPLIT>
int launch(const ProbeArgs& a, cudaStream_t stream) {
  constexpr int G = SPLIT ? kGroup : 1;
  const dim3 block(kThreads / G, G);
  const dim3 grid((unsigned)((a.B + block.x - 1) / block.x));
  const int slots = (DX ? a.k : 0) + (DP ? 2 * (a.k + a.t) : 0);
  const size_t smem =
      SPLIT ? (size_t)slots * kThreads * sizeof(unsigned long long) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_kernel<MAXR, DX, DP, DM, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  probe_kernel<MAXR, DX, DP, DM, SPLIT><<<grid, block, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MAXR, bool DX, bool DP>
int by_matmul(bool dm, bool split, const ProbeArgs& a, cudaStream_t s) {
  if (dm) {
    return split ? launch<MAXR, DX, DP, true, true>(a, s)
                 : launch<MAXR, DX, DP, true, false>(a, s);
  }
  return split ? launch<MAXR, DX, DP, false, true>(a, s)
               : launch<MAXR, DX, DP, false, false>(a, s);
}

template <int MAXR>
int by_flags(bool dx, bool dp, bool dm, bool split, const ProbeArgs& a,
             cudaStream_t s) {
  if (dx && dp) return by_matmul<MAXR, true, true>(dm, split, a, s);
  if (dx) return by_matmul<MAXR, true, false>(dm, split, a, s);
  return by_matmul<MAXR, false, true>(dm, split, a, s);
}

}  // namespace

// x: [P, k, B] 32-bit words at element strides (sx_p, sx_j, sx_b), unread
// without do_x; out: [n, B] int64; matrix: host [n][k + t] canonical
// residues; group: threads a column, 1 or 4 (SPLIT). Returns
// cudaGetLastError() after the launch.
extern "C" int sda_kernel_probe(const void* x, long long sx_p, long long sx_j,
                                long long sx_b, void* out, int P, int k, int t,
                                int n, long long B, unsigned long long seed,
                                unsigned long long p,
                                const unsigned int* matrix, int do_x,
                                int do_prng, int do_matmul, int group,
                                void* stream) {
  if (k < 1 || t < 0 || k + t > kMaxRows || n < 1 || n > kMaxShares ||
      P < 0 || B < 0 || p < 2 || !(do_x || do_prng) ||
      (group != 1 && group != kGroup) ||
      (!do_matmul && n < (do_prng ? k + t : k))) {
    return (int)cudaErrorInvalidValue;
  }
  ProbeArgs a = {};
  a.x = static_cast<const uint32_t*>(x);
  a.sx_p = sx_p;
  a.sx_j = sx_j;
  a.sx_b = sx_b;
  a.out = static_cast<long long*>(out);
  a.P = P;
  a.k = k;
  a.t = t;
  a.n = n;
  a.B = B;
  a.key0 = (uint32_t)seed;
  a.key1 = (uint32_t)(seed >> 32);
  a.p = p;
  for (int i = 0; i < n; ++i) {
    for (int c = 0; c < k + t; ++c) a.mat.m[i][c] = matrix[i * (k + t) + c];
  }
  if (B == 0) return (int)cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool split = group != 1;
  if (k + t <= 8) {
    return by_flags<8>(do_x, do_prng, do_matmul, split, a, s);
  }
  return by_flags<16>(do_x, do_prng, do_matmul, split, a, s);
}
