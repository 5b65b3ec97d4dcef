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
//   never stored are removed by the compiler, so the draw-only variants
//   would time a fraction of the Philox work.
//
// Every variant is K1's main-path instance: the same column skeleton
// (columns.cuh: one thread a column, factored Philox, round keys by value,
// loads in flight), the same launch shape, the flagship's k = 3, t = 4 and the
// batch_columns layout, with components compiled out. The contraction
// lies after the participant loop, so the loops of no_matmul and full are
// the same code and full - no_matmul is the contraction.
//
// SPLIT is the counterpart of the Pallas probe's tree=True. There the tree
// filled idle sublanes, which has no meaning here; the question on this
// card is whether one thread a column, folding all P alone, is the right
// shape. With SPLIT a column gets kGroup adjacent threads: thread s folds
// the participants q = s (mod kGroup) into raw uint64 partials, and a
// butterfly of warp shuffles sums them. Raw uint64 sums are exact and
// order-free for P < 2^32, so the output is bit-identical.
//
// What bounds it on this card: the fold alone reads P*k*B words once and is
// bound by device-memory bytes; every variant with draws is bound by 32-bit
// integer operations, as K1 is.

#include <cstdint>
#include <cuda_runtime.h>

#include "columns.cuh"
#include "philox.cuh"

namespace {

using columns::kThreads;
using columns::mod_p;
using columns::Solinas;

constexpr int K = 3, T = 4, ROWS = K + T;  // the flagship's value rows
constexpr int kMaxShares = 32;             // n: clerks
constexpr int kGroup = 4;                  // threads a column under SPLIT

struct ShareMatrix {
  // active share-matrix columns, canonical residues, [n][k + t]
  uint32_t m[kMaxShares][ROWS];
};

struct ProbeArgs {
  const uint32_t* x;  // [P, k, B] words, batch_columns layout
  long long sx_p;
  long long* out;     // [n, B] int64
  int P, n;
  long long B;
  PhiloxKeys key;
  Solinas sp;
  ShareMatrix mat;
};

template <bool DO_X, bool DO_PRNG, bool DO_MATMUL, bool SPLIT>
__global__ void __launch_bounds__(kThreads, columns::kMinBlocks)
probe_kernel(const ProbeArgs a) {
  constexpr int S = SPLIT ? kGroup : 1;  // threads a column
  using F = columns::Fold<K, T, true, DO_X, DO_PRNG, S>;
  const int s = (int)threadIdx.x % S;
  const long long b = (blockIdx.x * (long long)kThreads + threadIdx.x) / S;
  const bool active = b < a.B;
  F f;
  f.run(a.x, a.sx_p, a.P, (uint32_t)b, active, (uint32_t)(a.B - 1), s,
        a.key);
  f.reduce_split();
  uint32_t vx[K], vd[ROWS];
  f.residues(a.sp, vx, vd);
  if (!active) return;

  unsigned long long v[ROWS];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    v[c] = mod_p((DO_X ? vx[c] : 0u) + (unsigned long long)vd[c], a.sp);
  }
#pragma unroll
  for (int c = K; c < ROWS; ++c) v[c] = DO_PRNG ? vd[c] : v[(c - K) % K];
  const long long B = a.B;
  for (int i = s; i < a.n; i += S) {
    unsigned long long r = 0;
    if (DO_MATMUL) {
      // products < p^2 < 2^58 and 7 of them: the sum fits uint64
#pragma unroll
      for (int c = 0; c < ROWS; ++c) {
        r += (unsigned long long)a.mat.m[i][c] * v[c];
      }
      r = mod_p(r, a.sp);
    } else {
      // rows [0, k) the values, [k, k+t) the randomness sums when drawn
#pragma unroll
      for (int c = 0; c < ROWS; ++c) {
        if (i == c && (c < K || DO_PRNG)) r = v[c];
      }
    }
    a.out[i * B + b] = (long long)r;
  }
}

template <bool DX, bool DP, bool DM, bool SPLIT>
int launch(const ProbeArgs& a, cudaStream_t stream) {
  const long long threads = a.B * (SPLIT ? kGroup : 1);
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  probe_kernel<DX, DP, DM, SPLIT><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool DX, bool DP>
int by_matmul(bool dm, bool split, const ProbeArgs& a, cudaStream_t s) {
  if (dm) {
    return split ? launch<DX, DP, true, true>(a, s)
                 : launch<DX, DP, true, false>(a, s);
  }
  return split ? launch<DX, DP, false, true>(a, s)
               : launch<DX, DP, false, false>(a, s);
}

}  // namespace

// x: [P, k, B] 32-bit words in the batch_columns layout (strides
// (sx_p, 1, k)), unread without do_x; out: [n, B] int64; keys: host
// [2][10] round keys of the seed; p = 2^e - c; matrix: host [n][k + t]
// canonical residues; group: threads a column, 1 or 4 (SPLIT).
// Only the flagship's k = 3, t = 4. Returns cudaGetLastError() after the
// launch.
extern "C" int sda_kernel_probe(const void* x, long long sx_p, void* out,
                                int P, int k, int t, int n, long long B,
                                const unsigned int* keys,
                                unsigned long long p, int e,
                                unsigned long long c,
                                const unsigned int* matrix, int do_x,
                                int do_prng, int do_matmul, int group,
                                void* stream) {
  if (k != K || t != T || n < 1 || n > kMaxShares || P < 0 || B < 0 ||
      B > (1ll << 32) || e < 2 || e > 62 || c >= (1ull << e) ||
      p != (1ull << e) - c || p < 2 || !(do_x || do_prng) ||
      (group != 1 && group != kGroup) ||
      (!do_matmul && n < (do_prng ? ROWS : K))) {
    return (int)cudaErrorInvalidValue;
  }
  ProbeArgs a = {};
  a.x = static_cast<const uint32_t*>(x);
  a.sx_p = sx_p;
  a.out = static_cast<long long*>(out);
  a.P = P;
  a.n = n;
  a.B = B;
  for (int r = 0; r < kPhiloxRounds; ++r) {
    a.key.k0[r] = keys[r];
    a.key.k1[r] = keys[kPhiloxRounds + r];
  }
  a.sp = columns::make_solinas(p, e, c);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < ROWS; ++j) a.mat.m[i][j] = matrix[i * ROWS + j];
  }
  if (B == 0) return (int)cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool split = group != 1;
  if (do_x && do_prng) return by_matmul<true, true>(do_matmul, split, a, s);
  if (do_x) return by_matmul<true, false>(do_matmul, split, a, s);
  return by_matmul<false, true>(do_matmul, split, a, s);
}
