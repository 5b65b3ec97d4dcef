// K1: fused mask + share + participant combine of one secure-aggregation
// round, for NVIDIA Hopper (sm_90a).
//
// Replaces sda_tpu/fields/pallas_round.py::fused_mask_share_combine (the
// Pallas kernel). It computes the same function: for each batch column b,
// fold the P participants' inputs, draw k mask and t share-randomness
// residues per participant (2 uint32 words each, residue
// (hi * 2^32 + lo) mod p), add the masks, and contract the n x (k+t) share
// matrix (its zero column dropped) with [sum values; sum randomness]. Out:
// shares [n, B] and mask totals [k, B], canonical residues as int64; or,
// as the reference's jitted streamed step does with its donated
// accumulators (sda_tpu/mesh/streaming.py:503-505, :719-721), both added
// mod p in place into the caller's accumulators: the shares' [n, B] and
// the masks' unbatched [d] (Out).
//
// What bounds it on this card: with external bits it reads
// P*(k + 2*draws)*B words once and writes (n+k)*B results, so it is
// bound by device-memory bytes. With internal randomness it draws
// P*2*draws*B words with Philox4x32-10 (wide multiplies on the FMA pipe,
// three-input xors on the ALU pipe), which outweighs the P*k*B input
// words: it is bound by 32-bit integer operations.
//
// Its instances, chosen per call from its arguments:
// - fused_round_columns<K, T, MASKED>: internal draws on the batch_columns
//   layout (word j of column b of participant q at q*sx_p + b*k + j),
//   b < 2^32, for the (k, t) the repo's configurations run most: the
//   flagship's k = 3, t = 4 (the main path), BasicShamir's k = 1, t = 3
//   (sda-sim --sharing basic at 8 clerks) and the 26-clerk committee's
//   k = 7, t = 8; masked (the round with full masking) and unmasked. Its
//   loop is the column skeleton of columns.cuh with a Fixed shape: one
//   thread a column, rounds 1-3 factored by what the counter makes
//   invariant, round keys from the constant bank, two participants an
//   iteration with the next two participants' words in flight, Solinas
//   reduction once a column, whatever the scheme does not draw removed.
//   At k = 7, t = 8 two threads share a column, each drawing half of its
//   pairs (Tuning: the registers of 15 row sums would leave 8 warps an SM).
// - fused_round_bounded<R, MASKED>: the same layout and skeleton for any
//   other k + t <= R (R = 8 or 16), k and t at run time under R.
// - fused_round_external<R>: external bits, any strides, k + t <= R. Bound
//   by bytes: each participant's words of a column are copied into shared
//   memory by cp.async kStages - 1 participants ahead, so the loads in
//   flight hold no registers: at the flagship's masked shape (17 words a
//   participant, 16 resident warps) ~100 KB are in flight an SM.
// - fused_round_kernel<R>: internal draws on any other layout (only tests
//   make one) or B > 2^32. One thread a column, one participant at a
//   time, a whole Philox block a row pair.
// All keep raw uint64 sums over the participants and reduce once per
// column (Solinas folds, p = 2^e - c), contracting once per column after
// the fold (sum_p M v_p = M sum_p v_p): every output is the canonical
// residue, bit-identical to the Pallas kernel for any of its block or fold
// settings, and the instances give the same bits. The matrix (at most
// 32 x 16 residues) and the round keys travel by value in the kernel
// arguments; the kernel allocates nothing. Ragged B is masked at the edge.

#include <cstdint>
#include <cuda_runtime.h>

#include "columns.cuh"
#include "philox.cuh"

namespace {

using columns::kThreads;
using columns::mod_p;
using columns::Solinas;

constexpr int kMaxRows = 16;    // k + t: value rows per column
constexpr int kMaxShares = 32;  // n: clerks

struct ShareMatrix {
  // active share-matrix columns (column 0 multiplies the fixed zero and
  // is dropped), canonical residues, [n][k + t]
  uint32_t m[kMaxShares][kMaxRows];
};

// shares[i] = sum_c M[i][c] v[c] mod p for canonical v[c] < p < 2^32
// (32 x 32 -> 64-bit products); products < p^2 < 2^58 and at most 16 of
// them, so the sum fits uint64
// Where a column's results go. Shares: [n, B], written, or with
// acc_shares added mod p to what they hold. Mask totals: with mask_d == 0
// the [k, B] totals, written; else the [mask_d] accumulator of the
// unbatched masks, total (c, b) added mod p at b*k + c, where that is
// below mask_d (a padded column's is dropped).
struct Out {
  long long* shares;
  long long* mask;
  long long mask_d;
  int acc_shares;

  __device__ __forceinline__ void share(int i, long long b, long long B,
                                        unsigned long long v,
                                        const Solinas& sp) const {
    long long* dst = shares + i * B + b;
    if (acc_shares) v = mod_p((unsigned long long)*dst + v, sp);
    *dst = (long long)v;
  }
  __device__ __forceinline__ void mask_total(int c, long long b, int k,
                                             long long B,
                                             unsigned long long v,
                                             const Solinas& sp) const {
    if (mask_d == 0) {
      mask[c * B + b] = (long long)v;
      return;
    }
    const long long j = b * k + c;
    if (j < mask_d) {
      mask[j] = (long long)mod_p((unsigned long long)mask[j] + v, sp);
    }
  }
};

template <int ROWS>
__device__ __forceinline__ long long share_row(const ShareMatrix& mat, int i,
                                               const uint32_t (&v)[ROWS],
                                               int rows, const Solinas& sp) {
  unsigned long long acc = 0;
#pragma unroll
  for (int c = 0; c < ROWS; ++c) {
    if (c < rows) acc += (unsigned long long)mat.m[i][c] * v[c];
  }
  return (long long)mod_p(acc, sp);
}

// The epilogue of a column instance: residues, masks added, mask totals
// and shares stored.
template <class F>
__device__ __forceinline__ void store_column(const F& f, long long b,
                                             bool active, const Out& out,
                                             int n, long long B,
                                             const Solinas& sp,
                                             const ShareMatrix& mat) {
  constexpr int KMAX = F::KMAX, RMAX = F::RMAX;
  const int k = f.shape.k(), rows = f.shape.rows();
  uint32_t vx[KMAX], vd[RMAX];
  f.residues(sp, vx, vd);
  if (!active) return;
  uint32_t v[RMAX];
#pragma unroll
  for (int c = 0; c < KMAX; ++c) {
    if (c < k) {
      const uint32_t m = F::MASKED ? vd[c] : 0u;
      v[c] = (uint32_t)mod_p((unsigned long long)vx[c] + m, sp);
      out.mask_total(c, b, k, B, m, sp);
    }
  }
#pragma unroll
  for (int c = 0; c < RMAX; ++c) {
    if (c >= k) v[c] = c < rows ? vd[c] : 0u;
  }
  for (int i = 0; i < n; ++i) {
    out.share(i, b, B, share_row(mat, i, v, rows, sp), sp);
  }
}

// How a Fixed (k, t)'s instance runs: G threads a column (1, or 2 that
// split its drawn pairs) and the __launch_bounds__ minimum of resident
// blocks.
template <int K, int T, bool MASKED>
struct Tuning {
  static constexpr int G = 1, MIN_BLOCKS = columns::kMinBlocks;
};
// k = 7, t = 8: one thread a column keeps 205 registers (masked), 8 warps
// an SM; two threads a column, 122 (masked, with two blocks an SM asked
// for) and 96, 16 warps: 0.389 -> 0.328 ms masked, 0.269 -> 0.226 ms
// unmasked at P=100 x d=999,999 on the H100 (PERF.md; four threads a
// column, one participant a loop iteration, or three blocks an SM, were
// slower)
template <>
struct Tuning<7, 8, true> {
  static constexpr int G = 2, MIN_BLOCKS = 2;
};
template <>
struct Tuning<7, 8, false> {
  static constexpr int G = 2, MIN_BLOCKS = 1;
};

template <class Shape>
__device__ __forceinline__ void column_round(
    const Shape& shape, const uint32_t* __restrict__ x, long long sx_p,
    const Out& out, int P, int n, long long B, const PhiloxKeys& key,
    const Solinas& sp, const ShareMatrix& mat) {
  const long long b = blockIdx.x * (long long)kThreads + threadIdx.x;
  const bool active = b < B;
  columns::Fold<Shape, true, true, 1> f(shape);
  f.run(x, sx_p, P, (uint32_t)b, active, (uint32_t)(B - 1), 0, key);
  store_column(f, b, active, out, n, B, sp, mat);
}

// One of the two threads of a column under G = 2: it draws the pairs of
// Shape (and folds the inputs when DO_X) and leaves its residues in vs.
template <class Shape, bool DO_X, int C>
__device__ __forceinline__ void fold_half(
    uint32_t (&vs)[Shape::KMAX + Shape::RMAX][C], int j,
    const uint32_t* __restrict__ x, long long sx_p, int P, long long b,
    long long B, const PhiloxKeys& key, const Solinas& sp) {
  constexpr int K = Shape::KMAX, R = Shape::RMAX;
  columns::Fold<Shape, DO_X, true, 1> f(Shape{});
  f.run(x, sx_p, P, (uint32_t)b, b < B, (uint32_t)(B - 1), 0, key);
  uint32_t vx[K], vd[R];
  f.residues(sp, vx, vd);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (DO_X) vs[c][j] = vx[c];
  }
#pragma unroll
  for (int c = 0; c < R; ++c) {
    if (f.summed(c / 2, c % 2)) vs[K + c][j] = vd[c];
  }
}

// G = 2: the block's first four warps fold the inputs and the first half
// of the drawn pairs of kThreads / 2 columns, its last four the other
// pairs of the same columns (fewer registers a thread, more resident
// warps); the residues meet in shared memory and each half contracts
// every other share.
template <int K, int T, bool MASKED>
__device__ __forceinline__ void split_round(
    const uint32_t* __restrict__ x, long long sx_p, const Out& out, int P,
    int n, long long B, const PhiloxKeys& key, const Solinas& sp,
    const ShareMatrix& mat) {
  constexpr int C = kThreads / 2, R = K + T;
  constexpr int FIRST = MASKED ? 0 : K / 2, END = (R + 1) / 2;
  constexpr int MID = (FIRST + END) / 2;  // drawn pairs [FIRST, END)
  __shared__ uint32_t vs[K + R][C];        // input folds, then drawn rows
  const int g = threadIdx.x / C, j = threadIdx.x % C;  // g warp-uniform
  const long long b = blockIdx.x * (long long)C + j;
  if (g == 0) {
    fold_half<columns::Fixed<K, T, MASKED, FIRST, MID>, true>(
        vs, j, x, sx_p, P, b, B, key, sp);
  } else {
    fold_half<columns::Fixed<K, T, MASKED, MID, END>, false>(
        vs, j, x, sx_p, P, b, B, key, sp);
  }
  __syncthreads();
  if (b >= B) return;
  uint32_t v[R];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const uint32_t m = MASKED ? vs[K + c][j] : 0u;
    v[c] = (uint32_t)mod_p((unsigned long long)vs[c][j] + m, sp);
    if (g == 0) out.mask_total(c, b, K, B, m, sp);
  }
#pragma unroll
  for (int c = K; c < R; ++c) v[c] = vs[K + c][j];
  for (int i = g; i < n; i += 2) {
    out.share(i, b, B, share_row(mat, i, v, R, sp), sp);
  }
}

template <int K, int T, bool MASKED>
__global__ void __launch_bounds__(kThreads,
                                  Tuning<K, T, MASKED>::MIN_BLOCKS)
fused_round_columns(const uint32_t* __restrict__ x, long long sx_p,
                    const Out out, int P, int n, long long B,
                    const PhiloxKeys key, const Solinas sp,
                    const ShareMatrix mat) {
  static_assert(Tuning<K, T, MASKED>::G == 1 ||
                Tuning<K, T, MASKED>::G == 2);
  if constexpr (Tuning<K, T, MASKED>::G == 1) {
    column_round(columns::Fixed<K, T, MASKED>{}, x, sx_p, out, P, n, B, key,
                 sp, mat);
  } else {
    split_round<K, T, MASKED>(x, sx_p, out, P, n, B, key, sp, mat);
  }
}

template <int R, bool MASKED>
__global__ void __launch_bounds__(kThreads, columns::kMinBlocks)
fused_round_bounded(const uint32_t* __restrict__ x, long long sx_p,
                    const Out out, int P, int k, int t, int n, long long B,
                    const PhiloxKeys key, const Solinas sp,
                    const ShareMatrix mat) {
  column_round(columns::Bounded<R, MASKED>{k, k + t}, x, sx_p, out, P, n, B,
               key, sp, mat);
}

// The epilogue of the row-array instances: sums of the inputs (xs) and of
// each value row's hi and lo words (hs, ls) over the participants.
template <int MAXR>
__device__ __forceinline__ void store_rows(
    const unsigned long long (&xs)[MAXR], const unsigned long long (&hs)[MAXR],
    const unsigned long long (&ls)[MAXR], long long b, const Out& out,
    int k, int rows, int n, long long B, int masked, const Solinas& sp,
    const ShareMatrix& mat) {
  uint32_t v[MAXR];
#pragma unroll
  for (int c = 0; c < MAXR; ++c) {
    const unsigned long long drawn =
        mod_p(mod_p(hs[c], sp) * sp.c32 + mod_p(ls[c], sp), sp);
    if (c < k) {
      const unsigned long long m = masked ? drawn : 0ull;
      out.mask_total(c, b, k, B, m, sp);
      v[c] = (uint32_t)mod_p(mod_p(xs[c], sp) + m, sp);
    } else {
      v[c] = c < rows ? (uint32_t)drawn : 0u;
    }
  }
  for (int i = 0; i < n; ++i) {
    out.share(i, b, B, share_row(mat, i, v, rows, sp), sp);
  }
}

// cp.async of one 4-byte word into shared memory (cached in L1: a warp's
// words of x lie 4*k bytes apart), and its group fences
__device__ __forceinline__ void copy_word(uint32_t* dst, const uint32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
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

// participants in shared memory at once: one being summed, the rest in
// flight
constexpr int kStages = 4;

// Shared memory of the external instance for w words a participant.
constexpr size_t external_smem(int w) {
  return (size_t)kStages * w * kThreads * sizeof(uint32_t);
}

// value row c of a column: rows [0, k) are the secrets (plus, when masked,
// mask draws), rows [k, k + t) the share randomness. The bits are the
// reference's draw layout: a draw of `g` residues starting at residue g0
// keeps its hi words in rows [2*g0, 2*g0 + g) and its lo words in rows
// [2*g0 + g, 2*(g0 + g)); masks are the draw (0, k), randomness the draw
// (nmask, t).
//
// Each thread folds one column. Its words of participant q (k of x, then
// 2*draws of bits) go to slot q mod kStages of its own stripe of shared
// memory ([kStages][w][kThreads] words: a warp's copies and reads are
// consecutive words); each thread reads back only what it copied, so the
// cp.async groups alone order it and no barrier is needed. The slot a
// participant is copied to was summed in the iteration before.
template <int MAXR>
__global__ void __launch_bounds__(kThreads)
fused_round_external(const uint32_t* __restrict__ x, long long sx_p,
                     long long sx_j, long long sx_b,
                     const uint32_t* __restrict__ bits, const Out out,
                     int P, int k, int t, int n, long long B, int masked,
                     const Solinas sp, const ShareMatrix mat) {
  extern __shared__ uint32_t stage[];
  const long long b = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long bc = b < B ? b : B - 1;  // past the edge: read, not stored
  const int rows = k + t;
  const int nmask = masked ? k : 0;
  const int draws = nmask + t;
  const int w = k + 2 * draws;
  const uint32_t* xc = x + bc * sx_b;
  const uint32_t* bc0 = bits + bc;
  const long long bits_q = 2ll * draws * B;  // words a participant of bits

  auto issue = [&](int q) {
    uint32_t* s = stage + (q % kStages) * w * kThreads + threadIdx.x;
    const uint32_t* xq = xc + q * sx_p;
    for (int j = 0; j < k; ++j, s += kThreads) copy_word(s, xq + j * sx_j);
    const uint32_t* bq = bc0 + q * bits_q;
    for (int r = 0; r < 2 * draws; ++r, s += kThreads, bq += B) {
      copy_word(s, bq);
    }
  };

  unsigned long long xs[MAXR], hs[MAXR], ls[MAXR];
#pragma unroll
  for (int c = 0; c < MAXR; ++c) {
    xs[c] = 0;
    hs[c] = 0;
    ls[c] = 0;
  }
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < P) issue(q);
    copy_commit();
  }
#pragma unroll 1
  for (int q = 0; q < P; ++q) {
    if (q + kStages - 1 < P) issue(q + kStages - 1);
    copy_commit();
    copy_wait<kStages - 1>();  // participant q's group has landed
    const uint32_t* s = stage + (q % kStages) * w * kThreads + threadIdx.x;
    const uint32_t* sb = s + k * kThreads;  // its bits
#pragma unroll
    for (int c = 0; c < MAXR; ++c) {
      if (c < k) xs[c] += s[c * kThreads];
      if (c < nmask) {
        hs[c] += sb[c * kThreads];
        ls[c] += sb[(k + c) * kThreads];
      } else if (c >= k && c < rows) {
        const int i = c - k;
        hs[c] += sb[(2 * nmask + i) * kThreads];
        ls[c] += sb[(2 * nmask + t + i) * kThreads];
      }
    }
  }
  if (b < B) {
    store_rows(xs, hs, ls, b, out, k, rows, n, B, masked, sp, mat);
  }
}

// value row c of a column: rows [0, k) are the secrets (plus, when masked,
// mask draws), rows [k, k + t) the share randomness; drawn from a whole
// Philox4x32-10 block a row pair
template <int MAXR>
__global__ void __launch_bounds__(kThreads)
fused_round_kernel(const uint32_t* __restrict__ x, long long sx_p,
                   long long sx_j, long long sx_b, const Out out, int P,
                   int k, int t, int n, long long B, int masked,
                   const PhiloxKeys key, const Solinas sp,
                   const ShareMatrix mat) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int rows = k + t;
  const int nmask = masked ? k : 0;

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
#pragma unroll
    for (int c = 0; c < MAXR; c += 2) {
      const bool d0 = c < rows && (c >= k || c < nmask);
      const bool d1 = c + 1 < rows && (c + 1 >= k || c + 1 < nmask);
      if (d0 || d1) {
        uint32_t w0 = (uint32_t)b, w1 = (uint32_t)(b >> 32);
        uint32_t w2 = (uint32_t)q, w3 = (uint32_t)(c >> 1);
        philox4x32_10(w0, w1, w2, w3, key);
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
  store_rows(xs, hs, ls, b, out, k, rows, n, B, masked, sp, mat);
}

// Instances as *instance and sda_fused_round_occupancy number them
// (fused_round.py::INSTANCES).
enum Instance {
  kGeneric = 0,
  kColumns = 1,
  kColumnsUnmasked = 2,
  kExternal = 3,
  kColumnsK1T3 = 4,
  kColumnsK1T3Unmasked = 5,
  kColumnsK7T8 = 6,
  kColumnsK7T8Unmasked = 7,
  kColumnsR8 = 8,
  kColumnsR8Unmasked = 9,
  kColumnsR16 = 10,
  kColumnsR16Unmasked = 11,
};

// The arguments of a launch, whichever instance takes it.
struct Call {
  dim3 grid;
  cudaStream_t s;
  const uint32_t* x;
  long long sx_p, sx_j, sx_b;
  const uint32_t* bits;
  Out out;
  int P, k, t, n;
  long long B;
  int masked;
  PhiloxKeys key;
  Solinas sp;
  ShareMatrix mat;
};

template <int K, int T, bool MASKED>
void columns_launch(const Call& a) {
  constexpr int cols = kThreads / Tuning<K, T, MASKED>::G;  // a block
  const dim3 grid((unsigned)((a.B + cols - 1) / cols));
  fused_round_columns<K, T, MASKED><<<grid, kThreads, 0, a.s>>>(
      a.x, a.sx_p, a.out, a.P, a.n, a.B, a.key, a.sp, a.mat);
}

template <int R, bool MASKED>
void bounded_launch(const Call& a) {
  fused_round_bounded<R, MASKED><<<a.grid, kThreads, 0, a.s>>>(
      a.x, a.sx_p, a.out, a.P, a.k, a.t, a.n, a.B, a.key, a.sp, a.mat);
}

template <int R>
void external_launch(const Call& a) {
  const int draws = (a.masked ? a.k : 0) + a.t;
  const size_t smem = external_smem(a.k + 2 * draws);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(fused_round_external<R>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  fused_round_external<R><<<a.grid, kThreads, smem, a.s>>>(
      a.x, a.sx_p, a.sx_j, a.sx_b, a.bits, a.out, a.P, a.k, a.t, a.n, a.B,
      a.masked, a.sp, a.mat);
}

template <int R>
void generic_launch(const Call& a) {
  fused_round_kernel<R><<<a.grid, kThreads, 0, a.s>>>(
      a.x, a.sx_p, a.sx_j, a.sx_b, a.out, a.P, a.k, a.t, a.n, a.B, a.masked,
      a.key, a.sp, a.mat);
}

// The instance a call runs.
Instance choose(const Call& a) {
  if (a.bits != nullptr) return kExternal;
  if (a.sx_j != 1 || a.sx_b != a.k || a.B > (1ll << 32)) return kGeneric;
  const bool m = a.masked != 0;
  if (a.k == 3 && a.t == 4) return m ? kColumns : kColumnsUnmasked;
  if (a.k == 1 && a.t == 3) return m ? kColumnsK1T3 : kColumnsK1T3Unmasked;
  if (a.k == 7 && a.t == 8) return m ? kColumnsK7T8 : kColumnsK7T8Unmasked;
  if (a.k + a.t <= 8) return m ? kColumnsR8 : kColumnsR8Unmasked;
  return m ? kColumnsR16 : kColumnsR16Unmasked;
}

void launch(Instance i, const Call& a) {
  const bool r8 = a.k + a.t <= 8;
  switch (i) {
    case kColumns: return columns_launch<3, 4, true>(a);
    case kColumnsUnmasked: return columns_launch<3, 4, false>(a);
    case kColumnsK1T3: return columns_launch<1, 3, true>(a);
    case kColumnsK1T3Unmasked: return columns_launch<1, 3, false>(a);
    case kColumnsK7T8: return columns_launch<7, 8, true>(a);
    case kColumnsK7T8Unmasked: return columns_launch<7, 8, false>(a);
    case kColumnsR8: return bounded_launch<8, true>(a);
    case kColumnsR8Unmasked: return bounded_launch<8, false>(a);
    case kColumnsR16: return bounded_launch<16, true>(a);
    case kColumnsR16Unmasked: return bounded_launch<16, false>(a);
    case kExternal: return r8 ? external_launch<8>(a) : external_launch<16>(a);
    default: return r8 ? generic_launch<8>(a) : generic_launch<16>(a);
  }
}

}  // namespace

// x: [P, k, B] 32-bit words at element strides (sx_p, sx_j, sx_b);
// bits: null (internal Philox) or contiguous [P, 2*draws, B] words;
// shares: [n, B] int64, written, or with acc_shares a canonical
// accumulator the shares are added to mod p; mask_tot: with mask_d == 0
// [k, B] int64, written, else a canonical [mask_d] accumulator of the
// unbatched masks (k (B - 1) < mask_d <= k B); keys: host [2][10] round
// keys of the seed; p = 2^e - c; matrix: host [n][k + t] canonical
// residues. Sets *instance to the instance the call runs (Instance).
// Returns cudaGetLastError() after the launch.
extern "C" int sda_fused_mask_share_combine_into(
    const void* x, long long sx_p, long long sx_j, long long sx_b,
    const void* bits, void* shares, void* mask_tot, int P, int k, int t,
    int n, long long B, int masked, const unsigned int* keys,
    unsigned long long p, int e, unsigned long long c,
    const unsigned int* matrix, int acc_shares, long long mask_d,
    int* instance, void* stream) {
  if (k < 1 || t < 0 || k + t > kMaxRows || n < 1 || n > kMaxShares ||
      P < 0 || B < 0 || e < 2 || e > 32 || c >= (1ull << e) ||
      p != (1ull << e) - c || p < 2 || mask_d < 0 ||
      (mask_d > 0 && (mask_d > k * B || mask_d <= k * (B - 1)))) {
    return (int)cudaErrorInvalidValue;
  }
  Call a = {};
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < k + t; ++j) a.mat.m[i][j] = matrix[i * (k + t) + j];
  }
  for (int r = 0; r < kPhiloxRounds; ++r) {
    a.key.k0[r] = keys[r];
    a.key.k1[r] = keys[kPhiloxRounds + r];
  }
  a.sp = columns::make_solinas(p, e, c);
  a.grid = dim3((unsigned)((B + kThreads - 1) / kThreads));
  a.s = static_cast<cudaStream_t>(stream);
  a.x = static_cast<const uint32_t*>(x);
  a.sx_p = sx_p;
  a.sx_j = sx_j;
  a.sx_b = sx_b;
  a.bits = static_cast<const uint32_t*>(bits);
  a.out = {static_cast<long long*>(shares), static_cast<long long*>(mask_tot),
           mask_d, acc_shares};
  a.P = P;
  a.k = k;
  a.t = t;
  a.n = n;
  a.B = B;
  a.masked = masked;
  const Instance i = choose(a);
  *instance = i;
  if (B == 0) return (int)cudaSuccess;
  launch(i, a);
  return (int)cudaGetLastError();
}

// sda_fused_mask_share_combine_into with fresh outputs: its first
// interface (k1_ab binds it on older builds too).
extern "C" int sda_fused_mask_share_combine(
    const void* x, long long sx_p, long long sx_j, long long sx_b,
    const void* bits, void* shares, void* mask_tot, int P, int k, int t,
    int n, long long B, int masked, const unsigned int* keys,
    unsigned long long p, int e, unsigned long long c,
    const unsigned int* matrix, int* instance, void* stream) {
  return sda_fused_mask_share_combine_into(x, sx_p, sx_j, sx_b, bits, shares,
                                           mask_tot, P, k, t, n, B, masked,
                                           keys, p, e, c, matrix, 0, 0,
                                           instance, stream);
}

template <class Kernel>
int occupancy(int* blocks, Kernel kernel, size_t smem = 0) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            kThreads, smem);
}

// Resident blocks an SM of an instance (Instance) at kThreads threads a
// block (cudaOccupancyMaxActiveBlocksPerMultiprocessor): the generic and
// external ones at k + t <= 8, the external one with the flagship's
// masked words a participant (k = 3, t = 4: 17). Returns the CUDA error
// code.
extern "C" int sda_fused_round_occupancy(int instance, int* blocks) {
  switch (instance) {
    case kColumns: return occupancy(blocks, fused_round_columns<3, 4, true>);
    case kColumnsUnmasked:
      return occupancy(blocks, fused_round_columns<3, 4, false>);
    case kColumnsK1T3:
      return occupancy(blocks, fused_round_columns<1, 3, true>);
    case kColumnsK1T3Unmasked:
      return occupancy(blocks, fused_round_columns<1, 3, false>);
    case kColumnsK7T8:
      return occupancy(blocks, fused_round_columns<7, 8, true>);
    case kColumnsK7T8Unmasked:
      return occupancy(blocks, fused_round_columns<7, 8, false>);
    case kColumnsR8: return occupancy(blocks, fused_round_bounded<8, true>);
    case kColumnsR8Unmasked:
      return occupancy(blocks, fused_round_bounded<8, false>);
    case kColumnsR16: return occupancy(blocks, fused_round_bounded<16, true>);
    case kColumnsR16Unmasked:
      return occupancy(blocks, fused_round_bounded<16, false>);
    case kExternal:
      cudaFuncSetAttribute(fused_round_external<8>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)external_smem(17));
      return occupancy(blocks, fused_round_external<8>, external_smem(17));
    default: return occupancy(blocks, fused_round_kernel<8>);
  }
}
