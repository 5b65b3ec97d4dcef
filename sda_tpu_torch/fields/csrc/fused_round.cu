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
// P*2*draws*B words with Philox4x32-10 (wide multiplies on the FMA pipe,
// three-input xors on the ALU pipe), which outweighs the P*k*B input
// words: it is bound by 32-bit integer operations.
//
// Three instances, chosen per call from its arguments:
// - fused_round_columns<K, T, MASKED>, the main path's: internal draws,
//   the batch_columns layout (word j of column b of participant q at
//   q*sx_p + b*K + j), b < 2^32, compiled for the flagship's k = 3, t = 4,
//   masked (the round with full masking) and unmasked (without masking).
//   Its loop is the column skeleton of columns.cuh: one thread a column,
//   rounds 1-3 factored by what the counter makes invariant, round keys
//   from the constant bank, two participants an iteration with the next
//   two participants' words in flight, Solinas reduction once a column.
// - fused_round_kernel<MAXR, EXTERNAL>, every other call: any k + t <= 16
//   (BasicShamir's k = 1 among them), any strides, external bits. One
//   thread a column.
// Both keep raw uint64 sums over the participants and reduce once per
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

// shares[i] = sum_c M[i][c] v[c] mod p; products < p^2 < 2^58 and at most
// 16 of them, so the sum fits uint64
template <int ROWS>
__device__ __forceinline__ long long share_row(const ShareMatrix& mat, int i,
                                               const unsigned long long (&v)[ROWS],
                                               int rows, const Solinas& sp) {
  unsigned long long acc = 0;
#pragma unroll
  for (int c = 0; c < ROWS; ++c) {
    if (c < rows) acc += (unsigned long long)mat.m[i][c] * v[c];
  }
  return (long long)mod_p(acc, sp);
}

template <int K, int T, bool MASKED>
__global__ void __launch_bounds__(kThreads, columns::kMinBlocks)
fused_round_columns(const uint32_t* __restrict__ x, long long sx_p,
                    long long* __restrict__ shares,
                    long long* __restrict__ mask_tot, int P, int n,
                    long long B, const PhiloxKeys key, const Solinas sp,
                    const ShareMatrix mat) {
  using F = columns::Fold<K, T, MASKED, true, true, 1>;
  const long long b = blockIdx.x * (long long)kThreads + threadIdx.x;
  const bool active = b < B;
  F f;
  f.run(x, sx_p, P, (uint32_t)b, active, (uint32_t)(B - 1), 0, key);
  uint32_t vx[K], vd[K + T];
  f.residues(sp, vx, vd);
  if (!active) return;
  unsigned long long v[K + T];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const unsigned long long m = MASKED ? vd[c] : 0ull;
    v[c] = mod_p(vx[c] + m, sp);
    mask_tot[c * B + b] = (long long)m;
  }
#pragma unroll
  for (int c = K; c < K + T; ++c) v[c] = vd[c];
  for (int i = 0; i < n; ++i) {
    shares[i * B + b] = share_row(mat, i, v, K + T, sp);
  }
}

// value row c of a column: rows [0, k) are the secrets (plus, when masked,
// mask draws), rows [k, k + t) the share randomness
template <int MAXR, bool kExternal>
__global__ void __launch_bounds__(kThreads)
fused_round_kernel(const uint32_t* __restrict__ x, long long sx_p,
                   long long sx_j, long long sx_b,
                   const uint32_t* __restrict__ bits,
                   long long* __restrict__ shares,
                   long long* __restrict__ mask_tot, int P, int k, int t,
                   int n, long long B, int masked, const PhiloxKeys key,
                   const Solinas sp, const ShareMatrix mat) {
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
  }

  unsigned long long v[MAXR];
#pragma unroll
  for (int c = 0; c < MAXR; ++c) {
    const unsigned long long drawn =
        mod_p(mod_p(hs[c], sp) * sp.c32 + mod_p(ls[c], sp), sp);
    if (c < k) {
      const unsigned long long m = masked ? drawn : 0ull;
      mask_tot[c * B + b] = (long long)m;
      v[c] = mod_p(mod_p(xs[c], sp) + m, sp);
    } else {
      v[c] = c < rows ? drawn : 0ull;
    }
  }
  for (int i = 0; i < n; ++i) shares[i * B + b] = share_row(mat, i, v, rows, sp);
}

template <int MAXR>
void launch(bool external, dim3 grid, cudaStream_t stream, const uint32_t* x,
            long long sx_p, long long sx_j, long long sx_b,
            const uint32_t* bits, long long* shares, long long* mask_tot,
            int P, int k, int t, int n, long long B, int masked,
            const PhiloxKeys& key, const Solinas& sp, const ShareMatrix& mat) {
  if (external) {
    fused_round_kernel<MAXR, true><<<grid, kThreads, 0, stream>>>(
        x, sx_p, sx_j, sx_b, bits, shares, mask_tot, P, k, t, n, B, masked,
        key, sp, mat);
  } else {
    fused_round_kernel<MAXR, false><<<grid, kThreads, 0, stream>>>(
        x, sx_p, sx_j, sx_b, bits, shares, mask_tot, P, k, t, n, B, masked,
        key, sp, mat);
  }
}

// the main path's instances: the flagship's k and t
constexpr int kColK = 3, kColT = 4;

// Instances as *instance and sda_fused_round_occupancy number them.
enum Instance { kGeneric = 0, kColumns = 1, kColumnsUnmasked = 2 };

}  // namespace

// x: [P, k, B] 32-bit words at element strides (sx_p, sx_j, sx_b);
// bits: null (internal Philox) or contiguous [P, 2*draws, B] words;
// shares: [n, B] int64; mask_tot: [k, B] int64; keys: host [2][10] round
// keys of the seed; p = 2^e - c; matrix: host [n][k + t] canonical
// residues. Sets *instance to the instance the call runs (Instance).
// Returns cudaGetLastError() after the launch.
extern "C" int sda_fused_mask_share_combine(
    const void* x, long long sx_p, long long sx_j, long long sx_b,
    const void* bits, void* shares, void* mask_tot, int P, int k, int t,
    int n, long long B, int masked, const unsigned int* keys,
    unsigned long long p, int e, unsigned long long c,
    const unsigned int* matrix, int* instance, void* stream) {
  if (k < 1 || t < 0 || k + t > kMaxRows || n < 1 || n > kMaxShares ||
      P < 0 || B < 0 || e < 2 || e > 62 || c >= (1ull << e) ||
      p != (1ull << e) - c || p < 2) {
    return (int)cudaErrorInvalidValue;
  }
  ShareMatrix mat = {};
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < k + t; ++j) mat.m[i][j] = matrix[i * (k + t) + j];
  }
  PhiloxKeys key;
  for (int r = 0; r < kPhiloxRounds; ++r) {
    key.k0[r] = keys[r];
    key.k1[r] = keys[kPhiloxRounds + r];
  }
  const Solinas sp = columns::make_solinas(p, e, c);
  const bool main_path = bits == nullptr && k == kColK && t == kColT &&
                         sx_j == 1 && sx_b == kColK && B <= (1ll << 32);
  *instance = !main_path ? kGeneric : masked ? kColumns : kColumnsUnmasked;
  if (B == 0) return (int)cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xw = static_cast<const uint32_t*>(x);
  auto* sh = static_cast<long long*>(shares);
  auto* mt = static_cast<long long*>(mask_tot);
  const dim3 grid((unsigned)((B + kThreads - 1) / kThreads));
  if (main_path) {
    if (masked) {
      fused_round_columns<kColK, kColT, true><<<grid, kThreads, 0, s>>>(
          xw, sx_p, sh, mt, P, n, B, key, sp, mat);
    } else {
      fused_round_columns<kColK, kColT, false><<<grid, kThreads, 0, s>>>(
          xw, sx_p, sh, mt, P, n, B, key, sp, mat);
    }
    return (int)cudaGetLastError();
  }
  const bool external = bits != nullptr;
  const auto* bw = static_cast<const uint32_t*>(bits);
  if (k + t <= 8) {
    launch<8>(external, grid, s, xw, sx_p, sx_j, sx_b, bw, sh, mt, P, k, t,
              n, B, masked, key, sp, mat);
  } else {
    launch<16>(external, grid, s, xw, sx_p, sx_j, sx_b, bw, sh, mt, P, k, t,
               n, B, masked, key, sp, mat);
  }
  return (int)cudaGetLastError();
}

// Resident blocks an SM of an instance (Instance; the generic one with
// internal draws and at most 8 value rows) at kThreads threads a block
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns the CUDA error
// code.
extern "C" int sda_fused_round_occupancy(int instance, int* blocks) {
  switch (instance) {
    case kColumns:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, fused_round_columns<kColK, kColT, true>, kThreads, 0);
    case kColumnsUnmasked:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, fused_round_columns<kColK, kColT, false>, kThreads, 0);
    default:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, fused_round_kernel<8, false>, kThreads, 0);
  }
}
