// K7: the reveal of a secure-aggregation round for NVIDIA Hopper (sm_90a):
// Lagrange reconstruct and unmask in one pass a dim tile.
//
// Replaces the reveal the JAX package compiles into its jitted programs
// (jnp, not Pallas: XLA fuses it into one program there):
// sda_tpu/fields/sharing.py::packed_reconstruct32 (the [k, r+1] x [r+1, B]
// contraction of fastfield.modmatmul32 over [0; rows], then
// unbatch_columns), fastfield.modsub32 of the mask total and
// FieldOps.to_int64, as the streamed finale (sda_tpu/mesh/streaming.py:
// 518-528), the pod round's reveal (sda_tpu/mesh/simpod.py:429-441,
// :603-614) and sharing.packed_reconstruct (sharing.py:150-151) run them.
// For the gathered clerk rows G (canonical residues mod a Solinas prime
// p = 2^e - c, e <= 29, rows row_stride apart), the r of them at
// idx[0..r) and the reconstruction matrix's active columns L [k][r]
// (column 0 multiplies the implicit point-1 zero row and is dropped):
//
//   out[b k + i] = (sum_j L[i][j] G[idx[j], b] - mask(i, b)) mod p
//
// for every b k + i < d, as int64; mask(i, b) = mask[i ms_i + b ms_b] (the
// [k, B] batched totals: (B, 1); a flat [d] vector: (1, k)), or 0 without
// a mask.
//
// What bounds it on this card: bytes. A column reads r int64 rows and its
// k mask values and writes k int64 outputs (at k = 3, r = 8: 112 bytes)
// for k r wide multiply-adds and k Solinas reductions, a few operations a
// byte where the card's integer pipes could do about ten in the time a
// byte takes at its memory rate (benchmarks/bounds.py::reveal_bound). At
// the flagship tile (B = 333,333) those bytes take ~11 us, about a launch:
// there the time is latency.
//
// Design: one thread a column and up to KC of its secrets (KC = 4 for
// k <= 4, the flagship k = 3 and BasicShamir's k = 1, else 16; a k past
// 16 is split across gridDim.y). KC sets the registers the sums hold,
// and so the warps an SM keeps loading: built for 16 alone the kernel
// took 76 registers and ran the flagship tile and the 1e8 d column at
// 47% and 68% of their bytes bound on an H100. The rows come kRows at a
// time as independent 8-byte loads, consecutive threads on consecutive
// columns, all issued before the group's first multiply, so any r is
// served by one loop. Each secret keeps a uint64 sum of products
// L[i][j] v_j < p^2 < 2^58, folded in place by K1's Solinas reduction
// (columns.cuh::mod_p, as K1's share contraction does) every kFoldGroups
// groups and once at the end. The matrix (and a quorum's row indices, so
// it reads its rows in place) is one small int32 table on the device
// (the wrapper keeps one a matrix), read at the same address by every
// thread of a warp; rows 0..r-1 need no index, so their loads wait on no
// other load. A block's 256 columns own 256 k consecutive outputs: they
// meet in shared memory and leave as consecutive 8-byte stores, 256
// contiguous bytes a warp instruction, rather than k stores k * 8 bytes
// apart. The kernel allocates nothing; the C entry launches on the
// caller's stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "columns.cuh"

namespace {

using columns::mod_p;
using columns::Solinas;

constexpr int kThreads = 256;
// rows loaded together, before their multiplies
constexpr int kRows = 8;
// row groups summed between two folds: a folded sum (< p < 2^29) and
// kFoldGroups * kRows products below 2^58 each stay below 2^64
constexpr int kFoldGroups = 7;

// table: L's active columns [k][r] (canonical residues), then, when
// `indexed`, the r row indices (else rows 0..r-1)
template <int KC>
__global__ void __launch_bounds__(kThreads)
reveal_kernel(const long long* __restrict__ rows, long long row_stride,
              const int* __restrict__ table, int indexed, int k, int r,
              long long B, long long d, const Solinas sp,
              const long long* __restrict__ mask, long long ms_i,
              long long ms_b, long long* __restrict__ out) {
  extern __shared__ long long stage[];  // [kThreads][kc]
  const int i0 = blockIdx.y * KC;
  const int kc = min(KC, k - i0);
  const long long b0 = (long long)blockIdx.x * kThreads;
  const long long b = b0 + threadIdx.x;
  const uint32_t* l =
      reinterpret_cast<const uint32_t*>(table) + (long long)i0 * r;
  const int* idx = table + (long long)k * r;
  if (b < B) {
    unsigned long long acc[KC];
#pragma unroll
    for (int i = 0; i < KC; ++i) acc[i] = 0;
    for (int j0 = 0, g = 0; j0 < r; j0 += kRows, ++g) {
      uint32_t v[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        v[j] = 0u;
        if (j0 + j < r) {
          const long long row = indexed ? __ldg(idx + j0 + j) : j0 + j;
          v[j] = (uint32_t)__ldg(rows + row * row_stride + b);
        }
      }
      const bool fold = g % kFoldGroups == kFoldGroups - 1;
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        if (i < kc) {
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            if (j0 + j < r) {
              acc[i] += (unsigned long long)__ldg(l + i * r + j0 + j) * v[j];
            }
          }
          if (fold) acc[i] = mod_p(acc[i], sp);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      if (i < kc) {
        unsigned long long s = mod_p(acc[i], sp);
        if (mask != nullptr && b * k + i0 + i < d) {
          const unsigned long long m =
              (unsigned long long)__ldg(mask + (i0 + i) * ms_i + b * ms_b);
          s = s >= m ? s - m : s + sp.p - m;
        }
        stage[threadIdx.x * kc + i] = (long long)s;
      }
    }
  }
  __syncthreads();
  const long long n = min((long long)kThreads, B - b0) * kc;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const long long o =
        kc == k ? b0 * k + e : (b0 + e / kc) * k + i0 + e % kc;
    if (o < d) out[o] = stage[e];
  }
}

template <int KC>
void launch(const long long* rows, long long row_stride, const int* table,
            int indexed, int k, int r, long long B, long long d,
            const Solinas& sp, const long long* mask, long long ms_i,
            long long ms_b, long long* out, cudaStream_t stream) {
  const int kc = k < KC ? k : KC;
  const dim3 grid((unsigned)((B + kThreads - 1) / kThreads),
                  (unsigned)((k + KC - 1) / KC));
  reveal_kernel<KC><<<grid, kThreads, kThreads * kc * sizeof(long long),
                      stream>>>(rows, row_stride, table, indexed, k, r, B,
                                d, sp, mask, ms_i, ms_b, out);
}

}  // namespace

// rows: gathered clerk rows, int64 canonical residues, row_stride apart,
// columns contiguous; table: device int32, L's active columns [k][r] as
// canonical residues (the reconstruction matrix without its column 0),
// then, when `indexed`, the r rows to read (each a row of `rows`; else
// rows 0..r-1); p = 2^e - c, e <= 29; mask: null or int64 canonical
// residues at (i, b) -> mask[i * ms_i + b * ms_b]; out: [d] int64,
// d <= B * k. Returns cudaGetLastError() after the launch.
extern "C" int sda_reveal(const long long* rows, long long row_stride,
                          const int* table, int indexed, int k, int r,
                          long long B, long long d, unsigned long long p,
                          int e, unsigned long long c,
                          const long long* mask, long long ms_i,
                          long long ms_b, long long* out,
                          cudaStream_t stream) {
  if (k < 1 || r < 1 || B < 0 || d < 0 || d > B * k || e < 2 || e > 29 ||
      c >= (1ull << e) || p != (1ull << e) - c || rows == nullptr ||
      table == nullptr || out == nullptr ||
      B > 0x7FFFFFFFll * kThreads || (k - 1) / 16 >= 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || d == 0) return (int)cudaSuccess;
  const Solinas sp = columns::make_solinas(p, e, c);
  if (k <= 4) {
    launch<4>(rows, row_stride, table, indexed, k, r, B, d, sp, mask, ms_i,
              ms_b, out, stream);
  } else {
    launch<16>(rows, row_stride, table, indexed, k, r, B, d, sp, mask, ms_i,
               ms_b, out, stream);
  }
  return (int)cudaGetLastError();
}
