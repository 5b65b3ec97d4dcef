// K9: the pod's clerk combine of one d column, in one pass, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the collectives of the reference's jitted pod programs: the
// psum_scatter over the p axis, its canonicalize and the all_gather
// (sda_tpu/mesh/simpod.py:588-610 in the pod round, streaming.py:740-755 in
// the StreamedPod finale, devscale.py:287-297 in each model-scale tile),
// and the mask psum with its canonicalize. XLA fuses them into the round's
// program; the port ran them as p_shards - 1 int64 adds, a canonicalize and
// a torch.cat a clerk block, and again for the mask. On one device the
// scatter's split into clerk blocks and the gather change no element, so
// for the p_shards partials part[j] [rows, cols] (participant-summed share
// rows of one shard each, canonical residues mod m) and mask[j] [mask_cols]
// (their mask sums):
//
//   out[i, c]   = (sum_j part[j][i, c]) mod m
//   out_mask[c] = (sum_j mask[j][c]) mod m
//
// as contiguous int64, canonical. The pod admits p_shards (m - 1) < 2^63
// (mesh/simpod.py::_check_collective_headroom; on the Solinas lane
// cross_terms (p - 1) < 2^32, fields/ops.py), so the sum of the partials
// is exact in an unsigned 64-bit word and is reduced once: Barrett with
// the host's mu = floor((2^64 - 1) / m), for any m <= 2^63.
//
// What bounds it on this card: bytes, 8 (p_shards + 1) an element against
// about 2 p_shards + 17 integer operations (benchmarks/bounds.py::
// k9_bound). Design: the partials are read in place through a pointer
// table passed by value (__grid_constant__, so a thread reads it from the
// parameter bank without a local copy): the share rows with their own row
// strides, the mask vectors as one more row. Row i of the output runs over
// gridDim.y (the mask total is row `rows`), its columns over gridDim.x; a
// thread owns kPerThread columns kThreads apart, so each load and store
// instruction of a warp touches 256 contiguous bytes, and a thread has
// kPerThread independent loads in flight a partial. The kernel allocates
// nothing; the C entry launches on the caller's stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr long long kBlockCols = (long long)kThreads * kPerThread;
constexpr int kMaxParts = 64;
constexpr unsigned kMaxGridY = 65535;

struct Table {
  const unsigned long long* part[kMaxParts];  // row 0 of partial j
  long long stride[kMaxParts];                // its row stride, elements
  const unsigned long long* mask[kMaxParts];  // mask partial j (or null)
};

struct Modulus {
  unsigned long long m;   // 0 < m <= 2^63
  unsigned long long mu;  // floor((2^64 - 1) / m)
};

// v mod m for any v < 2^64: m mu > 2^64 - 1 - m, so v mu / 2^64 > v / m - 1
// and q = floor(v mu / 2^64) is floor(v / m) or one below it; v - q m is
// then below 2m <= 2^64, and one conditional subtract canonicalises it.
__device__ __forceinline__ unsigned long long reduce(unsigned long long v,
                                                     const Modulus& md) {
  const unsigned long long r = v - __umul64hi(v, md.mu) * md.m;
  return r >= md.m ? r - md.m : r;
}

__global__ void __launch_bounds__(kThreads)
shardsum_kernel(const __grid_constant__ Table t, int nparts, long long rows,
                long long cols, long long mask_cols, const Modulus md,
                long long* __restrict__ out,
                long long* __restrict__ out_mask) {
  const long long last = out_mask != nullptr ? rows : rows - 1;
  for (long long i = blockIdx.y; i <= last; i += gridDim.y) {
    const bool is_mask = i == rows;
    const long long n = is_mask ? mask_cols : cols;
    const long long c0 = (long long)blockIdx.x * kBlockCols + threadIdx.x;
    if (c0 >= n) continue;
    unsigned long long s[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) s[q] = 0;
    for (int j = 0; j < nparts; ++j) {
      const unsigned long long* src =
          is_mask ? t.mask[j] : t.part[j] + i * t.stride[j];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const long long c = c0 + (long long)q * kThreads;
        if (c < n) s[q] += __ldg(src + c);
      }
    }
    long long* dst = is_mask ? out_mask : out + i * cols;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const long long c = c0 + (long long)q * kThreads;
      if (c < n) dst[c] = (long long)reduce(s[q], md);
    }
  }
}

}  // namespace

// parts: nparts pointers to [rows, cols] int64 partials, row i of partial
// j at parts[j] + i * strides[j] (strides[j] >= cols), columns contiguous;
// masks: nparts pointers to [mask_cols] int64 vectors, or null (then
// out_mask is null too); the host arrays are read before the launch
// returns. m: 0 < m <= 2^63 with mu = floor((2^64 - 1) / m); every sum of
// the partials must stay below 2^64 (nparts (m - 1) < 2^64). out: [rows,
// cols] int64, contiguous; out_mask: [mask_cols] int64.
extern "C" int sda_shardsum(const void* const* parts,
                            const long long* strides,
                            const void* const* masks, int nparts,
                            long long rows, long long cols,
                            long long mask_cols, unsigned long long m,
                            unsigned long long mu, long long* out,
                            long long* out_mask, cudaStream_t stream) {
  if (nparts < 1 || nparts > kMaxParts || rows < 0 || cols < 0 ||
      mask_cols < 0 || m == 0 || m > (1ull << 63) ||
      mu != ~0ull / m || parts == nullptr || strides == nullptr ||
      (masks == nullptr) != (out_mask == nullptr) ||
      (rows > 0 && cols > 0 && out == nullptr))
    return (int)cudaErrorInvalidValue;
  Table t = {};
  for (int j = 0; j < nparts; ++j) {
    if ((rows > 0 && cols > 0 &&
         (parts[j] == nullptr || (rows > 1 && strides[j] < cols))) ||
        (masks != nullptr && mask_cols > 0 && masks[j] == nullptr))
      return (int)cudaErrorInvalidValue;
    t.part[j] = static_cast<const unsigned long long*>(parts[j]);
    t.stride[j] = strides[j];
    t.mask[j] = masks != nullptr
                    ? static_cast<const unsigned long long*>(masks[j])
                    : nullptr;
  }
  const long long widest = masks != nullptr && mask_cols > cols ? mask_cols
                                                                : cols;
  const long long row_count = rows + (masks != nullptr ? 1 : 0);
  if (widest == 0 || row_count == 0 ||
      ((rows == 0 || cols == 0) && (masks == nullptr || mask_cols == 0)))
    return (int)cudaSuccess;
  const long long col_blocks = (widest + kBlockCols - 1) / kBlockCols;
  if (col_blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)col_blocks,
                  (unsigned)(row_count < (long long)kMaxGridY
                                 ? row_count
                                 : (long long)kMaxGridY));
  shardsum_kernel<<<grid, kThreads, 0, stream>>>(
      t, nparts, rows, cols, mask_cols, Modulus{m, mu}, out, out_mask);
  return (int)cudaGetLastError();
}
