// K8: a block of integer inputs to int32 canonical residues mod a Solinas
// prime, in one pass, for NVIDIA Hopper (sm_90a).
//
// Replaces sda_tpu/fields/fastfield.py::to_residues32 followed by the
// int32 cast of the K1 lanes (jnp, not Pallas: inside the jitted steps of
// sda_tpu/mesh/streaming.py:482-512 and simpod.py:632 XLA fuses the floor
// mod into the step). Here the port ran it as two eager passes,
// torch.remainder (8 bytes read, 8 written an element) then
// .to(torch.int32) (8 read, 4 written); K8 reads 8 and writes 4. For x
// [rows, cols] (int64, int32 or uint32, rows x_stride elements apart,
// columns contiguous) and p = 2^e - c:
//
//   out[i, j] = x[i, j] mod p   (the floor mod: non-negative, in [0, p))
//
// as a contiguous int32 [rows, cols].
//
// Each value is reduced in registers: its word v, read unsigned with the
// sign bit flipped (v = x + 2^63, or x + 2^31 for int32: a fold of the
// sign by a multiple of 2^63 or 2^31), is taken mod p by K1's Solinas fold
// (columns.cuh::mod_p: the bits above e times c, until none are left),
// then the fold's constant, -2^63 mod p (or -2^31; 0 for uint32), is added
// back mod p.
//
// What bounds it on this card: bytes, 12 an int64 element (8 for 32-bit
// inputs), against about 20 integer operations (benchmarks/bounds.py::
// residues_bound). Design: K6's. A thread owns 8 outputs of one row as two
// groups of 4, and a group leaves as one 16-byte store; the groups of a
// 256-thread block interleave (group t + 256 g in thread t), so a warp's
// store instruction writes 512 contiguous bytes. A row whose first output
// is not 16-byte aligned writes its first (4 - i cols mod 4) mod 4 values
// alone, and the values after its last whole group alone, so every group
// store is aligned whatever the width. A group's 4 inputs are two 16-byte
// loads (int64) or one (32-bit) where the row's offset allows it, else 4
// plain loads; both cases are uniform along a row. Rows run over gridDim.y
// and, beyond 65,535 of them, a loop. The kernel allocates nothing; the C
// entry launches on the caller's stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "columns.cuh"

namespace {

using columns::mod_p;
using columns::Solinas;

constexpr int kThreads = 256;
constexpr int kGroups = 2;                 // groups of 4 outputs a thread
constexpr long long kBlockGroups = (long long)kThreads * kGroups;
constexpr unsigned kMaxGridY = 65535;

// The unsigned word of a value with its sign bit flipped: x + 2^63 (int64),
// x + 2^31 (int32), x (uint32).
__device__ __forceinline__ unsigned long long word(long long x) {
  return (unsigned long long)x ^ (1ull << 63);
}
__device__ __forceinline__ unsigned long long word(int32_t x) {
  return (unsigned long long)((uint32_t)x ^ 0x80000000u);
}
__device__ __forceinline__ unsigned long long word(uint32_t x) { return x; }

// x mod p, canonical; fold = (-bias) mod p for the bias word() added
template <typename In>
__device__ __forceinline__ int32_t residue(In x, const Solinas& sp,
                                           unsigned long long fold) {
  const unsigned long long r = mod_p(word(x), sp) + fold;  // < 2p
  return (int32_t)(r >= sp.p ? r - sp.p : r);
}

// the 4 inputs at p, 16-byte aligned or not
__device__ __forceinline__ void load4(const long long* p, bool aligned,
                                      long long (&v)[4]) {
  if (aligned) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p) + 1);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = __ldg(p + q);
  }
}
template <typename In>
__device__ __forceinline__ void load4(const In* p, bool aligned,
                                      In (&v)[4]) {
  if (aligned) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = (In)a.x;
    v[1] = (In)a.y;
    v[2] = (In)a.z;
    v[3] = (In)a.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = __ldg(p + q);
  }
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
residues_kernel(const In* __restrict__ x, long long rows, long long cols,
                long long x_stride, const Solinas sp,
                unsigned long long fold, int32_t* __restrict__ out) {
  for (long long i = blockIdx.y; i < rows; i += gridDim.y) {
    const In* src = x + i * x_stride;
    int32_t* dst = out + i * cols;
    // outputs before the first 16-byte aligned one, then whole groups
    const long long head = min((4 - ((i * cols) & 3)) & 3, cols);
    const long long groups = (cols - head) >> 2;
    const long long tail = head + 4 * groups;
    if (blockIdx.x == 0 && threadIdx.x < 8) {
      const long long c = threadIdx.x < 4 ? threadIdx.x
                                          : tail + (threadIdx.x - 4);
      if ((threadIdx.x < 4 && c < head) || (threadIdx.x >= 4 && c < cols))
        dst[c] = residue(__ldg(src + c), sp, fold);
    }
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(src + head)) & 15) == 0;
    const long long g0 = (long long)blockIdx.x * kBlockGroups + threadIdx.x;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const long long q = g0 + (long long)g * kThreads;
      if (q < groups) {
        const long long c = head + 4 * q;
        In v[4];
        load4(src + c, aligned, v);
        *reinterpret_cast<int4*>(dst + c) =
            make_int4(residue(v[0], sp, fold), residue(v[1], sp, fold),
                      residue(v[2], sp, fold), residue(v[3], sp, fold));
      }
    }
  }
}

template <typename In>
void launch(const void* x, long long rows, long long cols,
            long long x_stride, const Solinas& sp, unsigned long long fold,
            int32_t* out, cudaStream_t stream) {
  const long long col_blocks = ((cols >> 2) + kBlockGroups - 1) / kBlockGroups;
  const dim3 grid(
      (unsigned)(col_blocks > 0 ? col_blocks : 1),
      (unsigned)(rows < (long long)kMaxGridY ? rows : (long long)kMaxGridY));
  residues_kernel<In><<<grid, kThreads, 0, stream>>>(
      static_cast<const In*>(x), rows, cols, x_stride, sp, fold, out);
}

}  // namespace

// x: [rows, cols] of dtype 0 (int64), 1 (int32) or 2 (uint32), rows
// x_stride elements apart, columns contiguous; p = 2^e - c, e <= 29; fold:
// -2^63 mod p (int64), -2^31 mod p (int32) or 0 (uint32); out: [rows,
// cols] int32, contiguous and 16-byte aligned.
extern "C" int sda_residues(const void* x, int dtype, long long rows,
                            long long cols, long long x_stride,
                            unsigned long long p, int e,
                            unsigned long long c, unsigned long long fold,
                            int32_t* out, cudaStream_t stream) {
  if (rows < 0 || cols < 0 || x_stride < cols || e < 2 || e > 29 ||
      c >= (1ull << e) || p != (1ull << e) - c || fold >= p ||
      x == nullptr || out == nullptr || ((uintptr_t)out & 15) ||
      dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return (int)cudaSuccess;
  if (((cols >> 2) + kBlockGroups - 1) / kBlockGroups > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  const Solinas sp = columns::make_solinas(p, e, c);
  if (dtype == 0) {
    launch<long long>(x, rows, cols, x_stride, sp, fold, out, stream);
  } else if (dtype == 1) {
    launch<int32_t>(x, rows, cols, x_stride, sp, fold, out, stream);
  } else {
    launch<uint32_t>(x, rows, cols, x_stride, sp, fold, out, stream);
  }
  return (int)cudaGetLastError();
}
