// K8: a block of integer inputs to int32 canonical residues mod a Solinas
// prime, in one pass, and K10: the clerk's device-tile fold, a block's
// floor mod m added into a column accumulator, in one pass; for NVIDIA
// Hopper (sm_90a).
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
// as a contiguous int32 [rows, out_cols], out_cols >= cols, whose columns
// from cols on are zeros: a model-scale round's ragged last tile is read
// at its own width and leaves at the tile's, so no copy pads it
// (sda_tpu/fields/dimtile.py pads the input once; the port's tiles are
// views of it).
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
// is not 16-byte aligned writes its first (4 - i out_cols mod 4) mod 4 values
// alone, and the values after its last whole group alone, so every group
// store is aligned whatever the width. A group's 4 inputs are two 16-byte
// loads (int64) or one (32-bit) where the row's offset allows it, else 4
// plain loads; both cases are uniform along a row. Rows run over gridDim.y
// and, beyond 65,535 of them, a loop. The kernel allocates nothing; the C
// entry launches on the caller's stream and returns cudaGetLastError().
//
// K10 replaces sda_tpu/mesh/devscale.py:501-511 DeviceTileCombiner.
// _fold_step, the jitted acc + sum_rows to_residues(bundle) of the clerk's
// SDA_CLERK_DEVICE_TILES fold, which the port ran as three eager passes
// (torch.remainder, the sum, the modular add). For a bundle tile blk
// [rows, cols] (int64, any values: Paillier-premixed bundles decrypt to
// unreduced sums) and the tile's accumulator acc [cols] (canonical):
//
//   acc[c] = (acc[c] + sum_r floor_mod(blk[r, c], m)) mod m,  in place,
//
// exact for every modulus FieldOps.create takes (m <= 2^63): each value is
// reduced by Barrett with the host's floor((2^64 - 1) / m) (its sign bit
// flipped, then -2^63 mod m added back), and the column sum is kept
// canonical after every row. What bounds it: bytes, 8 an element read
// (the accumulator's 16 a column besides) against about 30 integer
// operations (benchmarks/bounds.py::k10_bound).

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
                long long x_stride, long long out_cols, const Solinas sp,
                unsigned long long fold, int32_t* __restrict__ out) {
  for (long long i = blockIdx.y; i < rows; i += gridDim.y) {
    const In* src = x + i * x_stride;
    int32_t* dst = out + i * out_cols;
    // outputs before the first 16-byte aligned one, then whole groups;
    // columns from cols on are the zeros past a ragged tile's edge
    const long long head = min((4 - ((i * out_cols) & 3)) & 3, out_cols);
    const long long groups = (out_cols - head) >> 2;
    const long long tail = head + 4 * groups;
    if (blockIdx.x == 0 && threadIdx.x < 8) {
      const long long c = threadIdx.x < 4 ? threadIdx.x
                                          : tail + (threadIdx.x - 4);
      if ((threadIdx.x < 4 && c < head) ||
          (threadIdx.x >= 4 && c < out_cols))
        dst[c] = c < cols ? residue(__ldg(src + c), sp, fold) : 0;
    }
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(src + head)) & 15) == 0;
    const long long g0 = (long long)blockIdx.x * kBlockGroups + threadIdx.x;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const long long q = g0 + (long long)g * kThreads;
      if (q < groups) {
        const long long c = head + 4 * q;
        int32_t r[4] = {0, 0, 0, 0};
        if (c + 4 <= cols) {
          In v[4];
          load4(src + c, aligned, v);
#pragma unroll
          for (int k = 0; k < 4; ++k) r[k] = residue(v[k], sp, fold);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (c + k < cols) r[k] = residue(__ldg(src + c + k), sp, fold);
        }
        *reinterpret_cast<int4*>(dst + c) = make_int4(r[0], r[1], r[2], r[3]);
      }
    }
  }
}

template <typename In>
void launch(const void* x, long long rows, long long cols,
            long long x_stride, long long out_cols, const Solinas& sp,
            unsigned long long fold, int32_t* out, cudaStream_t stream) {
  const long long col_blocks =
      ((out_cols >> 2) + kBlockGroups - 1) / kBlockGroups;
  const dim3 grid(
      (unsigned)(col_blocks > 0 ? col_blocks : 1),
      (unsigned)(rows < (long long)kMaxGridY ? rows : (long long)kMaxGridY));
  residues_kernel<In><<<grid, kThreads, 0, stream>>>(
      static_cast<const In*>(x), rows, cols, x_stride, out_cols, sp, fold,
      out);
}

// ---------------------------------------------------------------------------
// K10: the clerk's device-tile fold

// A modulus for the fold: 0 < m <= 2^63, mu = floor((2^64 - 1) / m), fold
// = -2^63 mod m.
struct Modulus {
  unsigned long long m, mu, fold;
};

// v mod m for any v < 2^64: m mu > 2^64 - 1 - m, so v mu / 2^64 > v / m - 1
// and q = floor(v mu / 2^64) is floor(v / m) or one below it; v - q m is
// then below 2m <= 2^64, and one conditional subtract canonicalises it.
__device__ __forceinline__ unsigned long long reduce(unsigned long long v,
                                                     const Modulus& md) {
  const unsigned long long r = v - __umul64hi(v, md.mu) * md.m;
  return r >= md.m ? r - md.m : r;
}

// a + b mod m for canonical a, b (a + b < 2m <= 2^64)
__device__ __forceinline__ unsigned long long add_mod(unsigned long long a,
                                                      unsigned long long b,
                                                      const Modulus& md) {
  const unsigned long long s = a + b;
  return s >= md.m ? s - md.m : s;
}

// The floor mod m of an int64 x: its word with the sign bit flipped is x +
// 2^63 in [0, 2^64), reduced exactly, then -2^63 mod m added back.
__device__ __forceinline__ unsigned long long floor_mod(long long x,
                                                        const Modulus& md) {
  return add_mod(reduce((unsigned long long)x ^ (1ull << 63), md), md.fold,
                 md);
}

// acc[c] = (acc[c] + sum_r floor_mod(blk[r, c])) mod m for c < cols: one
// thread a column, a warp's 32 columns side by side, so each row's load is
// 256 contiguous bytes; the column sum stays canonical after every row, so
// no row count overflows it; kRowUnroll rows' loads in flight a thread.
constexpr int kRowUnroll = 4;

__global__ void __launch_bounds__(kThreads)
fold_columns_kernel(const long long* __restrict__ blk, long long rows,
                    long long cols, long long stride, const Modulus md,
                    long long* __restrict__ acc) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  const long long* src = blk + c;
  unsigned long long s = (unsigned long long)acc[c];
  long long r = 0;
  for (; r + kRowUnroll <= rows; r += kRowUnroll) {
    long long v[kRowUnroll];
#pragma unroll
    for (int k = 0; k < kRowUnroll; ++k) v[k] = __ldg(src + (r + k) * stride);
#pragma unroll
    for (int k = 0; k < kRowUnroll; ++k) s = add_mod(s, floor_mod(v[k], md), md);
  }
  for (; r < rows; ++r) s = add_mod(s, floor_mod(__ldg(src + r * stride), md), md);
  acc[c] = (long long)s;
}

}  // namespace

// x: [rows, cols] of dtype 0 (int64), 1 (int32) or 2 (uint32), rows
// x_stride elements apart, columns contiguous; p = 2^e - c, e <= 29; fold:
// -2^63 mod p (int64), -2^31 mod p (int32) or 0 (uint32); out: [rows,
// out_cols] int32, contiguous and 16-byte aligned, out_cols >= cols: its
// columns from cols on are written as zeros (a ragged tile's padding).
extern "C" int sda_residues(const void* x, int dtype, long long rows,
                            long long cols, long long x_stride,
                            long long out_cols, unsigned long long p, int e,
                            unsigned long long c, unsigned long long fold,
                            int32_t* out, cudaStream_t stream) {
  if (rows < 0 || cols < 0 || out_cols < cols || x_stride < cols || e < 2 ||
      e > 29 || c >= (1ull << e) || p != (1ull << e) - c || fold >= p ||
      (cols > 0 && x == nullptr) || out == nullptr ||
      ((uintptr_t)out & 15) || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || out_cols == 0) return (int)cudaSuccess;
  if (((out_cols >> 2) + kBlockGroups - 1) / kBlockGroups > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  const Solinas sp = columns::make_solinas(p, e, c);
  if (dtype == 0) {
    launch<long long>(x, rows, cols, x_stride, out_cols, sp, fold, out,
                      stream);
  } else if (dtype == 1) {
    launch<int32_t>(x, rows, cols, x_stride, out_cols, sp, fold, out,
                    stream);
  } else {
    launch<uint32_t>(x, rows, cols, x_stride, out_cols, sp, fold, out,
                     stream);
  }
  return (int)cudaGetLastError();
}

// K10. blk: [rows, cols] int64, rows `stride` elements apart (stride >=
// cols), columns contiguous, any values; acc: [cols] int64 canonical
// residues mod m, updated in place; 0 < m <= 2^63, mu = floor((2^64 - 1) /
// m), fold = -2^63 mod m.
extern "C" int sda_fold_columns(const long long* blk, long long rows,
                                long long cols, long long stride,
                                unsigned long long m, unsigned long long mu,
                                unsigned long long fold, long long* acc,
                                cudaStream_t stream) {
  if (rows < 0 || cols < 0 || (rows > 1 && stride < cols) || m == 0 ||
      m > (1ull << 63) || mu != ~0ull / m ||
      fold != (m - (1ull << 63) % m) % m ||
      (rows > 0 && cols > 0 && blk == nullptr) ||
      (cols > 0 && acc == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return (int)cudaSuccess;
  const long long blocks = (cols + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  fold_columns_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      blk, rows, cols, stride, Modulus{m, mu, fold}, acc);
  return (int)cudaGetLastError();
}
