// K6: the device block provider's coordinate hash for NVIDIA Hopper
// (sm_90a), one pass a block.
//
// Replaces sda_tpu/mesh/streaming.py::synthetic_device_block_provider32
// (its jitted `gen`, jnp, not Pallas: XLA fuses the hash into one pass a
// block shape). For a block [rows, cols] at absolute coordinates (p0, d0):
//
//   out[i, j] = hash32(uint32(p0 + i), uint32(d0 + j), seed_word) % bound
//
// as int64, hash32 being streaming.py::_hash32 on uint32 words (every
// product and sum wraps mod 2^32), 0 < bound <= 2^32 - 1. The plain
// version is sda_tpu_torch/fields/blockgen.py::block_plain (int64 torch,
// each 32-bit product split into 16-bit halves).
//
// What bounds it on this card: bytes. Each element is one int64 written
// and nothing read; its work is 3 multiplies and 7 shifts and xors of the
// hash and the remainder by a run-time divisor, which a generic `%`
// compiles to a long sequence. Here the remainder is Lemire's direct
// computation (Lemire, Kaser, Kurz 2019, "Faster remainder by direct
// computation"): with M = floor((2^64 - 1) / bound) + 1 mod 2^64, computed
// on the host, x % bound = high 64 bits of ((M * x mod 2^64) * bound), exact
// for every 32-bit x and bound (bound = 1 wraps M to 0 and gives 0): two
// wide multiplies, a multiply and a multiply-high. About 14 integer
// operations an element, against the ~40 the ALU pipe could issue in the
// time its 8 bytes take at the memory rate (benchmarks/bounds.py).
//
// Design: a thread owns one row and 8 of its columns, as 4 pairs; a pair is
// two int64 and one 16-byte store. The pairs of a 256-thread block
// interleave (pair t + 256 k of the block's 1,024 in thread t), so each
// store instruction of a warp writes 512 contiguous bytes. The row's
// product (p0 + i) * 0x9E3779B1 ^ seed_word is computed once a row. A row
// whose first element lies at an odd index of the output (cols odd, i odd)
// writes that element alone and pairs from its second column; a row with
// an odd count of columns after that writes its last element alone. So
// every pair store is 16-byte aligned whatever the width; offsets are
// 64-bit. Rows run over gridDim.y and, beyond 65,535 of them, a loop. The
// kernel allocates nothing; the C entry launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 4;                        // pairs a thread
constexpr long long kBlockPairs = (long long)kThreads * kPairs;
constexpr unsigned kMaxGridY = 65535;

__device__ __forceinline__ uint32_t fastmod(uint32_t x, uint64_t mult,
                                            uint32_t bound) {
  const uint64_t low = mult * x;                 // mod 2^64
  const uint64_t t = (uint64_t)(uint32_t)(low >> 32) * bound +
                     __umulhi((uint32_t)low, bound);
  return (uint32_t)(t >> 32);
}

// one 16-byte store (STG.E.128) of two int64 at a 16-byte aligned p: in
// C++ a ulonglong2 store compiles to two STG.E.64, a uint4 of the words to
// three narrower stores
__device__ __forceinline__ void store_pair(long long* p, uint64_t a,
                                           uint64_t b) {
  asm volatile("st.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b)
               : "memory");
}

// hash32 with the row's term rw = row * 0x9E3779B1 ^ seed_word given
__device__ __forceinline__ uint32_t value(uint32_t rw, uint32_t col,
                                          uint64_t mult, uint32_t bound) {
  uint32_t x = rw ^ col * 0x85EBCA77u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return fastmod(x, mult, bound);
}

__global__ void __launch_bounds__(kThreads)
blockgen_kernel(uint32_t p0, uint32_t d0, long long rows, long long cols,
                uint32_t seed_word, uint32_t bound, uint64_t mult,
                long long* __restrict__ out) {
  for (long long i = blockIdx.y; i < rows; i += gridDim.y) {
    const uint32_t rw = (p0 + (uint32_t)i) * 0x9E3779B1u ^ seed_word;
    long long* row = out + i * cols;
    // the row's first output index is i * cols: odd means its first
    // element sits alone before the 16-byte aligned pairs
    const long long first = (i & cols) & 1;
    const long long pairs = (cols - first) >> 1;
    if (blockIdx.x == 0 && threadIdx.x < 2) {
      if (threadIdx.x == 0 && first)
        row[0] = value(rw, d0, mult, bound);
      if (threadIdx.x == 1 && ((cols - first) & 1))
        row[cols - 1] = value(rw, d0 + (uint32_t)(cols - 1), mult, bound);
    }
    const long long q0 = (long long)blockIdx.x * kBlockPairs + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const long long q = q0 + (long long)k * kThreads;
      if (q < pairs) {
        const long long c = first + 2 * q;
        const uint32_t col = d0 + (uint32_t)c;
        store_pair(row + c, value(rw, col, mult, bound),
                   value(rw, col + 1u, mult, bound));
      }
    }
  }
}

}  // namespace

// out: [rows, cols] int64, contiguous and 16-byte aligned, on the device;
// p0, d0: the block's absolute coordinates mod 2^32; seed_word: (seed ^
// 0x5851F42D) mod 2^32; mult: floor((2^64 - 1) / bound) + 1 mod 2^64.
extern "C" int sda_blockgen(uint32_t p0, uint32_t d0, long long rows,
                            long long cols, uint32_t seed_word,
                            uint32_t bound, unsigned long long mult,
                            long long* out, cudaStream_t stream) {
  if (rows < 0 || cols < 0 || bound == 0 || out == nullptr ||
      ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return (int)cudaSuccess;
  const long long col_blocks = ((cols >> 1) + kBlockPairs - 1) / kBlockPairs;
  if (col_blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  const dim3 grid(
      (unsigned)(col_blocks > 0 ? col_blocks : 1),
      (unsigned)(rows < (long long)kMaxGridY ? rows : (long long)kMaxGridY));
  blockgen_kernel<<<grid, kThreads, 0, stream>>>(p0, d0, rows, cols,
                                                 seed_word, bound, mult, out);
  return (int)cudaGetLastError();
}
