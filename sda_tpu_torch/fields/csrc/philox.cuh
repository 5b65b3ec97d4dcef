// Philox4x32-10 (Salmon et al., SC'11), the counter-based generator of the
// port's kernels. Shared by fused_round.cu (K1) and kernel_probe.cu (K5),
// so the probe draws exactly K1's words for the same seed and counter.
// Its torch twin is sda_tpu_torch/fields/fused_round.py::philox4x32_10.

#pragma once

#include <cstdint>

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr int kPhiloxRounds = 10;

// The round keys of a 64-bit seed: round r is keyed by
// (seed_lo + r * 0x9E3779B9, seed_hi + r * 0xBB67AE85) mod 2^32. Computed
// on the host (fused_round.py::philox_round_keys) and passed by value, so
// every xor takes its key from the constant bank and the kernels carry no
// key schedule.
struct PhiloxKeys {
  uint32_t k0[kPhiloxRounds];
  uint32_t k1[kPhiloxRounds];
};

// (hi, lo) of m * c, written as a PTX multiply-high and multiply-low,
// which ptxas fuses into wide multiplies (IMAD.WIDE on the FMA pipe) where
// it pays: the Philox loops come out shorter on the H100 than from one
// 64-bit product or from a multiply-high and a multiply-low kept apart.
__device__ __forceinline__ void mulhilo(uint32_t m, uint32_t c, uint32_t& hi,
                                        uint32_t& lo) {
  asm("mul.hi.u32 %0, %1, %2;" : "=r"(hi) : "r"(c), "r"(m));
  asm("mul.lo.u32 %0, %1, %2;" : "=r"(lo) : "r"(c), "r"(m));
}

// One Philox round: 2 wide multiplies and 2 three-input xors (LOP3 on the
// ALU pipe).
__device__ __forceinline__ void philox_round(uint32_t& c0, uint32_t& c1,
                                             uint32_t& c2, uint32_t& c3,
                                             uint32_t k0, uint32_t k1) {
  uint32_t hi0, lo0, hi1, lo1;
  mulhilo(kPhiloxM0, c0, hi0, lo0);
  mulhilo(kPhiloxM1, c2, hi1, lo1);
  c0 = hi1 ^ c1 ^ k0;
  c1 = lo1;
  c2 = hi0 ^ c3 ^ k1;
  c3 = lo0;
}

// Ten rounds on the counter (c0, c1, c2, c3), in place.
__device__ __forceinline__ void philox4x32_10(uint32_t& c0, uint32_t& c1,
                                              uint32_t& c2, uint32_t& c3,
                                              const PhiloxKeys& key) {
#pragma unroll
  for (int r = 0; r < kPhiloxRounds; ++r) {
    philox_round(c0, c1, c2, c3, key.k0[r], key.k1[r]);
  }
}
