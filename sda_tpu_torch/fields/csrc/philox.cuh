// Philox4x32-10 (Salmon et al., SC'11), the counter-based generator of the
// port's kernels. Shared by fused_round.cu (K1) and kernel_probe.cu (K5),
// so the probe draws exactly K1's words for the same seed and counter.
// Its torch twin is sda_tpu_torch/fields/fused_round.py::philox4x32_10.

#pragma once

#include <cstdint>

// Ten rounds on the counter (c0, c1, c2, c3) under key (k0, k1), in place.
// A round is 2 wide multiplies (IMAD.WIDE on the FMA pipe) and 2
// three-input xors (LOP3 on the ALU pipe).
__device__ __forceinline__ void philox4x32_10(uint32_t& c0, uint32_t& c1,
                                              uint32_t& c2, uint32_t& c3,
                                              uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}
