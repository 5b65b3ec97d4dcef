// The column skeleton of K1's main-path instances (fused_round.cu), shared
// with K5 (kernel_probe.cu) so that the probe's variants run K1's own loop
// with components switched off at compile time.
//
// The main path's layout is the batch_columns view of [P, d] inputs: word
// j of column b of participant q sits at q*sx_p + b*K + j. One thread folds
// a column over all P participants, two participants a loop iteration, and
// keeps the next two participants' words in flight (plain 4-byte loads:
// a participant's run of words is only 4-byte aligned) while these draw.
//
// The draws are K1's Philox4x32-10 words for counter (b mod 2^32, b >> 32,
// q, pair) under the round keys of the seed (philox.cuh), bit for bit. For
// b < 2^32 the counter's structure makes parts of rounds 1-3 invariant
// (per round, what M0*c0 and M1*c2 depend on):
//   round 1: M0*b            column alone      -> once per thread
//            M1*q            participant alone -> once per participant
//   round 2: M0*c0           participant alone -> once per participant
//            M1*c2           column and pair   -> once per thread and pair
//   round 3: M1*c2           column and participant -> once per participant
//            M0*c0           all three         -> in the loop, per pair
// Rounds 4-10 depend on all three. Of a masked k=3, t=4 column's 80 wide
// multiplies a participant, 60 stay per pair in the loop (the half-used
// 4th block's last M0 and xor are dead and removed).
//
// Sums are linear, so the fold keeps raw uint64 sums of the input words and
// of the hi and lo words of every drawn row (exact for P < 2^32), adding
// two participants' words with one 3-input add and its carries, and mod p
// is taken once per column, after the fold.
//
// What bounds it on the H100: the wide multiplies, each about four issue
// cycles of a warp scheduler. The alternatives measured against this
// design (more threads a column, more resident warps, one participant an
// iteration, 96-bit row sums, other multiply forms) were all slower on the
// card; PERF.md keeps their numbers.

#pragma once

#include <cstdint>

#include "philox.cuh"

namespace columns {

constexpr int kThreads = 256;  // threads a block
// The main-path kernels' __launch_bounds__ minimum of resident blocks an
// SM. Asking for one leaves ptxas free to spend registers on the Philox
// chains (113 in K1's masked instance); without the minimum it kept 94
// and K1 ran ~9% slower on the H100 (PERF.md).
constexpr int kMinBlocks = 1;
constexpr unsigned kFull = 0xffffffffu;

// p = 2^e - c (the round's Solinas prime) and 2^32 mod p
struct Solinas {
  unsigned long long p, c, c32;
  int e;
};

inline Solinas make_solinas(unsigned long long p, int e,
                            unsigned long long c) {
  return {p, c, (1ull << 32) % p, e};
}

// x mod p for any x < 2^64: fold the bits above e down (2^e = c mod p)
// while there are any, then one conditional subtract. Each fold shrinks x,
// since c < 2^e. Twin: tests/test_torch_philox.py::mod_solinas.
__device__ __forceinline__ unsigned long long mod_p(unsigned long long x,
                                                    const Solinas& s) {
  const unsigned long long low = (1ull << s.e) - 1;
  while (x >> s.e) x = (x >> s.e) * s.c + (x & low);
  return x >= s.p ? x - s.p : x;
}

// The sum over the participants of a drawn row's values hi * 2^32 + lo,
// kept as two uint64 sums of the hi and lo words.
struct RowSum {
  unsigned long long hi = 0, lo = 0;
  __device__ __forceinline__ void add(uint32_t h, uint32_t l) {
    hi += h;
    lo += l;
  }
  // two participants' words at once: a 3-input add with two carries
  __device__ __forceinline__ void add2(uint32_t h, uint32_t l, uint32_t h2,
                                       uint32_t l2) {
    hi += (unsigned long long)h + h2;
    lo += (unsigned long long)l + l2;
  }
  __device__ __forceinline__ void add_lane_xor(int mask) {
    hi += __shfl_xor_sync(kFull, hi, mask);
    lo += __shfl_xor_sync(kFull, lo, mask);
  }
  // sum_p ((hi_p * 2^32 + lo_p) mod p) = (2^32 * sum hi + sum lo) mod p
  __device__ __forceinline__ uint32_t residue(const Solinas& sp) const {
    return (uint32_t)mod_p(mod_p(hi, sp) * sp.c32 + mod_p(lo, sp), sp);
  }
};

// What one thread of a column folds, over participants q = s, s + S, ...
// (S > 1 only for the probe's participant split, SPLIT: the column's S
// threads are adjacent lanes).
template <int K, int T, bool MASKED, bool DO_X, bool DO_PRNG, int S>
struct Fold {
  static constexpr int ROWS = K + T;
  static constexpr int FIRST = MASKED ? 0 : K / 2;     // first drawn pair
  static constexpr int NPAIRS = (ROWS + 1) / 2 - FIRST;

  static __device__ constexpr bool drawn(int row) {
    return row < ROWS && (MASKED || row >= K);
  }

  unsigned long long xs[K];  // sums of the input words
  RowSum rs[NPAIRS][2];      // sums of the drawn rows, by pair and half

  // Per thread: round 1's M0*b (its lo word lA) and round 2's M1*c2 of
  // each pair (hC, lC).
  uint32_t lA, hC[NPAIRS], lC[NPAIRS];

  // The Philox words of every pair for participant q: w[i][0..3].
  __device__ __forceinline__ void draw(uint32_t q, const PhiloxKeys& key,
                                       uint32_t (&w)[NPAIRS][4]) const {
    // per participant, the same in every lane: round 1's M1*q, round 2's
    // M0*c0, and round 3's M1*c2, which all pairs share
    uint32_t hQ, lQ, hB, lB, hE, lE;
    mulhilo(kPhiloxM1, q, hQ, lQ);
    mulhilo(kPhiloxM0, hQ ^ key.k0[0], hB, lB);
    mulhilo(kPhiloxM1, hB ^ lA ^ key.k1[1], hE, lE);
#pragma unroll
    for (int i = 0; i < NPAIRS; ++i) {
      uint32_t hD, lD;
      mulhilo(kPhiloxM0, hC[i] ^ lQ ^ key.k0[1], hD, lD);
      w[i][0] = hE ^ lC[i] ^ key.k0[2];
      w[i][1] = lE;
      w[i][2] = hD ^ lB ^ key.k1[2];
      w[i][3] = lD;
#pragma unroll
      for (int r = 3; r < kPhiloxRounds; ++r) {
        philox_round(w[i][0], w[i][1], w[i][2], w[i][3], key.k0[r],
                     key.k1[r]);
      }
    }
  }

  // Whether word pair h (0: words 0-1, 1: words 2-3) of pair i is a drawn
  // row: the rows are known at compile time, so unused words die.
  static __device__ constexpr bool summed(int i, int h) {
    return DO_PRNG && drawn(2 * (FIRST + i) + h);
  }

  // Fold participants [s, P) step S of column b (b < 2^32) into the sums.
  // The main loop takes two participants an iteration (their words summed
  // by 3-input adds) and keeps the rows of the next two in flight while
  // these draw; the last participants, fewer than four, take one an
  // iteration. Every thread runs the loops, so that with S == 1 the
  // participant index is warp-uniform; a thread past the last column (not
  // active) reads the last column and its sums are never stored.
  __device__ __forceinline__ void run(const uint32_t* __restrict__ x,
                                      long long sx_p, int P, uint32_t b,
                                      bool active, uint32_t last, int s,
                                      const PhiloxKeys& key) {
#pragma unroll
    for (int j = 0; j < K; ++j) xs[j] = 0;
    uint32_t hA;
    mulhilo(kPhiloxM0, b, hA, lA);
#pragma unroll
    for (int i = 0; i < NPAIRS; ++i) {
      mulhilo(kPhiloxM1, hA ^ (uint32_t)(FIRST + i) ^ key.k1[0], hC[i],
              lC[i]);
    }
    const uint32_t* col = x + (long long)(active ? b : last) * K;
    // the K words of a participant's column at xq
    auto load = [&](const uint32_t* xq, uint32_t (&v)[K]) {
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = DO_X ? __ldg(xq + j) : 0u;
    };
    const long long step = (long long)S * sx_p;
    const uint32_t* xn[2];  // columns of the two participants in flight
    uint32_t next[2][K];
    int q = s;
    xn[0] = col + q * sx_p;
    xn[1] = col + (q + S) * sx_p;
    if (q + 3 * S < P) {
      load(xn[0], next[0]);
      load(xn[1], next[1]);
    }
#pragma unroll 1
    for (; q + 3 * S < P; q += 2 * S) {
      // sum the words that arrived, then send for the next participants'
#pragma unroll
      for (int j = 0; j < K; ++j) {
        xs[j] += (unsigned long long)next[0][j] + next[1][j];
      }
      xn[0] += 2 * step;
      xn[1] += 2 * step;
      load(xn[0], next[0]);
      load(xn[1], next[1]);
      uint32_t w0[NPAIRS][4], w1[NPAIRS][4];
      if (DO_PRNG) {
        draw((uint32_t)q, key, w0);
        draw((uint32_t)(q + S), key, w1);
      }
#pragma unroll
      for (int i = 0; i < NPAIRS; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (summed(i, h)) {
            rs[i][h].add2(w0[i][2 * h], w0[i][2 * h + 1], w1[i][2 * h],
                          w1[i][2 * h + 1]);
          }
        }
      }
    }
#pragma unroll 1
    for (; q < P; q += S) {
      uint32_t v[K], w[NPAIRS][4];
      load(col + q * sx_p, v);
      if (DO_PRNG) draw((uint32_t)q, key, w);
#pragma unroll
      for (int j = 0; j < K; ++j) xs[j] += v[j];
#pragma unroll
      for (int i = 0; i < NPAIRS; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (summed(i, h)) rs[i][h].add(w[i][2 * h], w[i][2 * h + 1]);
        }
      }
    }
  }

  // Sum the S participant groups of a column (the probe's SPLIT): every
  // thread of the column ends with the column's total.
  __device__ __forceinline__ void reduce_split() {
#pragma unroll
    for (int h = 1; h < S; h *= 2) {
#pragma unroll
      for (int j = 0; j < K; ++j) xs[j] += __shfl_xor_sync(kFull, xs[j], h);
#pragma unroll
      for (int i = 0; i < NPAIRS; ++i) {
        rs[i][0].add_lane_xor(h);
        rs[i][1].add_lane_xor(h);
      }
    }
  }

  // The column's canonical residues: vx[j] the fold of input row j, vd[c]
  // the sum of row c's draws (0 if undrawn).
  __device__ __forceinline__ void residues(const Solinas& sp,
                                          uint32_t (&vx)[K],
                                          uint32_t (&vd)[ROWS]) const {
#pragma unroll
    for (int j = 0; j < K; ++j) vx[j] = DO_X ? (uint32_t)mod_p(xs[j], sp) : 0u;
#pragma unroll
    for (int c = 0; c < ROWS; ++c) {
      vd[c] = summed(c / 2 - FIRST, c % 2)
                  ? rs[c / 2 - FIRST][c % 2].residue(sp)
                  : 0u;
    }
  }
};

}  // namespace columns
