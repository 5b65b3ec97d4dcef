// K4: batched Montgomery multiplication and the Paillier premix fold, for
// NVIDIA Hopper (sm_90a).
//
// Replaces sda_tpu/crypto/paillier_tpu.py (jnp, not Pallas: the JAX package
// runs it as XLA lanes on the TPU): MontgomeryContext.mont_mul_fn (:75) and
// the fold of premix_fn (:137). A montmul is out = a * b * R^-1 mod m, fully
// reduced to [0, m), with m odd, L = ceil(bits(m) / 32) limbs of 32 bits and
// R = 2^(32 L). The fold multiplies the P rows of a lane one after another
// and ends with one montmul by R^P mod m (the fix-up): P - 1 montmuls leave
// prod * R^-(P - 1), the fix-up's R^P * R^-1 restores the exact product.
//
// What bounds it on this card: integer operations. CIOS takes 2 L^2 + L
// 32x32 -> 64-bit multiplies a montmul (32,896 at L = 128), each two
// FMA-pipe issue slots (a low and a high half), against 4 L bytes read a
// row and 4 L written a lane (benchmarks/bounds.py, k4_bound).
//
// Design: a group of TPI threads (4, 8, 16 or 32 lanes of one warp) does a
// montmul, each thread owning LPT consecutive limbs (thread k: limbs
// k LPT .. k LPT + LPT - 1) of both operands, the modulus and the
// accumulator, all in registers. The instances (TPI, LPT), by capacity
// TPI * LPT: (4, 8) for L <= 32, (8, 8) for 64, (16, 8) for 128, (16, 12)
// for 192, (16, 16) for 256, (32, 16) for 512; an L between two takes the
// larger. A CIOS step i:
// - broadcasts b_i from the thread that owns it (__shfl_sync);
// - adds a * b_i to the accumulator as two carry chains a thread (the low
//   halves into limbs l, the high halves into limbs l + 1: PTX mad.lo.cc /
//   madc.hi.cc / addc, which ptxas makes IMAD or IMAD.HI plus IADD3.X),
//   their carry-out kept lazily in two spare words s0, s1 at the thread's
//   limbs LPT and LPT + 1, which overlap the next thread's first limbs;
// - broadcasts q = t_0 n' from thread 0 (once the low chain has t_0, so
//   the shuffle overlaps the high chain) and adds q m the same way;
// - shifts the accumulator down one word: each thread takes its
//   neighbour's lowest limb (__shfl_down_sync, issued before q m's high
//   chain) plus its own s0 as its new top limb; the carry of that add and
//   s1 become the new s0. So s0 stays below 4 and no carry crosses more
//   than one thread a step.
// After L steps the spare words are added into the next thread once, and
// the carries between threads resolve in one step: a thread's carry-out is
// a generate bit, an all-ones limb block a propagate bit; two warp votes
// (__ballot_sync) give every thread its carry-in as bit k of
// ((G << 1) + P) ^ P. The final conditional subtract of m resolves its
// borrows the same way (propagate: an all-zero difference).
// Where L is not TPI * LPT the limbs at and above L are zero (a masked
// tail: loads and stores stop at L) and the step loop stops after L steps,
// so R is 2^(32 L) whatever the instance.
//
// What that does about the first version's costs (one thread a montmul):
// 1. registers: 4 LPT <= 64 words of operand state a thread, no spill
//    (chip_smoke.py fails on one), at most 128 registers
//    (__launch_bounds__(kBlock, 4): at least 16 resident warps an SM; the
//    L = 128 instance holds 28);
// 2. latency: a montmul's dependent chains are split over TPI threads,
//    each thread's chains LPT long, with 16 or more warps an SM to cover
//    them; every group of a warp folds the same slice of rows, so every
//    lane takes part in every shuffle (a constant full mask);
// 3. no shared-memory copy of an operand: the broadcasts are shuffles;
// 4. one launch a fold: a group keeps its lane's accumulator in registers
//    and multiplies in its rows one after another, each row read once from
//    device memory. Where B groups cannot fill the card, a lane's rows are
//    split among `split` groups (balanced slices), each writing its partial
//    product to [split, B, L]; a second launch of the same kernel folds the
//    partials with the fix-up. A slice of n rows takes n - 1 montmuls and
//    folding split partials split - 1, so any split does P - 1 montmuls in
//    all and the fix-up is R^P for every split (fold_fix(P) unchanged);
// 5. natural layout: rows are [P, B, L] as MontgomeryContext.to_limbs
//    makes them; a thread reads its LPT limbs of an operand as 16-byte
//    vectors (where L is a multiple of 4) and the result goes straight to
//    [B, L] (or [split, B, L]);
// 6. every L up to 512 (moduli up to 16,384 bits, keys up to 8,192 bits)
//    runs a group instance with its accumulator in registers; only a
//    larger L takes montfold_wide, one thread a lane with its accumulator
//    in a workspace of device memory.
// The kernels allocate nothing; the C entries launch on the caller's
// stream and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // threads a block

struct FoldArgs {
  const uint32_t* a;    // row 0: [lanes, limbs]
  const uint32_t* b;    // row p >= 1 at b + (p - 1) * row_stride
  long long row_stride;
  long long rows;
  long long lanes;
  long long split;      // groups a lane; slice g: rows [g P / split, ...)
  const uint32_t* m;    // [limbs], device memory
  const uint32_t* fix;  // [limbs] or null: one last montmul by it
  uint32_t* out;        // [split, lanes, limbs]
  int limbs;
  uint32_t n_prime;     // -m^-1 mod 2^32
  int vec;              // 16-byte loads and stores are aligned
};

__device__ __forceinline__ const uint32_t* row_ptr(const FoldArgs& f,
                                                   long long p) {
  return p == 0 ? f.a : f.b + (p - 1) * f.row_stride;
}

// -- carry-chain primitives (one PTX instruction each; the carry flag
//    lives between consecutive volatile statements of one chain) --------
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r)
               : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r)
               : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r)
               : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r)
               : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// Every lane of a warp takes part in each shuffle and vote (a constant full
// mask: no convergence checks around them).
constexpr uint32_t kWarp = 0xFFFFFFFFu;

// One thread's place in its group.
template <int TPI>
struct Lane {
  int k;     // thread index in the group
  int base;  // the group's first lane in the warp

  __device__ __forceinline__ Lane() {
    const int lane = threadIdx.x & 31;
    k = lane & (TPI - 1);
    base = lane - k;
  }
  // the group's bits of a warp vote, thread 0 in bit 0
  __device__ __forceinline__ uint32_t vote(bool pred) const {
    const uint32_t v = __ballot_sync(kWarp, pred) >> base;
    return TPI == 32 ? v : v & ((1u << TPI) - 1u);
  }
};

// This thread's LPT limbs of an operand at `p` ([limbs] words); zero at and
// above `limbs`.
template <int LPT>
__device__ __forceinline__ void load(uint32_t (&x)[LPT], const uint32_t* p,
                                     int k, int limbs, int vec) {
  const int j0 = k * LPT;
#pragma unroll
  for (int l = 0; l < LPT; l += 4) {
    const int j = j0 + l;
    if (vec && j + 4 <= limbs) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + j));
      x[l] = v.x;
      x[l + 1] = v.y;
      x[l + 2] = v.z;
      x[l + 3] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) x[l + u] = j + u < limbs ? __ldg(p + j + u) : 0u;
    }
  }
}

template <int LPT>
__device__ __forceinline__ void store(uint32_t* p, const uint32_t (&x)[LPT],
                                      int k, int limbs, int vec) {
  const int j0 = k * LPT;
#pragma unroll
  for (int l = 0; l < LPT; l += 4) {
    const int j = j0 + l;
    if (vec && j + 4 <= limbs) {
      *reinterpret_cast<uint4*>(p + j) =
          make_uint4(x[l], x[l + 1], x[l + 2], x[l + 3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j + u < limbs) p[j + u] = x[l + u];
    }
  }
}

// (r, s0, s1) += x * w, this thread's limbs of x and one broadcast word w,
// as two carry chains: the low halves into limbs l (mul_lo), the high
// halves into limbs l + 1 (mul_hi). mul_lo leaves r[0] final for the step,
// so a shuffle of it can overlap mul_hi.
template <int LPT>
__device__ __forceinline__ void mul_lo(uint32_t (&r)[LPT], uint32_t& s0,
                                       uint32_t& s1,
                                       const uint32_t (&x)[LPT],
                                       uint32_t w) {
  r[0] = mad_lo_cc(x[0], w, r[0]);
#pragma unroll
  for (int l = 1; l < LPT; ++l) r[l] = madc_lo_cc(x[l], w, r[l]);
  s0 = addc_cc(s0, 0);
  s1 = addc(s1, 0);
}

template <int LPT>
__device__ __forceinline__ void mul_hi(uint32_t (&r)[LPT], uint32_t& s0,
                                       uint32_t& s1,
                                       const uint32_t (&x)[LPT],
                                       uint32_t w) {
  r[1] = mad_hi_cc(x[0], w, r[1]);
#pragma unroll
  for (int l = 1; l < LPT - 1; ++l) r[l + 1] = madc_hi_cc(x[l], w, r[l + 1]);
  s0 = madc_hi_cc(x[LPT - 1], w, s0);
  s1 = addc(s1, 0);
}

// a = a * b * R^-1 mod m for the group's operands (a, b < m).
template <int TPI, int LPT>
__device__ __forceinline__ void montmul(uint32_t (&a)[LPT],
                                        const uint32_t (&b)[LPT],
                                        const uint32_t (&m)[LPT],
                                        uint32_t n_prime, int limbs,
                                        const Lane<TPI>& g) {
  uint32_t r[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) r[l] = 0;
  uint32_t s0 = 0, s1 = 0;
  // CIOS step for b's limb `l` of thread `owner`
  const auto step = [&](int owner, int l) {
    const uint32_t bi = __shfl_sync(kWarp, b[l], owner, TPI);
    mul_lo(r, s0, s1, a, bi);
    const uint32_t q = __shfl_sync(kWarp, r[0], 0, TPI) * n_prime;
    mul_hi(r, s0, s1, a, bi);
    mul_lo(r, s0, s1, m, q);
    // shift down one word (thread 0's r[0] is now 0 mod 2^32): the
    // neighbour's r[0] is final once q m's low halves are in
    uint32_t next = __shfl_down_sync(kWarp, r[0], 1, TPI);
    mul_hi(r, s0, s1, m, q);
    if (g.k == TPI - 1) next = 0;
#pragma unroll
    for (int u = 0; u < LPT - 1; ++u) r[u] = r[u + 1];
    r[LPT - 1] = add_cc(s0, next);
    s0 = addc(s1, 0);
    s1 = 0;
  };
  // the owners all of whose limbs count, then the masked tail's owner
  const int full = limbs / LPT;
#pragma unroll 1
  for (int owner = 0; owner < full; ++owner) {
#pragma unroll
    for (int l = 0; l < LPT; ++l) step(owner, l);
  }
  const int rest = limbs - full * LPT;
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    if (l >= rest) break;
    step(full, l);
  }

  // resolve: each thread's s0 (its limb LPT) into the next thread's limb 0
  uint32_t up = __shfl_up_sync(kWarp, s0, 1, TPI);
  const uint32_t top_word = __shfl_sync(kWarp, s0, TPI - 1, TPI);
  if (g.k == 0) up = 0;
  r[0] = add_cc(r[0], up);
#pragma unroll
  for (int l = 1; l < LPT; ++l) r[l] = addc_cc(r[l], 0);
  const uint32_t gen = addc(0, 0);
  uint32_t ones = r[0];
#pragma unroll
  for (int l = 1; l < LPT; ++l) ones &= r[l];
  uint32_t G = g.vote(gen != 0), P = g.vote(ones == 0xFFFFFFFFu);
  uint64_t y = ((uint64_t)G << 1) + P;
  const uint32_t cin = (uint32_t)(((y ^ P) >> g.k) & 1u);
  const uint32_t top = top_word + (uint32_t)((y >> TPI) & 1u);
  r[0] = add_cc(r[0], cin);
#pragma unroll
  for (int l = 1; l < LPT; ++l) r[l] = addc_cc(r[l], 0);
  (void)addc(0, 0);

  // t < 2m: subtract m once where t >= m (borrows resolved as carries)
  uint32_t d[LPT];
  d[0] = sub_cc(r[0], m[0]);
#pragma unroll
  for (int l = 1; l < LPT; ++l) d[l] = subc_cc(r[l], m[l]);
  const uint32_t borrow = subc(0, 0);
  uint32_t any = d[0];
#pragma unroll
  for (int l = 1; l < LPT; ++l) any |= d[l];
  G = g.vote(borrow != 0);
  P = g.vote(any == 0);
  y = ((uint64_t)G << 1) + P;
  const uint32_t bin = (uint32_t)(((y ^ P) >> g.k) & 1u);
  const bool take = top != 0 || ((y >> TPI) & 1u) == 0;
  d[0] = sub_cc(d[0], bin);
#pragma unroll
  for (int l = 1; l < LPT; ++l) d[l] = subc_cc(d[l], 0);
  (void)subc(0, 0);
#pragma unroll
  for (int l = 0; l < LPT; ++l) a[l] = take ? d[l] : r[l];
}

// lanes rounded up to whole warps of groups
template <int TPI>
__host__ __device__ __forceinline__ long long padded_lanes(long long lanes) {
  constexpr int per_warp = 32 / TPI;
  return (lanes + per_warp - 1) / per_warp * per_warp;
}

// One group a (lane, slice): fold the slice's rows, then the fix-up if
// given, and write the product to out[slice, lane].
template <int TPI, int LPT>
__global__ void __launch_bounds__(kBlock, 4) montfold(const FoldArgs f) {
  // Every group of a warp folds the same slice of rows (the lanes are
  // padded to whole warps), so the row loop is uniform in the warp and
  // every lane takes part in every shuffle. Padding groups repeat the last
  // lane's work, unstored; whole warps past the end leave.
  const long long padded = padded_lanes<TPI>(f.lanes);
  const long long gid = ((long long)blockIdx.x * kBlock + threadIdx.x) / TPI;
  if (gid >= padded * f.split) return;
  const Lane<TPI> g;
  const long long s = gid / padded;
  const bool live = gid - s * padded < f.lanes;
  const long long x = live ? gid - s * padded : f.lanes - 1;
  const long long lo = s * f.rows / f.split;
  const long long hi = (s + 1) * f.rows / f.split;
  uint32_t m[LPT], acc[LPT], b[LPT];
  load(m, f.m, g.k, f.limbs, f.vec);
  load(acc, row_ptr(f, lo) + x * f.limbs, g.k, f.limbs, f.vec);
#pragma unroll 1
  for (long long p = lo + 1; p < hi; ++p) {
    load(b, row_ptr(f, p) + x * f.limbs, g.k, f.limbs, f.vec);
    montmul(acc, b, m, f.n_prime, f.limbs, g);
  }
  if (f.fix != nullptr) {
    load(b, f.fix, g.k, f.limbs, f.vec);
    montmul(acc, b, m, f.n_prime, f.limbs, g);
  }
  if (live) store(f.out + (s * f.lanes + x) * f.limbs, acc, g.k, f.limbs,
                  f.vec);
}

// a = a * b * R^-1 mod m for one thread; a (L words) and t (L + 2 words)
// live in `work` at stride `ws`, b and m in device memory.
__device__ void montmul_wide(uint32_t* a, uint32_t* t, long long ws,
                             const uint32_t* b, const uint32_t* m, int L,
                             uint32_t n_prime) {
  for (int j = 0; j < L + 2; ++j) t[j * ws] = 0;
  for (int i = 0; i < L; ++i) {
    const uint64_t bi = b[i];
    uint64_t c = 0;
    for (int j = 0; j < L; ++j) {
      const uint64_t s = (uint64_t)a[j * ws] * bi + t[j * ws] + c;
      t[j * ws] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[L * ws] + c;
    t[L * ws] = (uint32_t)s;
    t[(L + 1) * ws] = (uint32_t)(s >> 32);
    const uint32_t q = t[0] * n_prime;
    s = (uint64_t)q * m[0] + t[0];
    c = s >> 32;
    for (int j = 1; j < L; ++j) {
      s = (uint64_t)q * m[j] + t[j * ws] + c;
      t[(j - 1) * ws] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[L * ws] + c;
    t[(L - 1) * ws] = (uint32_t)s;
    t[L * ws] = t[(L + 1) * ws] + (uint32_t)(s >> 32);
  }
  uint32_t borrow = 0;  // t < 2m: subtract m once where t >= m
  for (int j = 0; j < L; ++j) {
    const uint64_t d = (uint64_t)t[j * ws] - m[j] - borrow;
    borrow = (uint32_t)(d >> 63);
  }
  const uint32_t mask = (t[L * ws] != 0 || borrow == 0) ? 0xFFFFFFFFu : 0u;
  borrow = 0;
  for (int j = 0; j < L; ++j) {
    const uint64_t d = (uint64_t)t[j * ws] - (m[j] & mask) - borrow;
    a[j * ws] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
}

// montfold for L above 512: one thread a (lane, slice), its
// accumulator and CIOS words in work ([2 L + 2, groups], so a warp's
// accesses coalesce).
__global__ void __launch_bounds__(kBlock) montfold_wide(const FoldArgs f,
                                                        uint32_t* work) {
  const long long n = f.lanes * f.split;
  const long long gid = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (gid >= n) return;
  const int L = f.limbs;
  const long long x = gid % f.lanes;
  const long long s = gid / f.lanes;
  const long long lo = s * f.rows / f.split;
  const long long hi = (s + 1) * f.rows / f.split;
  uint32_t* acc = work + gid;
  uint32_t* t = work + (long long)L * n + gid;
  const uint32_t* first = row_ptr(f, lo) + x * L;
  for (int j = 0; j < L; ++j) acc[j * n] = first[j];
  for (long long p = lo + 1; p < hi; ++p)
    montmul_wide(acc, t, n, row_ptr(f, p) + x * L, f.m, L, f.n_prime);
  if (f.fix != nullptr) montmul_wide(acc, t, n, f.fix, f.m, L, f.n_prime);
  uint32_t* o = f.out + gid * L;
  for (int j = 0; j < L; ++j) o[j] = acc[j * n];
}

// (TPI, LPT) of the group instances, by capacity TPI * LPT; the wrapper
// asks sda_montfold_shape which one an L takes.
constexpr int kInstances[][2] = {{4, 8},   {8, 8},   {16, 8},
                                 {16, 12}, {16, 16}, {32, 16}};
constexpr int kNumInstances = sizeof(kInstances) / sizeof(kInstances[0]);

int instance_for(int limbs) {
  for (int i = 0; i < kNumInstances; ++i)
    if (kInstances[i][0] * kInstances[i][1] >= limbs) return i;
  return -1;  // the wide kernel
}

template <int TPI, int LPT>
cudaError_t run(const FoldArgs& f, cudaStream_t stream, int* blocks_sm) {
  if (blocks_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_sm, montfold<TPI, LPT>, kBlock, 0);
  const long long blocks =
      (padded_lanes<TPI>(f.lanes) * f.split * TPI + kBlock - 1) / kBlock;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  montfold<TPI, LPT><<<(unsigned)blocks, kBlock, 0, stream>>>(f);
  return cudaGetLastError();
}

// Launches instance i on f, or (blocks_sm non-null) asks its occupancy.
cudaError_t dispatch(int i, const FoldArgs& f, cudaStream_t stream,
                     int* blocks_sm) {
  switch (i) {
    case 0: return run<4, 8>(f, stream, blocks_sm);
    case 1: return run<8, 8>(f, stream, blocks_sm);
    case 2: return run<16, 8>(f, stream, blocks_sm);
    case 3: return run<16, 12>(f, stream, blocks_sm);
    case 4: return run<16, 16>(f, stream, blocks_sm);
    default: return run<32, 16>(f, stream, blocks_sm);
  }
}

}  // namespace

// The instance that takes `limbs` and how many of its groups the current
// device holds at once: threads a group (tpi; 1 for the wide kernel),
// limbs a thread (lpt; 0 for the wide kernel), groups a block and blocks
// an SM at full occupancy, and the device's SMs.
extern "C" int sda_montfold_shape(int limbs, int* tpi, int* lpt,
                                  int* block_groups, int* blocks_sm,
                                  int* sms) {
  if (limbs < 1 || !tpi || !lpt || !block_groups || !blocks_sm || !sms)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int i = instance_for(limbs);
  if (i < 0) {
    *tpi = 1;
    *lpt = 0;
    *block_groups = kBlock;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_sm, montfold_wide, kBlock, 0);
  }
  *tpi = kInstances[i][0];
  *lpt = kInstances[i][1];
  *block_groups = kBlock / *tpi;
  return (int)dispatch(i, FoldArgs{}, nullptr, blocks_sm);
}

// For every lane x < lanes and slice s < split (balanced slices of the
// rows: s * rows / split up to (s + 1) * rows / split), the product of the
// slice's rows by montmul, times `fix` by one more montmul where `fix` is
// not null, into out + (s * lanes + x) * limbs. Row 0 of lane x is at
// a + x * limbs, row p >= 1 at b + (p - 1) * row_stride + x * limbs (b may
// be null when rows == 1). Every operand (limbs words, least significant
// first) must be below m, which is odd, in device memory like every
// pointer here. Strides are in uint32 words. L = limbs above 512 takes the
// wide kernel, which needs `work`, a device workspace of
// (2 limbs + 2) * lanes * split words; other L ignore it.
extern "C" int sda_montfold(const uint32_t* a, const uint32_t* b,
                            long long row_stride, long long rows,
                            long long lanes, const uint32_t* m, int limbs,
                            uint32_t n_prime, const uint32_t* fix,
                            long long split, uint32_t* out, uint32_t* work,
                            void* stream) {
  const int i = instance_for(limbs);
  if (limbs < 1 || rows < 1 || lanes < 0 || split < 1 || split > rows ||
      a == nullptr || m == nullptr || out == nullptr ||
      (rows > 1 && b == nullptr) || (i < 0 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) return (int)cudaSuccess;
  const auto aligned = [](const void* p) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  FoldArgs f{a,   b,   row_stride, rows,  lanes,   split,
             m,   fix, out,        limbs, n_prime, 0};
  f.vec = limbs % 4 == 0 && row_stride % 4 == 0 && aligned(a) &&
          aligned(b) && aligned(m) && aligned(fix) && aligned(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (i >= 0) return (int)dispatch(i, f, s, nullptr);
  const long long blocks = (lanes * split + kBlock - 1) / kBlock;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  montfold_wide<<<(unsigned)blocks, kBlock, 0, s>>>(f, work);
  return (int)cudaGetLastError();
}
