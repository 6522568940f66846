// Tensor-core and async-copy pieces of the port's ABFT GEMM kernels, for
// Hopper (sm_90a): warp-level mma.sync, cp.async, and the one ring-and-
// fragment mainloop that kernel #1's tensor-core route (abft_matmul.cu) and
// kernel #2's tensor-core route (abft_matmul_acc.cu) both run.
//
// One operand word is 32 bits: one fp32 value (TF32 mma, m16n8k8), two
// bf16 values (m16n8k16) or four int8 values (m16n8k32).  With E values a
// word, the three products share one fragment layout (g = lane / 4,
// t = lane % 4):
//   A (row-major, 16 x 8E): a0 = (row g, word t), a1 = (g + 8, t),
//                           a2 = (g, t + 4),       a3 = (g + 8, t + 4)
//   B (8E x 8):             b0 = k rows E t .. E t + E - 1 of column g,
//                           b1 = the same k rows + 4E
//   C (16 x 8, fp32/int32): c0 = (g, 2t), c1 = (g, 2t + 1),
//                           c2 = (g + 8, 2t), c3 = (g + 8, 2t + 1)
// (PTX ISA, "Matrix fragments for mma.m16n8k8 / k16 / k32").
//
// fp32 operands take the 3xTF32 split: x = hi + lo with hi = x rounded to
// TF32 (nearest, ties away) and lo = (x - hi) rounded to TF32, both formed
// in registers at fragment load; a.b is summed as a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi (small terms first), which keeps about 2^-21 of each product
// where one TF32 pass keeps 2^-11.
//
// The mainloop (`ring_mainloop`): a CTA of 8 warps owns a (BM, BN) tile,
// (128, 128) or (128, 64); each warp a 64 x 32 (or 32 x 32) tile of
// fragments.  k moves through a STAGES-deep cp.async ring in dynamic shared
// memory, 256 bytes of k a stage (64 fp32, 128 bf16 or 256 int8
// columns), rows padded so that ldmatrix (A; bf16 B, transposed) and fp32
// B's 32-bit fragment loads hit 32 banks (int8 B's word loads, 2-way
// conflicts at most).  Each stage is walked in 8-word k steps, the
// fragments of step s + 1 loaded while step s runs.  Tiles are walked in
// groups of GROUP_M tile rows.  The tensor core sums a whole stage from
// zero into a partial and
// the caller's accumulator takes it by one fp32 add a stage (int8: int32,
// straight into the accumulator, exact).  A partial per k step instead
// costs 4 zeroed registers and 4 dependent adds per mma (fp32: per three)
// and on an H100 runs about 15 % slower at 3072^3 fp32 (bf16 20 %).  The
// accumulator is the caller's: kernel #1 starts it at 0, kernel #2 at the
// repaired C_in tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "abft_tile.cuh"

namespace abft_mma {

using abft::THREADS;

// ---- cp.async -------------------------------------------------------------

// Copy `bytes` (0 .. W) of a W-byte chunk from global to shared memory and
// zero-fill the rest; W is 4, 8 or 16 and both addresses are W-aligned.
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int w,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (w == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(bytes));
  } else if (w == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- ldmatrix -------------------------------------------------------------

// Four 8 x 8 matrices of 16-bit values from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8, and register q of every lane holds
// its part of matrix q (PTX ISA, "ldmatrix").  A 16 x 8-word A fragment
// loads as matrices (rows 0-7, words 0-3), (8-15, 0-3), (0-7, 4-7),
// (8-15, 4-7) whatever the operand type, since the fragment is fixed in
// 32-bit words.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The same, each matrix transposed: the bf16 B fragments of two n-blocks
// from a [k][n] tile.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// ---- operand words --------------------------------------------------------

template <typename T> struct Word;
template <> struct Word<float> { static constexpr int E = 1; };
template <> struct Word<__nv_bfloat16> { static constexpr int E = 2; };
template <> struct Word<int8_t> { static constexpr int E = 4; };

// TF32 rounding of an fp32 value, nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives), as two integer operations on the bits: half a
// TF32 ulp added to the magnitude, then the 13 low mantissa bits cleared,
// so that x - hi is exact.  (The conversion instruction runs on a slower
// pipe.)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(uint32_t word, uint32_t& hi,
                                           uint32_t& lo) {
  const float x = __uint_as_float(word);
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// ---- mma.sync -------------------------------------------------------------

template <typename T> struct Mma;

template <> struct Mma<float> {          // TF32 in, fp32 accumulate
  using Acc = float;
  __device__ __forceinline__ static void run(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <> struct Mma<__nv_bfloat16> {  // bf16 in, fp32 accumulate
  using Acc = float;
  __device__ __forceinline__ static void run(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <> struct Mma<int8_t> {         // s8 in, s32 accumulate (exact)
  using Acc = int;
  __device__ __forceinline__ static void run(int (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// Fragments of one 8-word k step of a warp's (16 MF) x (8 NF) tile.
template <int MF, int NF>
struct Frags {
  uint32_t a[MF][4];
  uint32_t b[NF][2];
};

// One k step run into `part`: part += A_frag . B_frag on the tensor core,
// for fp32 words the three 3xTF32 terms, small ones first, each word split
// into TF32 hi and lo in registers.
template <typename T, int MF, int NF>
__device__ __forceinline__ void mma_step(typename Mma<T>::Acc (&part)[MF][NF][4],
                                         const Frags<MF, NF>& fr) {
  if constexpr (sizeof(T) == 4) {
    uint32_t bh[NF][2], bl[NF][2];
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) split_tf32(fr.b[j][r], bh[j][r], bl[j][r]);
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(fr.a[i][r], ah[r], al[r]);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        Mma<T>::run(part[i][j], al, bh[j]);
        Mma<T>::run(part[i][j], ah, bl[j]);
        Mma<T>::run(part[i][j], ah, bh[j]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j) Mma<T>::run(part[i][j], fr.a[i], fr.b[j]);
  }
}

// ---- the ring -------------------------------------------------------------

template <int S> struct Raw;
template <> struct Raw<1> { using type = uint8_t; };
template <> struct Raw<2> { using type = uint16_t; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

constexpr int SLAB = 256;       // bytes of k per stage in a row of A
constexpr int A_ROW = SLAB + 16;  // padded: fragment rows 4 banks apart
constexpr int STAGES = 3;         // cp.async stages in the ring

template <typename T, int BM, int BN>
struct TileCfg {
  static constexpr int S = sizeof(T);
  static constexpr int E = Word<T>::E;
  static constexpr int BK = SLAB / S;                    // k per stage
  // fp32 rows 8 banks apart, bf16 / int8 rows 4 banks apart
  static constexpr int B_ROW = BN * S + (S == 4 ? 32 : 16);
  static constexpr int A_BYTES = BM * A_ROW;
  static constexpr int B_BYTES = BK * B_ROW;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int CS_ROW = BN + 4;                  // staged C, words
  static constexpr int STAGED = BM * CS_ROW * 4;
  static constexpr int EPI = abft::Smem<float, BM, BN>::EPI;
  static constexpr int SMEM = RING > STAGED ? (RING > EPI ? RING : EPI)
                                            : (STAGED > EPI ? STAGED : EPI);
  static constexpr int WARPS_N = BN / 32;                // warp tile 32 wide
  static constexpr int WARPS_M = THREADS / 32 / WARPS_N;
  static constexpr int WM = BM / WARPS_M;                // 64 or 32 rows
  static constexpr int MF = WM / 16;
  static constexpr int NF = 4;
  static constexpr int KSTEPS = SLAB / 32;               // 8-word k steps
  // the slot `ring_prefetch` leaves free holds kernel #2's prologue
  static_assert(STAGE >= STAGED && STAGE >= EPI, "prologue slot");
};

// One stage: A[m0:+BM, kb:+BK] and B[kb:+BK, n0:+BN] into shared memory,
// zero past m, k and n; chunks of wa / wb bytes by cp.async, or element by
// element where the width is under 4 bytes.
template <typename T, int BM, int BN>
__device__ __forceinline__ void load_stage(
    const T* __restrict__ a, const T* __restrict__ b, int m, int k, int n,
    int m0, int n0, int kb, unsigned char* as, unsigned char* bs, int wa,
    int wb) {
  using C = TileCfg<T, BM, BN>;
  using R = typename Raw<sizeof(T)>::type;
  constexpr int S = C::S;
  const int tid = threadIdx.x;
  if (wa >= 4) {
    // per_row = SLAB / wa chunks a row, a power of two: shifts, not division
    const int per_row = SLAB / wa, lg = 31 - __clz(per_row), v = wa / S;
    for (int c = tid; c < BM * per_row; c += THREADS) {
      const int r = c >> lg, kc = (c & (per_row - 1)) * v;
      const int gr = m0 + r, gk = kb + kc;
      const int valid = (gr < m && gk < k) ? min(v, k - gk) : 0;
      const T* src = valid ? a + static_cast<long long>(gr) * k + gk : a;
      cp_async(as + r * A_ROW + kc * S, src, wa, valid * S);
    }
  } else {
    const R* ra = reinterpret_cast<const R*>(a);
    for (int e = tid; e < BM * C::BK; e += THREADS) {
      const int r = e / C::BK, kc = e % C::BK;
      const int gr = m0 + r, gk = kb + kc;
      *reinterpret_cast<R*>(as + r * A_ROW + kc * S) =
          (gr < m && gk < k) ? ra[static_cast<long long>(gr) * k + gk] : R(0);
    }
  }
  if (wb >= 4) {
    const int per_row = BN * S / wb, lg = 31 - __clz(per_row), v = wb / S;
    for (int c = tid; c < C::BK * per_row; c += THREADS) {
      const int r = c >> lg, nc = (c & (per_row - 1)) * v;
      const int gk = kb + r, gc = n0 + nc;
      const int valid = (gk < k && gc < n) ? min(v, n - gc) : 0;
      const T* src = valid ? b + static_cast<long long>(gk) * n + gc : b;
      cp_async(bs + r * C::B_ROW + nc * S, src, wb, valid * S);
    }
  } else {
    const R* rb = reinterpret_cast<const R*>(b);
    for (int e = tid; e < C::BK * BN; e += THREADS) {
      const int r = e / BN, nc = e % BN;
      const int gk = kb + r, gc = n0 + nc;
      *reinterpret_cast<R*>(bs + r * C::B_ROW + nc * S) =
          (gk < k && gc < n) ? rb[static_cast<long long>(gk) * n + gc] : R(0);
    }
  }
}

// int8 B: a warp's 32 columns are permuted so that lane g's column of
// n-block j is wn0 + 4 g + j (PTX leaves the n order to us as long as C's
// follows it, `frag_col`): the four columns of a lane are adjacent, so one
// 32-bit load per k row gives all four, and four rows transpose into the
// four n-blocks' words (k rows kr .. kr + 3 each) by byte permutes.
__device__ __forceinline__ void b_words_i8(uint32_t (&w)[4],
                                           const unsigned char* p, int row) {
  uint32_t r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    r[e] = *reinterpret_cast<const uint32_t*>(p + e * row);
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}

// The tile column of C fragment column 2 t + h (h = 0, 1) of n-block j of
// the warp at column wn0: n-block order for fp32 and bf16, the permuted
// order of `b_words_i8` for int8.
template <typename T>
__device__ __forceinline__ int frag_col(int wn0, int j, int t, int h) {
  if constexpr (sizeof(T) == 1) return wn0 + 4 * (2 * t + h) + j;
  return wn0 + 8 * j + 2 * t + h;
}

// The fragments of k step ks of the stage at `as` (A) / `bs` (B).
template <typename T, int BM, int BN>
__device__ __forceinline__ void load_frags(
    Frags<TileCfg<T, BM, BN>::MF, 4>& fr, const unsigned char* as,
    const unsigned char* bs, int ks, int wm0, int wn0) {
  using C = TileCfg<T, BM, BN>;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int arow = (lane % 8) + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
    ldsm_x4(fr.a[i], as + (wm0 + 16 * i + arow) * A_ROW + ks * 32
                         + 16 * (lane / 16));
  if constexpr (sizeof(T) == 2) {
    // lane l: k row ks * 16 + 8 ((l / 8) % 2) + l % 8 of n-block
    // 2 jj + l / 16
#pragma unroll
    for (int jj = 0; jj < C::NF / 2; ++jj) {
      uint32_t r[4];
      ldsm_x4_trans(r, bs + (ks * 16 + arow) * C::B_ROW
                           + (wn0 + 8 * (2 * jj + lane / 16)) * 2);
      fr.b[2 * jj][0] = r[0];
      fr.b[2 * jj][1] = r[1];
      fr.b[2 * jj + 1][0] = r[2];
      fr.b[2 * jj + 1][1] = r[3];
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < C::NF; ++j) {
      const unsigned char* p = bs + (ks * 8 + t) * C::B_ROW
                               + (wn0 + 8 * j + g) * 4;
      fr.b[j][0] = *reinterpret_cast<const uint32_t*>(p);
      fr.b[j][1] = *reinterpret_cast<const uint32_t*>(p + 4 * C::B_ROW);
    }
  } else {
    static_assert(C::NF == 4, "int8 B: four n-blocks a lane word");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[4];
      b_words_i8(w, bs + (ks * 32 + 16 * h + 4 * t) * C::B_ROW + wn0 + 4 * g,
                 C::B_ROW);
#pragma unroll
      for (int j = 0; j < C::NF; ++j) fr.b[j][h] = w[j];
    }
  }
}

constexpr int GROUP_M = 4;   // tile rows a group of the grid's walk

// The (tile row, tile column) of this CTA of a 1-D grid over mt x nt
// tiles, in groups of GROUP_M tile rows walked column by column (the last
// group takes the rows left), so that CTAs that start close together
// share their A and B panels in L2: on an H100 both kernels run 3-5 %
// faster at 3072^3 than with a walk row by row.
__device__ __forceinline__ void tile_of(int mt, int nt, int& ti, int& tj) {
  const int id = blockIdx.x;
  const int per = GROUP_M * nt;
  const int first = (id / per) * GROUP_M;
  const int rows = min(mt - first, GROUP_M);
  ti = first + (id % per) % rows;
  tj = (id % per) / rows;
}

// The ring's first STAGES - 1 stages, issued before the caller's own
// set-up (kernel #2's prologue), which may use the last slot's bytes
// (`free_slot`) until `ring_mainloop` starts.
template <typename T, int BM, int BN>
__device__ __forceinline__ void ring_prefetch(
    const T* __restrict__ a, const T* __restrict__ b, int m, int k, int n,
    int m0, int n0, int wa, int wb, unsigned char* smem) {
  using C = TileCfg<T, BM, BN>;
  const int kt_n = (k + C::BK - 1) / C::BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n)
      load_stage<T, BM, BN>(a, b, m, k, n, m0, n0, s * C::BK,
                            smem + s * C::STAGE,
                            smem + s * C::STAGE + C::A_BYTES, wa, wb);
    cp_async_commit();
  }
}

template <typename T, int BM, int BN>
__device__ __forceinline__ unsigned char* free_slot(unsigned char* smem) {
  return smem + (STAGES - 1) * TileCfg<T, BM, BN>::STAGE;
}

// acc += A[m0:+BM, :] @ B[:, n0:+BN] through the ring in `smem` (the
// caller's dynamic shared memory, at least TileCfg::RING bytes), after
// `ring_prefetch`; the ring's bytes are free again when it returns.
// Ragged m, k and n read as zeros; wa / wb are the copy widths of A and B
// (`copy_width`).
//
// Step kt waits for stage kt, refills the slot of stage kt - 1 with stage
// kt + STAGES - 1 (one barrier a stage) and runs stage kt's k steps, the
// fragments of step s + 1 loaded while step s runs.  fp32 and bf16: the
// tensor core sums the stage from zero into `part` and the running sum
// takes it by one fp32 add, in round-to-nearest, since the tensor core's
// own accumulation may truncate and that error would grow with k (a late
// SUMMA step's C_in is far larger than one stage's partial).  int8 sums
// exactly into `acc` in int32.
template <typename T, int BM, int BN>
__device__ __forceinline__ void ring_mainloop(
    const T* __restrict__ a, const T* __restrict__ b, int m, int k, int n,
    int m0, int n0, int wa, int wb,
    typename Mma<T>::Acc (&acc)[TileCfg<T, BM, BN>::MF][4][4],
    unsigned char* smem) {
  using C = TileCfg<T, BM, BN>;
  using Acc = typename Mma<T>::Acc;
  const int warp = threadIdx.x / 32;
  const int wm0 = (warp / C::WARPS_N) * C::WM;
  const int wn0 = (warp % C::WARPS_N) * 32;
  const int kt_n = (k + C::BK - 1) / C::BK;
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage kt landed; stage kt - 1 is free to refill
    const int nxt = kt + STAGES - 1;
    if (nxt < kt_n) {
      unsigned char* st = smem + (nxt % STAGES) * C::STAGE;
      load_stage<T, BM, BN>(a, b, m, k, n, m0, n0, nxt * C::BK, st,
                            st + C::A_BYTES, wa, wb);
    }
    cp_async_commit();
    const unsigned char* as = smem + (kt % STAGES) * C::STAGE;
    const unsigned char* bs = as + C::A_BYTES;
    Acc part[C::MF][C::NF][4];
    if constexpr (sizeof(T) != 1) {
#pragma unroll
      for (int i = 0; i < C::MF; ++i)
#pragma unroll
        for (int j = 0; j < C::NF; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) part[i][j][r] = Acc(0);
    }
    Frags<C::MF, C::NF> fr[2];
    load_frags<T, BM, BN>(fr[0], as, bs, 0, wm0, wn0);
#pragma unroll
    for (int ks = 0; ks < C::KSTEPS; ++ks) {
      if (ks + 1 < C::KSTEPS)
        load_frags<T, BM, BN>(fr[(ks + 1) % 2], as, bs, ks + 1, wm0, wn0);
      if constexpr (sizeof(T) == 1)
        mma_step<T, C::MF, C::NF>(acc, fr[ks % 2]);
      else
        mma_step<T, C::MF, C::NF>(part, fr[ks % 2]);
    }
    if constexpr (sizeof(T) != 1) {
#pragma unroll
      for (int i = 0; i < C::MF; ++i)
#pragma unroll
        for (int j = 0; j < C::NF; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
    }
  }
  cp_async_wait<0>();
  __syncthreads();     // every warp is done with the ring
}

// The fragments as a BM x BN tile in `smem` (rows of CS_ROW words), read
// back in the epilogue's (ty + 16 i, tx + 16 j) layout.
template <typename T, int BM, int BN>
__device__ __forceinline__ void frags_to_tile(
    const typename Mma<T>::Acc (&acc)[TileCfg<T, BM, BN>::MF][4][4],
    typename Mma<T>::Acc (&v)[BM / 16][BN / 16], unsigned char* smem) {
  using C = TileCfg<T, BM, BN>;
  using TC = typename Mma<T>::Acc;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm0 = (warp / C::WARPS_N) * C::WM;
  const int wn0 = (warp % C::WARPS_N) * 32;
  TC* cs = reinterpret_cast<TC*>(smem);
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int j = 0; j < C::NF; ++j) {
      const int row = wm0 + 16 * i + g;
      const int c0 = frag_col<T>(wn0, j, t, 0), c1 = frag_col<T>(wn0, j, t, 1);
      cs[row * C::CS_ROW + c0] = acc[i][j][0];
      cs[row * C::CS_ROW + c1] = acc[i][j][1];
      cs[(row + 8) * C::CS_ROW + c0] = acc[i][j][2];
      cs[(row + 8) * C::CS_ROW + c1] = acc[i][j][3];
    }
  __syncthreads();
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      v[i][j] = cs[(ty + 16 * i) * C::CS_ROW + tx + 16 * j];
  __syncthreads();     // the bytes are free again
}

// The inverse: a tile held in the (ty + 16 i, tx + 16 j) layout into the
// fragments, through `smem`.
template <typename T, int BM, int BN>
__device__ __forceinline__ void tile_to_frags(
    const typename Mma<T>::Acc (&v)[BM / 16][BN / 16],
    typename Mma<T>::Acc (&acc)[TileCfg<T, BM, BN>::MF][4][4],
    unsigned char* smem) {
  using C = TileCfg<T, BM, BN>;
  using TC = typename Mma<T>::Acc;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm0 = (warp / C::WARPS_N) * C::WM;
  const int wn0 = (warp % C::WARPS_N) * 32;
  const int tx = tid % 16, ty = tid / 16;
  TC* cs = reinterpret_cast<TC*>(smem);
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      cs[(ty + 16 * i) * C::CS_ROW + tx + 16 * j] = v[i][j];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int j = 0; j < C::NF; ++j) {
      const int row = wm0 + 16 * i + g;
      const int c0 = frag_col<T>(wn0, j, t, 0), c1 = frag_col<T>(wn0, j, t, 1);
      acc[i][j][0] = cs[row * C::CS_ROW + c0];
      acc[i][j][1] = cs[row * C::CS_ROW + c1];
      acc[i][j][2] = cs[(row + 8) * C::CS_ROW + c0];
      acc[i][j][3] = cs[(row + 8) * C::CS_ROW + c1];
    }
  __syncthreads();
}

// The widest copy, from `maxw` down to the element size, that divides the
// base pointer and the row stride (host side, both kernels' launchers).
inline int copy_width(const void* p, long long row_bytes, int elem, int maxw) {
  for (int w = maxw; w > elem; w /= 2)
    if (reinterpret_cast<uintptr_t>(p) % w == 0 && row_bytes % w == 0)
      return w;
  return elem;
}

}  // namespace abft_mma
