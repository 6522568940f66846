// Tensor-core and async-copy helpers of the port's one-shot ABFT GEMM
// (abft_matmul.cu), for Hopper (sm_90a): warp-level mma.sync and cp.async.
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
// TF32 (nearest, ties away) and lo = (x - hi) rounded to TF32,
// both formed in registers at fragment load; a.b is summed as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (small terms first), which keeps
// about 2^-21 of each product where one TF32 pass keeps 2^-11.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace abft_mma {

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
// pipe; this split runs once per fragment word.)
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

// One k step of a warp's (16 MF) x (8 NF) tile: acc += A_frag . B_frag.
// The tensor core sums one k step from zero (for fp32 words the 3xTF32
// terms, small ones first); the running sum is an fp32 add outside it, in
// round-to-nearest, since the tensor core's own accumulation may truncate
// and that error would grow with k.  int8 sums exactly in the tensor core.
template <typename T, int MF, int NF>
__device__ __forceinline__ void mma_step(
    typename Mma<T>::Acc (&acc)[MF][NF][4], const uint32_t (&a)[MF][4],
    const uint32_t (&b)[NF][2]) {
  if constexpr (sizeof(T) == 1) {
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j) Mma<T>::run(acc[i][j], a[i], b[j]);
  } else if constexpr (sizeof(T) == 4) {
    uint32_t ah[MF][4], al[MF][4], bh[NF][2], bl[NF][2];
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(a[i][r], ah[i][r], al[i][r]);
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) split_tf32(b[j][r], bh[j][r], bl[j][r]);
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        Mma<T>::run(s, al[i], bh[j]);
        Mma<T>::run(s, ah[i], bl[j]);
        Mma<T>::run(s, ah[i], bh[j]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += s[r];
      }
  } else {
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        Mma<T>::run(s, a[i], b[j]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += s[r];
      }
  }
}

}  // namespace abft_mma
