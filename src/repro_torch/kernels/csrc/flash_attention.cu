// Flash-attention forward with an in-kernel ABFT checksum, for Hopper
// (sm_90a), on tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_call
// (reached through flash_attention_pallas and flash_attention_checked).
// Q [BH, Sq, D], K and V [BH, Sk, D] (fp32 or bf16), O [BH, Sq, D] in Q's
// type.  For each row: fp32 scores s = (q . k) * scale, then
// softcap * tanhf(s / softcap) when a softcap is set; a positional mask
// (q_pos the global row, k_pos the global key, top left aligned): causal
// q_pos >= k_pos, a two-sided window |q_pos - k_pos| < window; the online
// softmax (m, l, acc) with NEG_INF = -1e30 (not -inf, so a fully masked
// chunk gives corr = 1) and p masked to 0 explicitly; o = acc /
// max(l, 1e-30) (NaN kept), rounded once to O's type.  exp is taken as
// 2^x of log2(e)-prescaled scores by the special-function unit
// (ex2.approx, about 2 ulp; the row max m is kept in that domain), held to
// the plain version's expf by the same tolerance; tanhf and division are
// IEEE: the build has no fast math.
//
// CHECKSUM adds the reference's checksum recurrence, carried beside the
// state: cs <- cs * corr + p . vsum (vsum = sum_d v, per key) and a second
// row sum l2 <- l2 * corr + sum p, both out of the tensor core (below), a
// path apart from l's, which sums p on CUDA cores.  The epilogue writes
// per row r_pv = |sum_d o - cs/l| / (|cs/l| + 1) over the fp32 o and
// r_l = |l2/l - 1|, both 0 on a row with no live key.  Liveness is read
// from l2 > 0, not from l, the state a fault hits: a NaN or non-positive l
// on a live row gives r_l = inf (the reference gates on l > 0 and misses
// such a fault);
// the wrapper takes the max over each bq-row tile with torch.amax, which
// keeps a NaN.
//
// Design (FlashAttention-2's warp tiling on mma.sync).  A CTA of 4 or 8
// warps owns 16 rows a warp of one bh; the grid is flat in grid.x over the
// (bh, q-tile) pairs (B.H bounded only by 2^31 - 1), each bh's q-tiles
// walked last first, so under a causal mask the heaviest tiles start
// first and the CTAs in flight share a few heads' K and V in L2.  The CTA
// loops over its keys in chunks of BC, K and V through a 2-stage cp.async
// ring (copy widths from pointer and stride, as kernel #1's): chunk i + 1
// is issued right after the barrier of chunk i, before its math.  Q stays
// in shared memory.  Tiles per (type, D) (Cfg; rows a CTA x keys a chunk,
// shared memory):
//   fp32 D = 64: 128 x 64, 141 KB;   bf16 D = 64: 64 x 64, 45 KB (3 CTAs
//   fp32 D = 128: 64 x 32, 135 KB;   an SM); bf16 D = 128: 64 x 64, 85 KB;
//   fp32 D = 256: 64 x 16, 164 KB;   bf16 D = 256: 128 x 32, 132 KB.
// Scores and the online softmax live in the mma C fragments: a thread
// holds rows g and g + 8 of its warp's 16 (g = lane / 4), the row max and
// row sum are two quad shuffles, P never goes through shared memory.
//   * bf16: QK^T is m16n8k16 straight from bf16 Q and K (exact products,
//     fp32 sums).  P enters P.V as hi + lo, two bf16 words (one bf16 P
//     misses one bf16 ulp of the output), V exact: two mma a k step.
//     The C -> A relayout is the identity.
//   * fp32: 3xTF32 m16n8k8 in both products (x = hi + lo, each TF32 by
//     abft_mma.cuh's split_tf32, small terms first: one TF32 pass in
//     either product misses RTOL = 1e-5).  Q and P are split in registers
//     at fragment load; each landed chunk of K and V is split once for the
//     CTA (hi in place, lo beside it, behind a second barrier) instead of
//     by every warp at every fragment it loads.  In QK^T the k step's d
//     order is permuted (A word t <-> d 2t, word t + 4 <-> d 2t + 1), so a
//     thread's Q and K words are one 64-bit load each.  In P.V the A layout (a0 = (g, t),
//     a2 = (g, t + 4)) is not the C layout (c0, c1 = (g, 2t), (g, 2t + 1)):
//     the keys of each k8 step are permuted instead (word t <-> key 2t,
//     t + 4 <-> key 2t + 1) and V's B words load rows 2t and 2t + 1 to
//     match; a sum over keys does not care about their order.  Each
//     chunk's P.V is summed by the tensor core from zero into a partial
//     (8 n-blocks at a time) that acc takes by one fp32 add, as kernel #1's
//     stages: the tensor core's own accumulation may truncate.
//   * The checksums ride the P.V product, as the paper's column checksum
//     rides a GEMM: V gains one n8 column tile [vsum_hi, vsum_lo, 1, 0 ...]
//     in the operand type (vsum summed in fp32 by the CTA from the staged
//     chunk), so cs and l2 come out of the tensor core, 1/8 more P.V work
//     at D = 64.
// Only the passes that some row of a warp must mask (the causal diagonal,
// the window edges, ragged keys) mask per element, from one admitted key
// range a row; chunks no row of the warp may see are skipped (the
// reference's recurrence is the identity there: m stays, corr = 1,
// p = 0).  The chaos inject of the reference (delta into acc[row, 0], held
// by the lane with t = 0, or into l[row], held by all four lanes of the
// quad, of bh 0 once keys [0, key_end) are folded) lands at that point of
// the sweep: a chunk that straddles key_end is run as two masked passes.
// Rows past Sq and keys past Sk are zero in shared memory and masked,
// never read as data.
//
// What bounds it on an H100: operations.  4 D per (row, key) pair the
// mask admits (q.k and p.v): 2.1 GFLOP per head at S = 4096, D = 64,
// causal, against 4.2 MB of Q, K, V and O in fp32, about 500 flops a
// byte.  The least time is those operations at the tensor-core rate (989
// TFLOP/s bf16, 495/3 for fp32 through 3xTF32; 67 TFLOP/s on CUDA cores).
// A second floor in bf16 at D = 64: one exp per admitted pair on the
// special-function units, 0.47 G of them at Qwen2-0.5B's causal shape,
// which take about as long as the bf16 mma bound.  The
// kernel issues its products with mma.sync, which reaches 325 TFLOP/s in
// TF32 and 649 in bf16 on an H100 (66 % of the published dense rates;
// tools/mma_rate.py), so 3xTF32 alone needs 1.11 ms there; and a warp's
// chunk is a dependent chain (QK^T, the row max, exp, the row sum, P.V)
// that 8 to 12 warps an SM do not hide.  What the design leaves: wgmma
// (A from registers for P, K and V K-major in shared memory), TMA with a
// producer warp and mbarriers in place of cp.async and __syncthreads,
// overlapping the softmax's exp with the next chunk's mma across warp
// groups (FlashAttention-3's ping-pong; within one warp, with mma.sync, it
// ran slower on an H100), and skipping the masked n-blocks of a diagonal
// chunk per warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "abft_mma.cuh"

namespace {

namespace am = abft_mma;

constexpr int STAGES = 2;           // K/V ring
constexpr float NEG_INF = -1e30f;

enum Kind { K_F32 = 0, K_BF16 = 1 };
enum Target { T_NONE = 0, T_ACC = 1, T_L = 2 };

// The tile of one (type, D): WARPS warps of 16 rows, BC keys a chunk.  Row
// strides in elements: fp32 Q and K rows 8 banks apart (conflict-free
// 64-bit fragment loads), fp32 V rows 4 banks apart (32-bit loads at keys
// 2t and 2t + 1), bf16 rows 4 banks apart (ldmatrix).
template <typename T, int D>
struct Cfg {
  static constexpr int S = sizeof(T);
  static constexpr bool F32 = S == 4;
  static constexpr int WARPS = (F32 && D == 64) || (!F32 && D == 256) ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BR = 16 * WARPS;                  // rows a CTA
  // CTAs an SM must hold: 3 for bf16 at D = 64 (at most 168 registers a
  // thread; faster on an H100 than 2 CTAs with more registers)
  static constexpr int MIN_CTAS = !F32 && D == 64 ? 3 : 1;
  static constexpr int BC =                              // keys a chunk
      F32 ? (D == 64 ? 64 : D == 128 ? 32 : 16) : (D <= 128 ? 64 : 32);
  static constexpr int QS = D + 8;
  static constexpr int VS = F32 ? D + 4 : D + 8;
  static constexpr int Q_BYTES = BR * QS * S;
  static constexpr int K_BYTES = BC * QS * S;
  static constexpr int V_BYTES = BC * VS * S;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int LO_BYTES = F32 ? STAGE : 0;      // fp32: K, V lo
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE + LO_BYTES + BC * 4;
  static constexpr int NS = BC / 8;                      // score n-blocks
  static constexpr int ND = D / 8;                       // output n-blocks
  static constexpr int KD = F32 ? D / 8 : D / 16;        // QK^T k steps
  static constexpr int KP = F32 ? BC / 8 : BC / 16;      // P.V k steps
  static constexpr int NG = ND < 8 ? ND : 8;             // fp32 partial
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* rows;          // [BH, Sq, 2] (CHECKSUM) or null
  int sq, sk;
  float scale;
  int causal, has_window;
  long long window;
  float softcap;        // 0: none
  int target;           // inject: T_NONE, T_ACC or T_L (bh 0 only)
  long long inj_row, inj_key_end;
  float inj_delta;
  int wq, wk, wv;       // copy widths in bytes
};

// 2^x by the special-function unit (ex2.approx.ftz: about 2 ulp, results
// under 2^-126 flushed to 0, which no softmax sum can see)
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_half, float hi_half) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_half, hi_half);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two fp32 values as bf16 hi + lo words: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// Rows [0, ROWS) of a [rows_valid, D] block into shared memory at
// `row_bytes` a row, zero past rows_valid: chunks of W bytes by cp.async.
template <typename T, int D, int ROWS, int W>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int row_bytes,
                                          const unsigned char* src,
                                          int rows_valid) {
  constexpr int RB = D * sizeof(T), PER = RB / W, N = ROWS * PER;
  constexpr int THREADS = Cfg<T, D>::THREADS;
#pragma unroll
  for (int c0 = 0; c0 < N; c0 += THREADS) {
    const int c = c0 + threadIdx.x;
    if (N % THREADS == 0 || c < N) {
      const int r = c / PER, off = (c % PER) * W;
      const bool ok = r < rows_valid;
      am::cp_async(dst + r * row_bytes + off, ok ? src + r * RB + off : src,
                   W, ok ? W : 0);
    }
  }
}

// The same for a copy width w of 16, 8 or 4 bytes, or 2-byte elements by
// plain loads where w is 2.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(unsigned char* dst, int row_bytes,
                                          const T* src, long long rows_valid,
                                          int w) {
  const int valid = rows_valid < ROWS ? static_cast<int>(rows_valid) : ROWS;
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  if (w == 16) {
    copy_rows<T, D, ROWS, 16>(dst, row_bytes, s, valid);
  } else if (w == 8) {
    copy_rows<T, D, ROWS, 8>(dst, row_bytes, s, valid);
  } else if (w == 4) {
    copy_rows<T, D, ROWS, 4>(dst, row_bytes, s, valid);
  } else {
    const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
    for (int e = threadIdx.x; e < ROWS * D; e += Cfg<T, D>::THREADS) {
      const int r = e / D, d = e % D;
      *reinterpret_cast<uint16_t*>(dst + r * row_bytes + 2 * d) =
          r < valid ? s16[r * D + d] : uint16_t(0);
    }
  }
}

__device__ __forceinline__ float2 lds64(const unsigned char* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The state of a thread: rows g (index 0) and g + 8 (index 1) of its warp.
template <typename T, int D>
struct State {
  float m[2], l[2];
  float acc[Cfg<T, D>::ND][4];
  float aug[4];                 // cs (cols 0, 1) and l2 (col 2) of the rows
};

// fp32: the 3xTF32 split of a landed chunk, once for the CTA: hi in place
// of K and V in the ring slot `st`, lo into `lo` (the same layout); with
// CHECKSUM also vsum[c] = sum_d v[c, d] of the fp32 values.  THREADS / BC
// threads a key row, PER float4 each.
template <typename T, int D, bool CHECKSUM>
__device__ __forceinline__ void split_chunk(unsigned char* st,
                                            unsigned char* lo, float* vsum) {
  using C = Cfg<T, D>;
  constexpr int TPR = C::THREADS / C::BC, PER = D / 4 / TPR;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  float vpart = 0.0f;
#pragma unroll
  for (int m = 0; m < 2; ++m) {                 // K, then V
    const int off = m == 0 ? (r * C::QS) * 4 : C::K_BYTES + (r * C::VS) * 4;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int b = off + 16 * (part * PER + i);
      uint4 x = *reinterpret_cast<const uint4*>(st + b);
      if (m == 1) vpart += __uint_as_float(x.x) + __uint_as_float(x.y) +
                           __uint_as_float(x.z) + __uint_as_float(x.w);
      uint4 h, l;
      am::split_tf32(x.x, h.x, l.x);
      am::split_tf32(x.y, h.y, l.y);
      am::split_tf32(x.z, h.z, l.z);
      am::split_tf32(x.w, h.w, l.w);
      *reinterpret_cast<uint4*>(st + b) = h;
      *reinterpret_cast<uint4*>(lo + b) = l;
    }
  }
  if (CHECKSUM) {
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      vpart += __shfl_xor_sync(0xffffffffu, vpart, o);
    if (part == 0) vsum[r] = vpart;
  }
}

// QK^T of the warp's 16 rows against the chunk's BC keys into s (fp32: K
// split into hi at `ks` and lo at `kl`).
template <typename T, int D>
__device__ __forceinline__ void scores(float (&s)[Cfg<T, D>::NS][4],
                                       const unsigned char* qs,
                                       const unsigned char* ks,
                                       const unsigned char* kl, int wrow) {
  using C = Cfg<T, D>;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < C::NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
  if constexpr (C::F32) {
#pragma unroll
    for (int kd = 0; kd < C::KD; ++kd) {
      // words t and t + 4 <-> d 2t and 2t + 1 of the k step
      const unsigned char* qr =
          qs + ((wrow + g) * C::QS + 8 * kd + 2 * t) * 4;
      const float2 x = lds64(qr), y = lds64(qr + 8 * C::QS * 4);
      uint32_t ah[4], al[4];
      am::split_tf32(__float_as_uint(x.x), ah[0], al[0]);
      am::split_tf32(__float_as_uint(y.x), ah[1], al[1]);
      am::split_tf32(__float_as_uint(x.y), ah[2], al[2]);
      am::split_tf32(__float_as_uint(y.y), ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < C::NS; ++j) {
        const int b = ((8 * j + g) * C::QS + 8 * kd + 2 * t) * 4;
        const float2 hv = lds64(ks + b), lv = lds64(kl + b);
        const uint32_t bh[2] = {__float_as_uint(hv.x), __float_as_uint(hv.y)};
        const uint32_t bl[2] = {__float_as_uint(lv.x), __float_as_uint(lv.y)};
        am::Mma<float>::run(s[j], al, bh);
        am::Mma<float>::run(s[j], ah, bl);
        am::Mma<float>::run(s[j], ah, bh);
      }
    }
  } else {
    const int arow = (lane % 8) + 8 * ((lane / 8) % 2);
    const int krow = (lane % 8) + 8 * (lane / 16);
#pragma unroll
    for (int kd = 0; kd < C::KD; ++kd) {
      uint32_t a[4];
      am::ldsm_x4(a, qs + (wrow + arow) * C::QS * 2 + kd * 32
                         + 16 * (lane / 16));
#pragma unroll
      for (int jj = 0; jj < C::NS / 2; ++jj) {
        // lane l: key 16 jj + l % 8 + 8 (l / 16), d 16 kd + 8 ((l / 8) % 2)
        uint32_t r[4];
        am::ldsm_x4(r, ks + (16 * jj + krow) * C::QS * 2 + kd * 32
                           + 16 * ((lane / 8) % 2));
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        am::Mma<__nv_bfloat16>::run(s[2 * jj], a, b0);
        am::Mma<__nv_bfloat16>::run(s[2 * jj + 1], a, b1);
      }
    }
  }
}

// The scaled, capped and masked scores into p (in place) and the online
// softmax state; returns corr of the two rows in `corr`.  MASK admits, per
// row, only the keys of [lo, hi) that the causal and window masks allow
// (one range a row, two integer operations an element).
template <typename T, int D, bool MASK>
__device__ __forceinline__ void softmax(float (&s)[Cfg<T, D>::NS][4],
                                        float (&m)[2], float (&l)[2],
                                        float (&corr)[2], const Params& prm,
                                        int row0, int c0, int lo, int hi) {
  using C = Cfg<T, D>;
  const int t = threadIdx.x % 4;
  // straight loops, one branch each: the exps of a thread interleave;
  // scores scaled by log2(e) too, for ex2
  if (prm.softcap != 0.0f) {
    const float cap = prm.softcap;
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = cap * tanhf(s[j][e] * prm.scale / cap) * LOG2E;
  } else {
    const float sl = prm.scale * LOG2E;
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sl;
  }
  // row r admits the chunk's keys c0 + 2t + 8j + (e & 1) with
  // unsigned(key - kfirst[r]) < span[r]
  int kfirst[2] = {0, 0};
  unsigned span[2] = {0u, 0u};
  if constexpr (MASK) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = row0 + 8 * r;
      long long a = lo, b = hi;
      if (prm.causal && row + 1 < b) b = row + 1;
      if (prm.has_window) {
        if (row - prm.window + 1 > a) a = row - prm.window + 1;
        if (row + prm.window < b) b = row + prm.window;
      }
      kfirst[r] = static_cast<int>(a) - (c0 + 2 * t);
      span[r] = b > a ? static_cast<unsigned>(b - a) : 0u;
    }
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (static_cast<unsigned>(8 * j + (e & 1) - kfirst[e / 2]) >=
            span[e / 2])
          s[j][e] = NEG_INF;
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < C::NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
  float m_new[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m[r], quad_max(mx[r]));
#pragma unroll
  for (int j = 0; j < C::NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(s[j][e] - m_new[e / 2]);
      if constexpr (MASK)   // p of a masked key is 0, not exp(0) on a dead row
        if (static_cast<unsigned>(8 * j + (e & 1) - kfirst[e / 2]) >=
            span[e / 2])
          p = 0.0f;
      s[j][e] = p;
      sum[e / 2] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    corr[r] = ex2(m[r] - m_new[r]);
    l[r] = l[r] * corr[r] + quad_sum(sum[r]);
    m[r] = m_new[r];
  }
}

// The augmented column tile's B words for keys k0 and k0 + 1 of the chunk:
// column 0 vsum_hi, 1 vsum_lo, 2 one, the rest zero (lane g holds column
// g).  fp32: TF32 words, one key a word; bf16: one bf16x2 word.
template <typename T>
__device__ __forceinline__ void aug_words(uint32_t& w0, uint32_t& w1,
                                          const float* vsum, int k0, int g) {
  if constexpr (sizeof(T) == 4) {
    const float v0 = vsum[k0], v1 = vsum[k0 + 1];
    const uint32_t h0 = am::tf32_rna(v0), h1 = am::tf32_rna(v1);
    if (g == 0) {
      w0 = h0;
      w1 = h1;
    } else if (g == 1) {
      w0 = am::tf32_rna(v0 - __uint_as_float(h0));
      w1 = am::tf32_rna(v1 - __uint_as_float(h1));
    } else {
      w0 = w1 = g == 2 ? __float_as_uint(1.0f) : 0u;
    }
  } else {
    uint32_t hi, lo;
    split_bf16(vsum[k0], vsum[k0 + 1], hi, lo);
    w0 = g == 0 ? hi : g == 1 ? lo : g == 2 ? pack_bf16(1.0f, 1.0f) : 0u;
    w1 = 0u;
  }
}

// acc = acc * corr + P . V (and the augmented column) for the chunk in vs.
template <typename T, int D, bool CHECKSUM>
__device__ __forceinline__ void pv(State<T, D>& st,
                                   const float (&p)[Cfg<T, D>::NS][4],
                                   const float (&corr)[2],
                                   const unsigned char* vs,
                                   const unsigned char* vl,
                                   const float* vsum) {
  using C = Cfg<T, D>;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (C::F32) {
#pragma unroll
    for (int n0 = 0; n0 < C::ND; n0 += C::NG) {
      float part[C::NG][4], apart[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < C::NG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
#pragma unroll
      for (int kp = 0; kp < C::KP; ++kp) {
        // keys 8 kp + 2t (A word t) and 8 kp + 2t + 1 (word t + 4)
        uint32_t ah[4], al[4];
        am::split_tf32(__float_as_uint(p[kp][0]), ah[0], al[0]);
        am::split_tf32(__float_as_uint(p[kp][2]), ah[1], al[1]);
        am::split_tf32(__float_as_uint(p[kp][1]), ah[2], al[2]);
        am::split_tf32(__float_as_uint(p[kp][3]), ah[3], al[3]);
        const int v0 = ((8 * kp + 2 * t) * C::VS + g) * 4;
#pragma unroll
        for (int j = 0; j < C::NG; ++j) {
          const int b0 = v0 + 32 * (n0 + j), b1 = b0 + C::VS * 4;
          const uint32_t bh[2] = {lds32(vs + b0), lds32(vs + b1)};
          const uint32_t bl[2] = {lds32(vl + b0), lds32(vl + b1)};
          am::Mma<float>::run(part[j], al, bh);
          am::Mma<float>::run(part[j], ah, bl);
          am::Mma<float>::run(part[j], ah, bh);
        }
        if (CHECKSUM && n0 == 0) {
          uint32_t b[2];
          aug_words<T>(b[0], b[1], vsum, 8 * kp + 2 * t, g);
          am::Mma<float>::run(apart, al, b);   // B is exact in TF32
          am::Mma<float>::run(apart, ah, b);
        }
      }
#pragma unroll
      for (int j = 0; j < C::NG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st.acc[n0 + j][e] = st.acc[n0 + j][e] * corr[e / 2] + part[j][e];
      if (CHECKSUM && n0 == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st.aug[e] = st.aug[e] * corr[e / 2] + apart[e];
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < C::ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.acc[n][e] *= corr[e / 2];
    if (CHECKSUM) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st.aug[e] *= corr[e / 2];
    }
    const int arow = (lane % 8) + 8 * ((lane / 8) % 2);
#pragma unroll
    for (int kp = 0; kp < C::KP; ++kp) {
      // A words of keys 16 kp .. + 15: the score fragments of n-blocks
      // 2 kp and 2 kp + 1 as they are, each value as bf16 hi + lo
      uint32_t ah[4], al[4];
      split_bf16(p[2 * kp][0], p[2 * kp][1], ah[0], al[0]);
      split_bf16(p[2 * kp][2], p[2 * kp][3], ah[1], al[1]);
      split_bf16(p[2 * kp + 1][0], p[2 * kp + 1][1], ah[2], al[2]);
      split_bf16(p[2 * kp + 1][2], p[2 * kp + 1][3], ah[3], al[3]);
#pragma unroll
      for (int jj = 0; jj < C::ND / 2; ++jj) {
        uint32_t r[4];
        am::ldsm_x4_trans(r, vs + (16 * kp + arow) * C::VS * 2
                                 + 8 * (2 * jj + lane / 16) * 2);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        am::Mma<__nv_bfloat16>::run(st.acc[2 * jj], al, b0);
        am::Mma<__nv_bfloat16>::run(st.acc[2 * jj], ah, b0);
        am::Mma<__nv_bfloat16>::run(st.acc[2 * jj + 1], al, b1);
        am::Mma<__nv_bfloat16>::run(st.acc[2 * jj + 1], ah, b1);
      }
      if (CHECKSUM) {
        uint32_t b[2], unused;
        aug_words<T>(b[0], unused, vsum, 16 * kp + 2 * t, g);
        aug_words<T>(b[1], unused, vsum, 16 * kp + 8 + 2 * t, g);
        am::Mma<__nv_bfloat16>::run(st.aug, al, b);
        am::Mma<__nv_bfloat16>::run(st.aug, ah, b);
      }
    }
  }
}

template <typename T, int D, bool CHECKSUM>
__global__ void __launch_bounds__(Cfg<T, D>::THREADS, Cfg<T, D>::MIN_CTAS)
flash_kernel(Params prm) {
  using C = Cfg<T, D>;
  constexpr int BC = C::BC, BR = C::BR;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;
  unsigned char* ring = smem + C::Q_BYTES;
  unsigned char* lo_buf = ring + STAGES * C::STAGE;   // fp32: K, V lo
  float* vsum = reinterpret_cast<float*>(lo_buf + C::LO_BYTES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the flat grid: blockIdx.x = bh * q tiles + (q tiles - 1 - q tile)
  const int sq = prm.sq, sk = prm.sk;
  const int qtiles = (sq + BR - 1) / BR;
  const long long bh = blockIdx.x / qtiles;
  const int r0 = (qtiles - 1 - static_cast<int>(blockIdx.x % qtiles)) * BR;
  const T* q = static_cast<const T*>(prm.q) + (bh * sq + r0) * D;
  const T* k = static_cast<const T*>(prm.k) + bh * sk * D;
  const T* v = static_cast<const T*>(prm.v) + bh * sk * D;

  // keys some row of this CTA may see: [kbeg, kend)
  const int rlast = (r0 + BR < sq ? r0 + BR : sq) - 1;
  long long kbeg = 0, kend = sk;
  if (prm.causal && rlast + 1 < kend) kend = rlast + 1;
  if (prm.has_window) {
    if (rlast + prm.window < kend) kend = rlast + prm.window;
    if (r0 - prm.window + 1 > kbeg) kbeg = r0 - prm.window + 1;
  }
  const int cfirst = static_cast<int>(kbeg / BC * BC);   // chunks aligned
  const int nchunks =
      kend > cfirst ? static_cast<int>((kend - cfirst + BC - 1) / BC) : 0;

  load_rows<T, D, BR>(qs, C::QS * C::S, q, sq - r0, prm.wq);
  am::cp_async_commit();
  if (nchunks > 0) {
    load_rows<T, D, BC>(ring, C::QS * C::S,
                        k + static_cast<long long>(cfirst) * D, sk - cfirst,
                        prm.wk);
    load_rows<T, D, BC>(ring + C::K_BYTES, C::VS * C::S,
                        v + static_cast<long long>(cfirst) * D, sk - cfirst,
                        prm.wv);
  }
  am::cp_async_commit();

  State<T, D> st;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.m[r] = NEG_INF;
    st.l[r] = 0.0f;
  }
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[n][e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) st.aug[e] = 0.0f;

  const int wrow = 16 * warp;                 // the warp's first local row
  const int w0 = r0 + wrow;
  const int w1 = (w0 + 15 < sq ? w0 + 15 : sq - 1);   // last real row
  const int row0 = w0 + g;                    // this thread's rows: row0, +8

  // the chaos inject: one row of bh 0, applied once
  const bool inj_here = prm.target != T_NONE && bh == 0 &&
                        prm.inj_row >= r0 && prm.inj_row < r0 + BR;
  bool injected = false;
  auto inject = [&]() {
    if (!inj_here || injected) return;
    injected = true;
    const int lr = static_cast<int>(prm.inj_row) - w0;   // row in the warp
    if (lr < 0 || lr >= 16 || lr % 8 != g) return;
    // constant indices only: a runtime one would put the state in local
    // memory
    if (prm.target == T_L) {                             // the whole quad
      if (lr < 8) st.l[0] += prm.inj_delta;
      else st.l[1] += prm.inj_delta;
    } else if (t == 0) {                                 // column 0
      if (lr < 8) st.acc[0][0] += prm.inj_delta;
      else st.acc[0][2] += prm.inj_delta;
    }
  };
  if (prm.inj_key_end <= kbeg) inject();

  // One pass over keys [lo, hi) of the staged chunk at c0.
  auto pass = [&](const unsigned char* ks, const unsigned char* vs, int c0,
                  int lo, int hi) {
    bool any = w0 < sq && lo < hi;
    bool full = lo == c0 && hi == c0 + BC;
    if (prm.causal) {
      any = any && lo <= w1;
      full = full && hi - 1 <= w0;
    }
    if (prm.has_window) {
      const long long W = prm.window;
      any = any && static_cast<long long>(hi - 1) - w0 > -W &&
            (prm.causal || static_cast<long long>(lo) - w1 < W);
      full = full && static_cast<long long>(w1) - lo < W &&
             static_cast<long long>(hi - 1) - w0 < W;
    }
    float s[C::NS][4], corr[2];
    if (any) {
      scores<T, D>(s, qs, ks, lo_buf, wrow);
      if (full)
        softmax<T, D, false>(s, st.m, st.l, corr, prm, row0, c0, lo, hi);
      else
        softmax<T, D, true>(s, st.m, st.l, corr, prm, row0, c0, lo, hi);
    }
    if (CHECKSUM && !C::F32) __syncthreads();   // vsum is in smem
    if (any) pv<T, D, CHECKSUM>(st, s, corr, vs, lo_buf + C::K_BYTES, vsum);
  };

  for (int ci = 0; ci < nchunks; ++ci) {
    const int c0 = cfirst + ci * BC;
    const int cend = c0 + BC < sk ? c0 + BC : sk;
    am::cp_async_wait<0>();
    __syncthreads();   // chunk ci landed; every warp is done with ci - 1
    if (ci + 1 < nchunks) {
      unsigned char* nx = ring + ((ci + 1) % STAGES) * C::STAGE;
      const long long c1 = c0 + BC;
      load_rows<T, D, BC>(nx, C::QS * C::S, k + c1 * D, sk - c1, prm.wk);
      load_rows<T, D, BC>(nx + C::K_BYTES, C::VS * C::S, v + c1 * D, sk - c1,
                          prm.wv);
    }
    am::cp_async_commit();
    unsigned char* ks = ring + (ci % STAGES) * C::STAGE;
    const unsigned char* vs = ks + C::K_BYTES;
    if constexpr (C::F32) {
      split_chunk<T, D, CHECKSUM>(ks, lo_buf, vsum);
      __syncthreads();   // hi, lo and vsum of chunk ci are in smem
    } else if (CHECKSUM) {
      // vsum[c] = sum_d v[c, d] in fp32, THREADS / BC threads a key, each
      // D / TPK values in 16-byte loads
      constexpr int TPK = C::THREADS / BC, VEC = D / TPK / 8;
      const int key = tid / TPK, part = tid % TPK;
      const uint4* vr = reinterpret_cast<const uint4*>(
          vs + key * C::VS * C::S) + part * VEC;
      float x = 0.0f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const uint4 w = vr[i];
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int h = 0; h < 4; ++h)
          x += __uint_as_float(ws[h] << 16) +
               __uint_as_float(ws[h] & 0xffff0000u);
      }
#pragma unroll
      for (int off = TPK / 2; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      if (part == 0) vsum[key] = x;
    }
    for (int lo = c0; lo < cend;) {
      const int hi = inj_here && !injected && lo < prm.inj_key_end &&
                             prm.inj_key_end < cend
                         ? static_cast<int>(prm.inj_key_end)
                         : cend;
      pass(ks, vs, c0, lo, hi);
      if (hi >= prm.inj_key_end) inject();
      lo = hi;
    }
  }
  am::cp_async_wait<0>();
  inject();                      // an inject past the last key seen

  // epilogue
  T* o = static_cast<T*>(prm.o) + bh * sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float l = st.l[r];
    const float l_safe = l != l ? l : fmaxf(l, 1e-30f);
    float osum = 0.0f;
#pragma unroll
    for (int n = 0; n < C::ND; ++n) {
      const float x0 = st.acc[n][2 * r] / l_safe;
      const float x1 = st.acc[n][2 * r + 1] / l_safe;
      osum += x0 + x1;
      if (row < sq) {
        T* dst = o + static_cast<long long>(row) * D + 8 * n + 2 * t;
        if constexpr (C::F32) {
          *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
        } else {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x0, x1);
        }
      }
    }
    if (CHECKSUM) {
      osum = quad_sum(osum);
      const float cs = __shfl_sync(0xffffffffu,
                                   st.aug[2 * r] + st.aug[2 * r + 1],
                                   lane & ~3);
      const float l2 =
          __shfl_sync(0xffffffffu, st.aug[2 * r], (lane & ~3) + 1);
      if (t == 0 && row < sq) {
        const bool live = l2 > 0.0f;      // l itself may be the fault
        const float want = cs / l_safe;
        const float r_pv =
            live ? fabsf(osum - want) / (fabsf(want) + 1.0f) : 0.0f;
        const float r_l = !live ? 0.0f
            : l > 0.0f ? fabsf(l2 / l_safe - 1.0f)
                       : __int_as_float(0x7f800000);   // +inf
        float* rr = prm.rows + (bh * sq + row) * 2;
        rr[0] = r_pv;
        rr[1] = r_l;
      }
    }
  }
}

template <typename T, int D, bool CHECKSUM>
int launch(const Params& prm, int bh, cudaStream_t stream, int* info) {
  using C = Cfg<T, D>;
  const long long ctas =
      static_cast<long long>((prm.sq + C::BR - 1) / C::BR) * bh;
  if (ctas > 0x7fffffffLL) return -1;   // the flat grid's grid.x
  auto kern = flash_kernel<T, D, CHECKSUM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info) {
    info[0] = 1;            // route: tensor cores
    info[1] = C::BR;
    info[2] = C::BC;
    info[3] = prm.wq;
    info[4] = prm.wk;
    info[5] = prm.wv;
  }
  kern<<<dim3(static_cast<unsigned>(ctas)), C::THREADS, C::SMEM, stream>>>(
      prm);
  return 0;
}

template <typename T, bool CHECKSUM>
int launch_d(const Params& prm, int bh, int d, cudaStream_t stream,
             int* info) {
  switch (d) {
    case 64: return launch<T, 64, CHECKSUM>(prm, bh, stream, info);
    case 128: return launch<T, 128, CHECKSUM>(prm, bh, stream, info);
    case 256: return launch<T, 256, CHECKSUM>(prm, bh, stream, info);
    default: return -3;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Device pointers of contiguous
// row-major tensors: q [bh, sq, d], k and v [bh, sk, d], o [bh, sq, d] in
// q's type (kind 0 fp32, 1 bf16); rows [bh, sq, 2] fp32 when `checksum`
// (else ignored).  `window` is read when `has_window`; softcap 0 is none.
// The inject (target 1 acc, 2 l; 0 none) adds `inj_delta` to row
// `inj_row` of bh 0 once keys [0, inj_key_end) are folded.  `info`
// (6 ints, or null) receives the route (1: tensor cores), rows a CTA, keys
// a chunk and the copy widths of q, k and v in bytes.  Launches on
// `stream` without synchronising.  Returns 0, a CUDA error code, or a
// negative code for arguments the kernel does not take (-1 sizes, or more
// (bh, q tile) pairs than grid.x's 2^31 - 1; -2 kind; -3 head dim).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* rows,
    int bh, int sq, int sk, int d, int kind, int checksum, float scale,
    int causal, int has_window, long long window, float softcap,
    int target, long long inj_row, long long inj_key_end, float inj_delta,
    int* info, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1) return -1;
  if (checksum && rows == nullptr) return -1;
  if (kind != K_F32 && kind != K_BF16) return -2;
  const int elem = kind == K_F32 ? 4 : 2;
  const long long row_bytes = static_cast<long long>(d) * elem;
  Params prm{q, k, v, o, static_cast<float*>(rows), sq, sk, scale, causal,
             has_window, window, softcap, target, inj_row, inj_key_end,
             inj_delta, am::copy_width(q, row_bytes, elem, 16),
             am::copy_width(k, row_bytes, elem, 16),
             am::copy_width(v, row_bytes, elem, 16)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (kind == K_F32) {
    rc = checksum ? launch_d<float, true>(prm, bh, d, s, info)
                  : launch_d<float, false>(prm, bh, d, s, info);
  } else {
    rc = checksum ? launch_d<__nv_bfloat16, true>(prm, bh, d, s, info)
                  : launch_d<__nv_bfloat16, false>(prm, bh, d, s, info);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
