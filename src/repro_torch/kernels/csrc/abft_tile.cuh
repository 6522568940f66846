// Shared pieces of the port's ABFT GEMM kernels (abft_matmul.cu, the
// one-shot product, and abft_matmul_acc.cu, the accumulate step), for
// Hopper (sm_90a), on CUDA cores.
//
// A CTA of THREADS = 256 threads, a 16 x 16 grid, owns one (BM, BN) output
// tile.  Thread (tx, ty) holds the register tile of rows ty + 16 i and
// columns tx + 16 j, i < BM/16, j < BN/16, so that the B reads and the C
// stores are contiguous across a half-warp.
//
// The checksum reductions live here once, so that the accumulate kernel's
// verify prologue recomputes a tile's checksums with the same routine and
// in the same order as either kernel's epilogue wrote them: a clean carried
// state then re-verifies with residual exactly 0.  Every sum is an explicit
// fmaf or a plain add in a fixed order, so the result does not depend on
// where the routine is inlined.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace abft {

constexpr int KT = 16;        // k columns staged in shared memory per step
constexpr int THREADS = 256;  // a 16 x 16 thread grid
constexpr int FMAX = 4;       // most checksum rows per direction

enum InKind { IN_F32 = 0, IN_BF16 = 1, IN_I8 = 2 };
enum OutKind { OUT_F32 = 0, OUT_BF16 = 1, OUT_I32 = 2 };

template <typename T> struct Compute;
template <> struct Compute<float> { using type = float; };
template <> struct Compute<__nv_bfloat16> { using type = float; };
template <> struct Compute<int8_t> { using type = int; };

__device__ __forceinline__ float to_compute(float x) { return x; }
__device__ __forceinline__ float to_compute(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ int to_compute(int8_t x) { return static_cast<int>(x); }

__device__ __forceinline__ float mac(float acc, float a, float b) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ int mac(int acc, int a, int b) { return acc + a * b; }

// Store one output element and return the stored value read back as fp32.
__device__ __forceinline__ float store_rounded(void* c, long long idx, float v,
                                               int out_kind) {
  if (out_kind == OUT_BF16) {
    const __nv_bfloat16 r = __float2bfloat16(v);  // round to nearest even
    static_cast<__nv_bfloat16*>(c)[idx] = r;
    return __bfloat162float(r);
  }
  static_cast<float*>(c)[idx] = v;
  return v;
}
__device__ __forceinline__ float store_rounded(void* c, long long idx, int v,
                                               int /*out_kind*/) {
  static_cast<int*>(c)[idx] = v;
  return static_cast<float>(v);
}

// Bytes of the static shared memory a CTA needs: the staged A/B slabs of
// the k loop, or the partial sums of the checksum reductions (the two
// reuse the same bytes).
template <typename TC, int BM, int BN>
struct Smem {
  static constexpr int AS = BM + 1;  // padded row: the transposed A store spreads banks
  static constexpr int LOOP = KT * (AS + BN) * static_cast<int>(sizeof(TC));
  static constexpr int EPI = 16 * FMAX * (BM > BN ? BM : BN) * 4;
  static constexpr int BYTES = LOOP > EPI ? LOOP : EPI;
};

// acc += A[m0:m0+BM, :] @ B[:, n0:n0+BN], k staged KT columns at a time
// through shared memory; the ragged edges are read as zeros.
template <typename TIn, int BM, int BN>
__device__ __forceinline__ void mainloop(
    const TIn* __restrict__ a, const TIn* __restrict__ b, int m, int k, int n,
    int m0, int n0, typename Compute<TIn>::type (&acc)[BM / 16][BN / 16],
    unsigned char* smem) {
  using TC = typename Compute<TIn>::type;
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int AS = Smem<TC, BM, BN>::AS;
  TC* As = reinterpret_cast<TC*>(smem);     // [KT][AS]
  TC* Bs = As + KT * AS;                    // [KT][BN]
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  for (int k0 = 0; k0 < k; k0 += KT) {
    for (int e = tid; e < BM * KT; e += THREADS) {
      const int r = e / KT, kk = e % KT;
      const int gr = m0 + r, gk = k0 + kk;
      As[kk * AS + r] = (gr < m && gk < k)
          ? to_compute(a[static_cast<long long>(gr) * k + gk]) : TC(0);
    }
    for (int e = tid; e < KT * BN; e += THREADS) {
      const int kk = e / BN, cc = e % BN;
      const int gk = k0 + kk, gc = n0 + cc;
      Bs[kk * BN + cc] = (gk < k && gc < n)
          ? to_compute(b[static_cast<long long>(gk) * n + gc]) : TC(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      TC av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk * AS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = mac(acc[i][j], av[i], bv[j]);
    }
    __syncthreads();
  }
}

// This thread's checksum weights for tile rows m0 + ty + 16 i and tile
// columns n0 + tx + 16 j, loaded before the sums that use them so that
// their global loads fly together with the tile's own: wm[fi, row] and
// wn[col, fi] for fi < nf, 0 past m, past n and for fi >= nf.
template <int BM, int BN>
struct TileWeights {
  float m[FMAX][BM / 16];
  float n[FMAX][BN / 16];
};

template <int BM, int BN>
__device__ __forceinline__ void load_weights(TileWeights<BM, BN>& w,
                                             const float* __restrict__ wm,
                                             const float* __restrict__ wn,
                                             int m, int n, int f, int nf,
                                             int m0, int n0) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int fi = 0; fi < FMAX; ++fi) {
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int row = m0 + ty + 16 * i;
      w.m[fi][i] = fi < nf && row < m
          ? wm[static_cast<long long>(fi) * m + row] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = n0 + tx + 16 * j;
      w.n[fi][j] = fi < nf && col < n
          ? wn[static_cast<long long>(col) * f + fi] : 0.0f;
    }
  }
}

// Column checksums of the register tile v: for fi < nf and cc < BN,
// sink(fi, cc, sum_r wm[fi, m0 + r] * v[r, cc]).  Each thread sums its TM
// rows, then the 16 rows of threads are summed in a fixed order.  Rows
// past m weigh 0.  `red` holds 16 * nf * BN floats.
template <int BM, int BN, typename Sink>
__device__ __forceinline__ void col_sums(const float (&v)[BM / 16][BN / 16],
                                         const TileWeights<BM, BN>& w, int nf,
                                         float* red, Sink sink) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int fi = 0; fi < FMAX; ++fi) {
    if (fi >= nf) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < TM; ++i) s = fmaf(w.m[fi][i], v[i][j], s);
      red[(ty * nf + fi) * BN + tx + 16 * j] = s;
    }
  }
  __syncthreads();
  for (int e = tid; e < nf * BN; e += THREADS) {
    const int fi = e / BN, cc = e % BN;
    float s = 0.0f;
    for (int t = 0; t < 16; ++t) s += red[(t * nf + fi) * BN + cc];
    sink(fi, cc, s);
  }
  __syncthreads();
}

// Row checksums of the register tile v: for r < BM and fi < nf,
// sink(r, fi, sum_c v[r, c] * wn[n0 + c, fi]).  Each thread sums its TN
// columns, then the 16 columns of threads are summed in a fixed order.
// Columns past n weigh 0.  `red` holds 16 * BM * nf floats.
template <int BM, int BN, typename Sink>
__device__ __forceinline__ void row_sums(const float (&v)[BM / 16][BN / 16],
                                         const TileWeights<BM, BN>& w, int nf,
                                         float* red, Sink sink) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int fi = 0; fi < FMAX; ++fi) {
      if (fi >= nf) break;
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) s = fmaf(v[i][j], w.n[fi][j], s);
      red[(tx * BM + ty + 16 * i) * nf + fi] = s;
    }
  }
  __syncthreads();
  for (int e = tid; e < BM * nf; e += THREADS) {
    const int r = e / nf, fi = e % nf;
    float s = 0.0f;
    for (int t = 0; t < 16; ++t) s += red[(t * BM + r) * nf + fi];
    sink(r, fi, s);
  }
  __syncthreads();
}

// Writes a column checksum into the per-tile partials
// ccol [ceil(m/BM), f, n] (tile row ti); columns past n are dropped.
struct ColPartialSink {
  float* ccol;
  int ti, f, n, n0;
  __device__ void operator()(int fi, int cc, float s) const {
    const int col = n0 + cc;
    if (col < n) ccol[(static_cast<long long>(ti) * f + fi) * n + col] = s;
  }
};

// Writes a row checksum into the per-tile partials
// crow [ceil(n/BN), m, f] (tile column tj); rows past m are dropped.
struct RowPartialSink {
  float* crow;
  int tj, f, m, m0;
  __device__ void operator()(int r, int fi, float s) const {
    const int row = m0 + r;
    if (row < m) crow[(static_cast<long long>(tj) * m + row) * f + fi] = s;
  }
};

// Epilogue of both kernels: store tile (ti, tj) in the output type, keep
// the stored (rounded) values, and write both checksum partials of them.
template <typename TC, int BM, int BN>
__device__ __forceinline__ void epilogue(const TC (&acc)[BM / 16][BN / 16],
                                         void* c, float* ccol, float* crow,
                                         const float* __restrict__ wm,
                                         const float* __restrict__ wn, int m,
                                         int n, int f, int out_kind,
                                         unsigned char* smem, int ti, int tj) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = ti * BM, n0 = tj * BN;
  TileWeights<BM, BN> w;
  load_weights<BM, BN>(w, wm, wn, m, n, f, f, m0, n0);
  float v[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      v[i][j] = (row < m && col < n)
          ? store_rounded(c, static_cast<long long>(row) * n + col, acc[i][j],
                          out_kind)
          : 0.0f;
    }
  }
  float* red = reinterpret_cast<float*>(smem);
  col_sums<BM, BN>(v, w, f, red, ColPartialSink{ccol, ti, f, n, n0});
  row_sums<BM, BN>(v, w, f, red, RowPartialSink{crow, tj, f, m, m0});
}

}  // namespace abft
