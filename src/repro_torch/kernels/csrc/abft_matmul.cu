// One-shot C = A @ B with fused dual (column + row) checksum partials,
// for Hopper (sm_90a), on CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/abft_matmul.py::abft_matmul_pallas
// (its `_kernel` with carry_in=False and the `_tile_checksums` epilogue).
// It computes what that kernel computes, not its block layout:
//
//   * one CTA per output tile (BM, BN); a loop over k, staged through shared
//     memory KT=16 columns at a time, takes the place of the TPU's sequential
//     k grid axis;
//   * the accumulator is fp32 (fp32 and bf16 operands; fp32 FMA, never TF32)
//     or int32 (int8 operands, exact);
//   * in the epilogue the CTA casts each value to the output type, reads the
//     stored value back as fp32, and reduces the checksum partials of that
//     ROUNDED tile:  ccol[i] = W_m[:, tile_i] @ C_tile   ([f, BN] slice of
//     ccol [ceil(m/BM), f, n])  and  crow[j] = C_tile @ W_n[tile_j, :]
//     ([BM, f] slice of crow [ceil(n/BN), m, f]).  Summing the partials over
//     axis 0 is a second pass in the caller, so there are no atomics and the
//     result is deterministic.  For shapes that divide the tile this is
//     exactly the reference layout; ragged edges are masked here instead of
//     zero-padded in memory (zero rows and columns checksum to zero, so the
//     two agree).
//
// What bounds it on an H100: at the serving prefill shapes (m = 1024) the
// 2mkn fp32 FMAs on the CUDA cores (67 TFLOP/s peak); at decode (m = 4) the
// bytes of the weight operand B (k * n * 4 at 3.35 TB/s).  The design is the
// simple one on purpose: 256 threads as a 16 x 16 grid, each holding a
// (BM/16) x (BN/16) register tile, strided so that the B reads and the C
// stores are contiguous across a half-warp.  What it leaves on the table:
// tensor cores (wgmma for bf16 / int8; fp32 must stay IEEE, so at most a
// 3xTF32 split), TMA or cp.async double buffering of the k slabs, 16-byte
// vector loads, and, at decode, a split over k to put more CTAs on the 132
// SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename TIn, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
abft_matmul_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                   const float* __restrict__ wm, const float* __restrict__ wn,
                   void* __restrict__ c, float* __restrict__ ccol,
                   float* __restrict__ crow, int m, int k, int n, int f,
                   int out_kind) {
  using TC = typename Compute<TIn>::type;
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int AS = BM + 1;  // padded row: the transposed A store spreads banks
  constexpr int LOOP_BYTES = KT * (AS + BN) * static_cast<int>(sizeof(TC));
  constexpr int EPI_BYTES = 16 * FMAX * (BM > BN ? BM : BN) * 4;
  constexpr int SMEM = LOOP_BYTES > EPI_BYTES ? LOOP_BYTES : EPI_BYTES;
  __shared__ __align__(16) unsigned char smem[SMEM];
  TC* As = reinterpret_cast<TC*>(smem);     // [KT][AS]
  TC* Bs = As + KT * AS;                    // [KT][BN]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int ti = blockIdx.y;
  const int tj = blockIdx.x;
  const int m0 = ti * BM;
  const int n0 = tj * BN;

  TC acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = TC(0);

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

  // Epilogue: store the tile, keep the rounded values for the checksums.
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
  // Column partials: each thread sums its TM rows, then 16 rows of threads
  // are summed in a fixed order.
  for (int fi = 0; fi < f; ++fi) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = m0 + ty + 16 * i;
        const float w = row < m ? wm[static_cast<long long>(fi) * m + row] : 0.0f;
        s = fmaf(w, v[i][j], s);
      }
      red[(ty * f + fi) * BN + tx + 16 * j] = s;
    }
  }
  __syncthreads();
  for (int e = tid; e < f * BN; e += THREADS) {
    const int fi = e / BN, cc = e % BN, col = n0 + cc;
    float s = 0.0f;
    for (int t = 0; t < 16; ++t) s += red[(t * f + fi) * BN + cc];
    if (col < n) ccol[(static_cast<long long>(ti) * f + fi) * n + col] = s;
  }
  __syncthreads();
  // Row partials: each thread sums its TN columns, then 16 columns of
  // threads are summed in a fixed order.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    for (int fi = 0; fi < f; ++fi) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tx + 16 * j;
        const float w = col < n ? wn[static_cast<long long>(col) * f + fi] : 0.0f;
        s = fmaf(v[i][j], w, s);
      }
      red[(tx * BM + ty + 16 * i) * f + fi] = s;
    }
  }
  __syncthreads();
  for (int e = tid; e < BM * f; e += THREADS) {
    const int r = e / f, fi = e % f, row = m0 + r;
    float s = 0.0f;
    for (int t = 0; t < 16; ++t) s += red[(t * BM + r) * f + fi];
    if (row < m) crow[(static_cast<long long>(tj) * m + row) * f + fi] = s;
  }
}

template <typename TIn>
int launch_typed(const void* a, const void* b, const float* wm, const float* wn,
                 void* c, float* ccol, float* crow, int m, int k, int n, int f,
                 int bm, int bn, int out_kind, cudaStream_t stream) {
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  const TIn* ta = static_cast<const TIn*>(a);
  const TIn* tb = static_cast<const TIn*>(b);
#define ABFT_CASE(BM_, BN_)                                                   \
  if (bm == BM_ && bn == BN_) {                                               \
    abft_matmul_kernel<TIn, BM_, BN_><<<grid, THREADS, 0, stream>>>(          \
        ta, tb, wm, wn, c, ccol, crow, m, k, n, f, out_kind);                 \
    return 0;                                                                 \
  }
  ABFT_CASE(16, 32) ABFT_CASE(16, 64) ABFT_CASE(16, 128)
  ABFT_CASE(32, 32) ABFT_CASE(32, 64) ABFT_CASE(32, 128)
  ABFT_CASE(64, 32) ABFT_CASE(64, 64) ABFT_CASE(64, 128)
  ABFT_CASE(128, 32) ABFT_CASE(128, 64) ABFT_CASE(128, 128)
#undef ABFT_CASE
  return -3;
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous row-major tensors: a [m, k], b [k, n], wm [f, m] fp32,
// wn [n, f] fp32, c [m, n], ccol [ceil(m/bm), f, n] fp32,
// crow [ceil(n/bn), m, f] fp32.  Launches on `stream` without synchronising.
// Returns 0, cudaGetLastError() of the launch, or a negative code for
// arguments the kernel does not take (-1 f, -2 dtype pair, -3 tile).
extern "C" int abft_matmul_launch(const void* a, const void* b, const void* wm,
                                  const void* wn, void* c, void* ccol,
                                  void* crow, int m, int k, int n, int f,
                                  int bm, int bn, int in_kind, int out_kind,
                                  void* stream) {
  if (f < 1 || f > FMAX) return -1;
  if (m < 1 || k < 1 || n < 1) return -4;
  const float* fwm = static_cast<const float*>(wm);
  const float* fwn = static_cast<const float*>(wn);
  float* fcol = static_cast<float*>(ccol);
  float* frow = static_cast<float*>(crow);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (in_kind == IN_F32 && (out_kind == OUT_F32 || out_kind == OUT_BF16)) {
    rc = launch_typed<float>(a, b, fwm, fwn, c, fcol, frow, m, k, n, f, bm, bn,
                             out_kind, s);
  } else if (in_kind == IN_BF16 && (out_kind == OUT_F32 || out_kind == OUT_BF16)) {
    rc = launch_typed<__nv_bfloat16>(a, b, fwm, fwn, c, fcol, frow, m, k, n, f,
                                     bm, bn, out_kind, s);
  } else if (in_kind == IN_I8 && out_kind == OUT_I32) {
    rc = launch_typed<int8_t>(a, b, fwm, fwn, c, fcol, frow, m, k, n, f, bm, bn,
                              out_kind, s);
  } else {
    return -2;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
