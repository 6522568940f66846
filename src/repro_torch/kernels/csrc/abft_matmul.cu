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
// SMs.  The k loop and the epilogue live in abft_tile.cuh, shared with the
// accumulate kernel (abft_matmul_acc.cu), whose verify prologue recomputes
// the checksums this epilogue writes.
#include "abft_tile.cuh"

using namespace abft;

namespace {

template <typename TIn, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
abft_matmul_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                   const float* __restrict__ wm, const float* __restrict__ wn,
                   void* __restrict__ c, float* __restrict__ ccol,
                   float* __restrict__ crow, int m, int k, int n, int f,
                   int out_kind) {
  using TC = typename Compute<TIn>::type;
  __shared__ __align__(16) unsigned char smem[Smem<TC, BM, BN>::BYTES];
  TC acc[BM / 16][BN / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc[i][j] = TC(0);
  mainloop<TIn, BM, BN>(a, b, m, k, n, blockIdx.y * BM, blockIdx.x * BN, acc,
                        smem);
  // Epilogue: store the tile, reduce the checksums of the stored values.
  epilogue<TC, BM, BN>(acc, c, ccol, crow, wm, wn, m, n, f, out_kind, smem);
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
