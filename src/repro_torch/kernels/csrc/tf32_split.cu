// The 3xTF32 operand planes of kernel #2's fp32 tensor-core route, for
// Hopper (sm_90a): each fp32 element x becomes hi = x rounded to TF32
// (nearest, ties away from zero) and lo = (x - hi) rounded the same way,
// bit for bit abft_mma.cuh's split_tf32.
//
// Replaces no TPU kernel: the TPU's matrix unit takes fp32 operands as
// they are, and the reference runs no split.  It exists because tf32 wgmma
// reads both operands K-major from shared memory (abft_wgmma.cuh): split
// once per SUMMA panel here, an element is no longer split again in every
// tile and every launch that reads it (24 tiles a launch, 8 launches a
// panel at the SUMMA's 3000^3 blocks), and B arrives transposed.
//
// Two kernels over `batch` blocks of [rows, cols] fp32, block b at
// x + b * bstride, rows rstride apart:
//   as it lies: hi, lo [batch, rows, ld], a CTA a row, float4 where the
//     rows and the base allow it (A: [m, k] is K-major already);
//   transposed: hi, lo [batch, cols, ld], 32 x 32 tiles through shared
//     memory, so both the reads of x and the writes of the planes run
//     along rows (B: [k, n] becomes [n, k]).
// Columns from the inner extent up to ld read as 0: the padding that makes
// a plane's rows 16-byte strides for TMA is written with zeros.
//
// What bounds it on an H100: bytes, 4 read and 8 written an element (a
// SUMMA panel of 8 blocks of 3000^2: 288 MB read, 576 MB written, about
// 0.26 ms at the card's 3.35 TB/s); two integer operations and a subtract
// an element are nothing beside them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "abft_mma.cuh"

namespace {

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  uint32_t h, l;
  abft_mma::split_tf32(__float_as_uint(x), h, l);
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

template <bool VEC>
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ x, float* __restrict__ hi,
                  float* __restrict__ lo, int rows, int cols, long long bstride,
                  long long rstride, int ld) {
  const int r = blockIdx.x, b = blockIdx.y;
  const float* src = x + b * bstride + r * rstride;
  const long long o = (static_cast<long long>(b) * rows + r) * ld;
  if constexpr (VEC) {
    // cols, ld, the strides and the bases are multiples of 4 floats
    for (int c = 4 * threadIdx.x; c < ld; c += 4 * blockDim.x) {
      const float4 v = c < cols ? *reinterpret_cast<const float4*>(src + c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 h, l;
      split(v.x, h.x, l.x);
      split(v.y, h.y, l.y);
      split(v.z, h.z, l.z);
      split(v.w, h.w, l.w);
      *reinterpret_cast<float4*>(hi + o + c) = h;
      *reinterpret_cast<float4*>(lo + o + c) = l;
    }
  } else {
    for (int c = threadIdx.x; c < ld; c += blockDim.x) {
      float h, l;
      split(c < cols ? src[c] : 0.0f, h, l);
      hi[o + c] = h;
      lo[o + c] = l;
    }
  }
}

constexpr int TT = 32;   // the transpose's tile

__global__ void __launch_bounds__(256)
tf32_split_t_kernel(const float* __restrict__ x, float* __restrict__ hi,
                    float* __restrict__ lo, int rows, int cols,
                    long long bstride, long long rstride, int ld) {
  __shared__ float t[TT][TT + 1];
  const int b = blockIdx.z, r0 = blockIdx.y * TT, c0 = blockIdx.x * TT;
  const int tx = threadIdx.x % TT, ty = threadIdx.x / TT;   // 32 x 8
  const float* src = x + b * bstride;
#pragma unroll
  for (int i = 0; i < TT; i += 8) {
    const int r = r0 + ty + i, c = c0 + tx;
    t[ty + i][tx] = r < rows && c < cols ? src[r * rstride + c] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TT; i += 8) {
    const int c = c0 + ty + i, r = r0 + tx;
    if (c < cols && r < ld) {
      float h, l;
      split(t[tx][ty + i], h, l);
      const long long o = (static_cast<long long>(b) * cols + c) * ld + r;
      hi[o] = h;
      lo[o] = l;
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  x: `batch` blocks of [rows,
// cols] fp32 on the device, block b at x + b * bstride, rows rstride apart
// (in elements), each row contiguous; hi, lo: contiguous [batch, rows, ld]
// (transpose 0) or [batch, cols, ld] (transpose 1), ld at least the inner
// extent (cols, or rows transposed) and a multiple of 4.  Launches on
// `stream` without synchronising.  Returns 0, cudaGetLastError() of the
// launch, or -1 for a shape the kernels do not take.
extern "C" int tf32_split_launch(const void* x, void* hi, void* lo, int batch,
                                 int rows, int cols, long long bstride,
                                 long long rstride, int ld, int transpose,
                                 void* stream) {
  const int inner = transpose ? rows : cols;
  if (batch < 1 || rows < 1 || cols < 1 || ld < inner || ld % 4 ||
      batch > 65535)
    return -1;
  const float* fx = static_cast<const float*>(x);
  float* fh = static_cast<float*>(hi);
  float* fl = static_cast<float*>(lo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (transpose) {
    const dim3 grid((cols + TT - 1) / TT, (ld + TT - 1) / TT, batch);
    tf32_split_t_kernel<<<grid, 256, 0, s>>>(fx, fh, fl, rows, cols, bstride,
                                             rstride, ld);
  } else {
    const dim3 grid(rows, batch);
    const bool vec = cols % 4 == 0 && rstride % 4 == 0 && bstride % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(hi) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(lo) % 16 == 0;
    if (vec)
      tf32_split_kernel<true><<<grid, 256, 0, s>>>(fx, fh, fl, rows, cols,
                                                   bstride, rstride, ld);
    else
      tf32_split_kernel<false><<<grid, 256, 0, s>>>(fx, fh, fl, rows, cols,
                                                    bstride, rstride, ld);
  }
  return static_cast<int>(cudaGetLastError());
}
