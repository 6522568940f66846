// Diskless-checkpoint encode  Y[j] = sum_i A[j, i] * X[i]  for Hopper
// (sm_90a), on CUDA cores.
//
// Replaces the TPU kernel
// src/repro/kernels/checksum_encode.py::checksum_encode_pallas: stacked
// shards X [p, m, n] (fp32 or bf16) and a small checkpoint matrix A [f, p]
// (fp32) give the f weighted checksums Y [f, m, n] in X's type.  Each
// checksum element is a sum over p in fp32, in the order 0 .. p-1, rounded
// once to the output type (round to nearest even for bf16).
//
// It computes what that kernel computes, not its block layout.  The TPU
// kernel tiles (m, n) so that a [p, bm, bn] block fits VMEM; here m and n
// are one flat axis of L = m * n columns (the [p, m, n] and [f, m, n]
// arrays are contiguous, so column c of shard i sits at i * L + c), walked
// by a grid-stride loop.  A thread owns VEC neighbouring columns (16 bytes
// of X per shard: 4 fp32 or 8 bf16 values), keeps f x VEC fp32
// accumulators in registers, reads its columns of every shard once with
// one 16-byte load each (a warp reads 512 contiguous bytes per shard), and
// writes each checksum element once.  A sits in shared memory, loaded once
// per block.  Any m and n: when L is not a multiple of VEC (or a pointer is
// not 16-byte aligned) the scalar instance (VEC = 1) runs instead, so
// there is no tail and nothing is padded.  Checksum rows go FC at a time
// (FC = min(f, 4)); with f > 4 a thread reads its columns again for each
// further group of rows.
//
// What bounds it on an H100: bytes.  Per column it reads p values and
// writes f, doing 2 f p flops: about f operations per byte, far below the
// card's ~20 fp32 operations per byte of HBM, so the least time is
// (p + f) L sizeof(T) / 3.35 TB/s.  What the simple design leaves on the
// table: TMA bulk loads into a shared-memory ring (the loads here are plain
// 16-byte global loads, the p loop unrolled by four to keep several in
// flight per thread), and fusing the encode of many small leaves into one
// launch (each leaf is a launch, which at 4 x 6 x 896 norms costs more than
// the bytes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int FC_MAX = 4;          // checksum rows per pass over X
constexpr int SMEM_FLOATS = 12288; // most f * p the kernel takes (48 KB)

enum Kind { K_F32 = 0, K_BF16 = 1 };

// bf16 values are handled as their 16-bit patterns: widening is a shift,
// narrowing is __float2bfloat16_rn (round to nearest even)
struct Bf16 {
  uint16_t bits;
};

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };   // 16 bytes
template <> struct Vec<Bf16> { static constexpr int N = 8; };    // 16 bytes

__device__ __forceinline__ float widen(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}
__device__ __forceinline__ uint32_t narrow(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// Load VEC consecutive values at p into fp32 (VEC = 1: one scalar; else one
// 16-byte load, p 16-byte aligned).
__device__ __forceinline__ void load1(const float* __restrict__ p, float* v) {
  v[0] = *p;
}
__device__ __forceinline__ void load1(const Bf16* __restrict__ p, float* v) {
  v[0] = widen(p->bits);
}
__device__ __forceinline__ void loadv(const float* __restrict__ p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void loadv(const Bf16* __restrict__ p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {      // little-endian: element 2k is low
    v[2 * k] = widen(w[k] & 0xffffu);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store1(float* __restrict__ p, const float* v) {
  *p = v[0];
}
__device__ __forceinline__ void store1(Bf16* __restrict__ p, const float* v) {
  p->bits = static_cast<uint16_t>(narrow(v[0]));
}
__device__ __forceinline__ void storev(float* __restrict__ p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void storev(Bf16* __restrict__ p, const float* v) {
  uint4 q;
  q.x = narrow(v[0]) | (narrow(v[1]) << 16);
  q.y = narrow(v[2]) | (narrow(v[3]) << 16);
  q.z = narrow(v[4]) | (narrow(v[5]) << 16);
  q.w = narrow(v[6]) | (narrow(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = q;
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* v) {
  if constexpr (VEC == 1) load1(p, v); else loadv(p, v);
}
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* v) {
  if constexpr (VEC == 1) store1(p, v); else storev(p, v);
}

// x [p, L], a [f, p] fp32, y [f, L]; groups = L / VEC (L % VEC == 0).
template <typename T, int VEC, int FC>
__global__ void __launch_bounds__(THREADS)
checksum_encode_kernel(const T* __restrict__ x, const float* __restrict__ a,
                       T* __restrict__ y, int p, int f, long long L,
                       long long groups) {
  extern __shared__ float sa[];          // A, row-major [f, p]
  for (int t = threadIdx.x; t < f * p; t += THREADS) sa[t] = a[t];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long g = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       g < groups; g += stride) {
    const long long col = g * VEC;
    for (int f0 = 0; f0 < f; f0 += FC) {
      float acc[FC][VEC];
#pragma unroll
      for (int r = 0; r < FC; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = 0.0f;
#pragma unroll 4
      for (int i = 0; i < p; ++i) {
        float v[VEC];
        load_vec<T, VEC>(x + static_cast<long long>(i) * L + col, v);
#pragma unroll
        for (int r = 0; r < FC; ++r) {
          // rows past f read row f0 (in range) and are never stored
          const float w = sa[(f0 + r < f ? f0 + r : f0) * p + i];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(w, v[e], acc[r][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < FC; ++r)
        if (f0 + r < f)
          store_vec<T, VEC>(y + static_cast<long long>(f0 + r) * L + col,
                            acc[r]);
    }
  }
}

template <typename T, int VEC>
int launch_vec(const void* x, const float* a, void* y, int p, int f,
               long long L, int sms, cudaStream_t stream) {
  const long long groups = L / VEC;
  const long long want = (groups + THREADS - 1) / THREADS;
  // enough blocks to fill every SM several times over; the grid-stride loop
  // covers the rest
  const long long cap = static_cast<long long>(sms) * 16;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  const size_t smem = static_cast<size_t>(f) * p * sizeof(float);
  const T* tx = static_cast<const T*>(x);
  T* ty = static_cast<T*>(y);
#define ENC_CASE(FC_)                                                         \
  if (f >= FC_MAX || f == FC_) {                                              \
    checksum_encode_kernel<T, VEC, FC_><<<blocks, THREADS, smem, stream>>>(   \
        tx, a, ty, p, f, L, groups);                                          \
    return 0;                                                                 \
  }
  ENC_CASE(4) ENC_CASE(3) ENC_CASE(2) ENC_CASE(1)
#undef ENC_CASE
  return -5;
}

template <typename T>
int launch_typed(const void* x, const float* a, void* y, int p, int f,
                 long long L, int sms, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (aligned && L % V == 0)
    return launch_vec<T, V>(x, a, y, p, f, L, sms, stream);
  return launch_vec<T, 1>(x, a, y, p, f, L, sms, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes.  Device pointers of contiguous
// row-major tensors: x [p, m, n] viewed as [p, L], a [f, p] fp32,
// y [f, L] in x's type (kind 0 fp32, 1 bf16).  `sms` is the card's SM
// count (it sizes the grid).  Launches on `stream` without synchronising.
// Returns 0, cudaGetLastError() of the launch, or a negative code for
// arguments the kernel does not take (-1 f or p, -2 kind, -4 L).
extern "C" int checksum_encode_launch(const void* x, const void* a, void* y,
                                      int p, int f, long long L, int kind,
                                      int sms, void* stream) {
  if (f < 1 || p < 1 || f * p > SMEM_FLOATS) return -1;
  if (L < 1) return -4;
  const float* fa = static_cast<const float*>(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (kind == K_F32) {
    rc = launch_typed<float>(x, fa, y, p, f, L, sms, s);
  } else if (kind == K_BF16) {
    rc = launch_typed<Bf16>(x, fa, y, p, f, L, sms, s);
  } else {
    return -2;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
