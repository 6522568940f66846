// One-shot C = A @ B with fused dual (column + row) checksum partials, for
// Hopper (sm_90a): tensor-core tiles for prefill and training, a split-k
// stream for decode.
//
// Replaces the TPU kernel src/repro/kernels/abft_matmul.py::abft_matmul_pallas
// (its `_kernel` with carry_in=False and the `_tile_checksums` epilogue).
// It computes what that kernel computes, not its block layout.  The output
// is c [m, n] and the per-tile partials of the ROUNDED stored tile,
// ccol [ceil(m/bm), f, n] (ccol[i] = W_m[:, tile_i] @ C_tile) and
// crow [ceil(n/bn), m, f] (crow[j] = C_tile @ W_n[tile_j, :]); summing them
// over axis 0 is the caller's second pass, so nothing here uses atomics and
// two calls on the same inputs are bit-identical.  Ragged edges are masked
// (zero rows and columns checksum to zero).  Every route ends in
// abft_tile.cuh's `epilogue`, the routine kernel #2's verify prologue
// recomputes, so the checksum semantics are those of the CUDA-core design
// this kernel replaced.
//
// The tile (bm, bn) picks the route:
//
//   Route A, (128, 128) or (128, 64): one CTA of 8 warps per output tile,
//     running abft_mma.cuh's ring mainloop, the one kernel #2's
//     tensor-core route runs too: mma.sync fragments, 3xTF32 m16n8k8 for
//     fp32 operands (fp32-level error, not TF32's), bf16 m16n8k16 and s8
//     m16n8k32 (exact, int32) otherwise, k moving through a 3-stage
//     cp.async ring of 256-byte stages, each summed in the tensor core
//     from zero and added to the accumulator in fp32, tiles walked in
//     groups of 4 tile rows.  The accumulator starts at 0; after the last
//     stage the ring's bytes hold the fp32 (int32) tile, which each thread
//     reloads in the epilogue's (ty + 16 i, tx + 16 j) layout.
//   Route B, bm in {16, 32}: decode, where the work is bytes of B.  Pass 1
//     cuts k into `splits` slices; one CTA per (128 columns, slice, MB rows)
//     holds its rows of A in shared memory, streams its slice of B once with
//     vector loads (eight rows in flight per thread), sums on CUDA cores and
//     writes fp32 (int32) partials to the workspace ws [splits, m, n] after
//     a fixed-order reduction over its row groups.  Pass 2, one CTA per
//     (bm, bn) tile, sums the partials in split order and runs the epilogue.
//
// Copy widths.  An encoded weight has n + 2 columns, so its rows are often
// not 16-byte aligned (898 fp32 columns: 3592 bytes, 8 mod 16).  The
// launcher takes the widest copy (16, 8 or 4 bytes; element by element
// below 4) that divides both the base pointer and the row stride, for A
// and B apart, and writes its choice to `info`.  Nothing is padded or
// copied per call.
//
// What bounds it on an H100: at prefill and training shapes (m >= 64) the
// operations (2mkn at 495/3 TFLOP/s for 3xTF32, 989 bf16, 1979 int8); at
// decode the bytes of B (k n at 3.35 TB/s).  What it leaves on the table:
// TMA and a producer warp for the ring (route A runs the warp-level mma;
// a wgmma loop alone ran no faster), a persistent grid (wave
// quantization, epilogues overlapped with mainloops), and a split-k in
// one launch.
#include <cstring>

#include "abft_mma.cuh"
#include "abft_tile.cuh"

using namespace abft;
namespace am = abft_mma;

namespace {

using am::Raw;

// ---------------------------------------------------------------------------
// Route A: tensor-core tiles behind the cp.async ring (abft_mma.cuh)
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(THREADS, 1)
mma_kernel(const T* __restrict__ a, const T* __restrict__ b,
           const float* __restrict__ wm, const float* __restrict__ wn,
           void* __restrict__ c, float* __restrict__ ccol,
           float* __restrict__ crow, int m, int k, int n, int f, int out_kind,
           int wa, int wb) {
  using C = am::TileCfg<T, BM, BN>;
  using TC = typename am::Mma<T>::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  int ti, tj;
  am::tile_of((m + BM - 1) / BM, (n + BN - 1) / BN, ti, tj);
  const int m0 = ti * BM, n0 = tj * BN;
  TC acc[C::MF][C::NF][4];
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int j = 0; j < C::NF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = TC(0);
  am::ring_prefetch<T, BM, BN>(a, b, m, k, n, m0, n0, wa, wb, smem);
  am::ring_mainloop<T, BM, BN>(a, b, m, k, n, m0, n0, wa, wb, acc, smem);
  TC v[BM / 16][BN / 16];
  am::frags_to_tile<T, BM, BN>(acc, v, smem);
  epilogue<TC, BM, BN>(v, c, ccol, crow, wm, wn, m, n, f, out_kind, smem, ti,
                       tj);
}

template <typename T, int BM, int BN>
int launch_mma(const void* a, const void* b, const float* wm, const float* wn,
               void* c, float* ccol, float* crow, int m, int k, int n, int f,
               int out_kind, int wa, int wb, cudaStream_t stream) {
  using C = am::TileCfg<T, BM, BN>;
  static int attr = -1;   // once per instantiation
  if (attr < 0)
    attr = static_cast<int>(cudaFuncSetAttribute(
        mma_kernel<T, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM));
  if (attr != 0) return attr;
  const dim3 grid(((n + BN - 1) / BN) * ((m + BM - 1) / BM));
  mma_kernel<T, BM, BN><<<grid, THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), wm, wn, c, ccol,
      crow, m, k, n, f, out_kind, wa, wb);
  return 0;
}

// ---------------------------------------------------------------------------
// Route B: split-k stream for decode
// ---------------------------------------------------------------------------

// The split policy (slices, rows a CTA) is the caller's (abft_matmul.py's
// split_count / split_rows); these sizes are compiled in and checked.
constexpr int SK_COLS = 128;   // columns of B per CTA (SPLIT_COLS)
constexpr int SK_KMAX = 256;   // most k rows in a slice (SPLIT_KMAX)
constexpr int UNROLL = 8;      // rows of B in flight per thread

// Pass 1: partials of rows [m0, m0 + MB) over k slice blockIdx.y, columns
// [n0, n0 + 128), into ws [splits, m, n].  V values a thread per row of B
// (one load of V * sizeof(T) bytes); TPR threads cover a row, RPI rows run
// side by side, each thread has UNROLL loads in flight and sums its rows
// in order.
template <typename T, int MB, int V>
__global__ void __launch_bounds__(THREADS)
splitk_partial(const T* __restrict__ a, const T* __restrict__ b,
               typename Compute<T>::type* __restrict__ ws, int m, int k, int n,
               int kslice) {
  using TC = typename Compute<T>::type;
  using Vec = typename Raw<V * sizeof(T)>::type;
  constexpr int TPR = SK_COLS / V;
  constexpr int RPI = THREADS / TPR;
  constexpr int MC = MB < 32 / V ? MB : 32 / V;   // rows a reduction round
  constexpr int AS = SK_KMAX * MB;
  constexpr int RED = RPI * MC * SK_COLS;
  __shared__ __align__(16) TC sm[AS > RED ? AS : RED];
  const int tid = threadIdx.x;
  const int grp = tid / TPR, lc = (tid % TPR) * V;
  const int n0 = blockIdx.x * SK_COLS, s = blockIdx.y, m0 = blockIdx.z * MB;
  const int k0 = s * kslice;
  const int klen = min(kslice, k - k0);

  // this slice of A, transposed: sm[kk * MB + mm]
  for (int e = tid; e < MB * klen; e += THREADS) {
    const int mm = e / klen, kk = e % klen;
    const int row = m0 + mm;
    sm[kk * MB + mm] = row < m
        ? to_compute(a[static_cast<long long>(row) * k + k0 + kk]) : TC(0);
  }
  __syncthreads();

  TC acc[MB][V];
#pragma unroll
  for (int mm = 0; mm < MB; ++mm)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[mm][v] = TC(0);
  const int col = n0 + lc;
  const bool live = col < n;   // n % V == 0, so the whole vector is in
  const T* bp = b + static_cast<long long>(k0) * n + col;
  for (int kk = grp; kk < klen; kk += UNROLL * RPI) {
    Vec bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = kk + u * RPI;
      if (live && r < klen)
        bv[u] = *reinterpret_cast<const Vec*>(bp + static_cast<long long>(r) * n);
      else
        bv[u] = Vec{};
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = kk + u * RPI;
      if (r < klen) {
        T x[V];
        memcpy(x, &bv[u], sizeof(Vec));
        const TC* ar = sm + r * MB;
#pragma unroll
        for (int mm = 0; mm < MB; ++mm) {
          const TC av = ar[mm];
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[mm][v] = mac(acc[mm][v], av, to_compute(x[v]));
        }
      }
    }
  }
  __syncthreads();     // A's slice is spent: the bytes hold the reduction

#pragma unroll
  for (int mm0 = 0; mm0 < MB; mm0 += MC) {
#pragma unroll
    for (int i = 0; i < MC; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v)
        sm[(grp * MC + i) * SK_COLS + lc + v] = acc[mm0 + i][v];
    __syncthreads();
    for (int e = tid; e < MC * SK_COLS; e += THREADS) {
      const int i = e / SK_COLS, cc = e % SK_COLS;
      TC sum = TC(0);
      for (int gg = 0; gg < RPI; ++gg) sum += sm[(gg * MC + i) * SK_COLS + cc];
      const int row = m0 + mm0 + i, gc = n0 + cc;
      if (row < m && gc < n)
        ws[(static_cast<long long>(s) * m + row) * n + gc] = sum;
    }
    __syncthreads();
  }
}

// Pass 2: the partials of each (BM, BN) tile summed in split order, then
// the shared epilogue.
template <typename TC, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
splitk_epilogue(const TC* __restrict__ ws, int splits,
                const float* __restrict__ wm, const float* __restrict__ wn,
                void* __restrict__ c, float* __restrict__ ccol,
                float* __restrict__ crow, int m, int n, int f, int out_kind) {
  __shared__ __align__(16) unsigned char smem[Smem<TC, BM, BN>::EPI];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  TC acc[BM / 16][BN / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc[i][j] = TC(0);
  // split-major, so a thread's (BM/16) x (BN/16) loads of one split are
  // in flight together; each element still sums its splits in order
#pragma unroll 8
  for (int sp = 0; sp < splits; ++sp) {
    const TC* p = ws + static_cast<long long>(sp) * m * n;
    TC x[BM / 16][BN / 16];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int row = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        const int col = n0 + tx + 16 * j;
        x[i][j] = (row < m && col < n)
            ? p[static_cast<long long>(row) * n + col] : TC(0);
      }
    }
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) acc[i][j] += x[i][j];
  }
  epilogue<TC, BM, BN>(acc, c, ccol, crow, wm, wn, m, n, f, out_kind, smem,
                       blockIdx.y, blockIdx.x);
}

template <typename T, int MB>
int launch_partial(const T* a, const T* b, typename Compute<T>::type* ws,
                   int m, int k, int n, int splits, int kslice, int v,
                   cudaStream_t stream) {
  const dim3 grid((n + SK_COLS - 1) / SK_COLS, splits, (m + MB - 1) / MB);
  if (v == 4)
    splitk_partial<T, MB, 4><<<grid, THREADS, 0, stream>>>(a, b, ws, m, k, n,
                                                           kslice);
  else if (v == 2)
    splitk_partial<T, MB, 2><<<grid, THREADS, 0, stream>>>(a, b, ws, m, k, n,
                                                           kslice);
  else
    splitk_partial<T, MB, 1><<<grid, THREADS, 0, stream>>>(a, b, ws, m, k, n,
                                                           kslice);
  return 0;
}

template <typename T>
int launch_splitk(const void* a, const void* b, const float* wm,
                  const float* wn, void* c, float* ccol, float* crow,
                  void* ws, int m, int k, int n, int f, int bm, int bn,
                  int splits, int rows, int out_kind, int wb,
                  cudaStream_t stream) {
  using TC = typename Compute<T>::type;
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  TC* tws = static_cast<TC*>(ws);
  const int kslice = (k + splits - 1) / splits;
  if (splits < 1 || kslice > SK_KMAX || (splits - 1) * kslice >= k) return -5;
  const int v = wb / static_cast<int>(sizeof(T));
  if (rows == 4)
    launch_partial<T, 4>(ta, tb, tws, m, k, n, splits, kslice, v, stream);
  else if (rows == 8)
    launch_partial<T, 8>(ta, tb, tws, m, k, n, splits, kslice, v, stream);
  else if (rows == 16)
    launch_partial<T, 16>(ta, tb, tws, m, k, n, splits, kslice, v, stream);
  else if (rows == 32)
    launch_partial<T, 32>(ta, tb, tws, m, k, n, splits, kslice, v, stream);
  else
    return -5;
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
#define SPLITK_CASE(BM_, BN_)                                                 \
  if (bm == BM_ && bn == BN_) {                                               \
    splitk_epilogue<TC, BM_, BN_><<<grid, THREADS, 0, stream>>>(              \
        tws, splits, wm, wn, c, ccol, crow, m, n, f, out_kind);               \
    return 0;                                                                 \
  }
  SPLITK_CASE(16, 32) SPLITK_CASE(16, 64) SPLITK_CASE(16, 128)
  SPLITK_CASE(32, 32) SPLITK_CASE(32, 64) SPLITK_CASE(32, 128)
#undef SPLITK_CASE
  return -3;
}

template <typename T>
int launch_typed(const void* a, const void* b, const float* wm,
                 const float* wn, void* c, float* ccol, float* crow, void* ws,
                 int m, int k, int n, int f, int bm, int bn, int splits,
                 int rows, int out_kind, int* info, cudaStream_t stream) {
  constexpr int S = sizeof(T);
  if (bm == 128 && (bn == 128 || bn == 64)) {
    if (splits != 1) return -5;
    const int wa = am::copy_width(a, static_cast<long long>(k) * S, S, 16);
    const int wb = am::copy_width(b, static_cast<long long>(n) * S, S, 16);
    if (info) { info[0] = 1; info[1] = wa; info[2] = wb; info[3] = 1; }
    if (bn == 128)
      return launch_mma<T, 128, 128>(a, b, wm, wn, c, ccol, crow, m, k, n, f,
                                     out_kind, wa, wb, stream);
    return launch_mma<T, 128, 64>(a, b, wm, wn, c, ccol, crow, m, k, n, f,
                                  out_kind, wa, wb, stream);
  }
  if (bm == 16 || bm == 32) {
    if (ws == nullptr) return -6;
    // V = 1, 2 or 4 values a load
    const int wb = am::copy_width(b, static_cast<long long>(n) * S, S, 4 * S);
    if (info) { info[0] = 2; info[1] = S; info[2] = wb; info[3] = splits; }
    return launch_splitk<T>(a, b, wm, wn, c, ccol, crow, ws, m, k, n, f, bm,
                            bn, splits, rows, out_kind, wb, stream);
  }
  return -3;
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous row-major tensors: a [m, k], b [k, n], wm [f, m] fp32,
// wn [n, f] fp32, c [m, n], ccol [ceil(m/bm), f, n] fp32,
// crow [ceil(n/bn), m, f] fp32, and for route B (bm 16 or 32) the
// workspace ws [splits, m, n] of 4-byte values (fp32, int32 for int8), with
// `rows` (4, 8, 16 or 32) rows of A a pass-1 CTA; route A takes splits 1.
// `info`, a host array of 4 ints or null, receives the route (1 tensor-core
// tiles, 2 split-k), A's and B's copy widths in bytes and the split count.
// Launches on `stream` without synchronising.  Returns 0,
// cudaGetLastError() of the launches, or a negative code for arguments the
// kernel does not take (-1 f, -2 dtype pair, -3 tile, -4 empty shape,
// -5 split count or rows, -6 missing workspace).
extern "C" int abft_matmul_launch(const void* a, const void* b, const void* wm,
                                  const void* wn, void* c, void* ccol,
                                  void* crow, void* ws, int m, int k, int n,
                                  int f, int bm, int bn, int splits,
                                  int rows, int in_kind, int out_kind,
                                  int* info,
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
    rc = launch_typed<float>(a, b, fwm, fwn, c, fcol, frow, ws, m, k, n, f,
                             bm, bn, splits, rows, out_kind, info, s);
  } else if (in_kind == IN_BF16 &&
             (out_kind == OUT_F32 || out_kind == OUT_BF16)) {
    rc = launch_typed<__nv_bfloat16>(a, b, fwm, fwn, c, fcol, frow, ws, m, k,
                                     n, f, bm, bn, splits, rows, out_kind,
                                     info, s);
  } else if (in_kind == IN_I8 && out_kind == OUT_I32) {
    rc = launch_typed<int8_t>(a, b, fwm, fwn, c, fcol, frow, ws, m, k, n, f,
                              bm, bn, splits, rows, out_kind, info, s);
  } else {
    return -2;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
