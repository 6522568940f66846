// Accumulate step C_out = C_in + A @ B with a carried dual-checksum state
// and a fused verify/correct prologue, for Hopper (sm_90a): tensor-core
// tiles for the SUMMA step, CUDA cores for small tiles.
//
// Replaces the TPU kernel src/repro/kernels/abft_matmul.py::
// abft_matmul_acc_pallas (its `_kernel` with carry_in=True and the
// `_verify_correct` prologue).  It computes what that kernel computes, not
// its pipelined grid: one CTA owns one (BM, BN) tile of C and loops over k
// itself.  The tile picks the route (kernels/abft_matmul.py::route_of
// decides; the launcher reports what ran in `info`):
//
//   Tensor cores, (128, 128) and (128, 64): the ring's first stages
//     issued, then the prologue below on the C_in tile in the ring's free
//     slot while they fly, the repaired tile staged through shared memory
//     into the mma fragments, abft_mma.cuh's ring mainloop (kernel #1's
//     route A: 3xTF32 m16n8k8 for fp32, bf16 m16n8k16, s8 m16n8k32 into
//     int32), the fragments staged back, abft_tile.cuh's epilogue.  The
//     running sum starts from the repaired C_in and takes each ring
//     stage's tensor-core partial (64 k of fp32), summed from zero, by an
//     fp32 add: a late SUMMA step carries a C_in far larger than one
//     stage's partial, and the tensor core's own accumulation may
//     truncate.  int8 accumulates exactly on top of __float2int_rn(C_in).
//     Copy widths are kernel #1's (`copy_width`): misaligned rows take
//     narrower cp.async chunks and nothing is padded per call.
//   CUDA cores, every other tile of TILES_M x TILES_N (the chaos
//     campaign's 32 x 32, small SUMMA blocks): the same prologue, the
//     fmaf k loop and the epilogue of abft_tile.cuh.
//
// Prologue, per CTA, with verify on:
//   * the C_in tile is loaded into registers as fp32 (int32 C_in too, as
//     the reference loads it); rows and columns past the edge read as 0,
//     the reference's zero padding, so scale = mean |C_in| is taken over
//     the full BM x BN tile;
//   * the plain-sum column and row checksums of the tile are recomputed with
//     the epilogue's own routines (col_sums / row_sums), so a state that
//     this kernel or kernel #1 wrote re-verifies with residual exactly 0;
//   * residuals against the carried state, argmax of each direction with
//     ties to the lowest index (NaN first, as jnp.argmax), the second
//     largest residual, the 0.25 concentration gate, and the masked re-sum
//     x = (carried - sum_others) / (w0[r] + 1e-30) of the single corrupted
//     element, in two passes (a pass that repairs nothing leaves the tile as
//     it was, so the second pass runs only after a repair);
//   * stats[ti, tj, 0..7] = detected, corrected, global row, global col
//     (-1 unless corrected), cmax, rmax, tol_c, scale, from the first pass.
// With verify off the tile is copied and the stats are 0 with -1 in 2-3.
// The accumulator starts from the repaired tile: fp32, or int32 rounded
// half to even (__float2int_rn, as jnp.round) for int8 operands.
//
// In place is safe: each CTA reads its own C_in tile and its own slices of
// the carried state in the prologue, before any of its epilogue writes, and
// no other CTA touches them; so c_out may alias c_in and the new state the
// old one (the pointers are not __restrict__).
//
// What bounds it on an H100: at the SUMMA step shape (3072^3) the 2mkn
// operations at the tensor-core rate of the operand type (495/3 TFLOP/s
// for 3xTF32, 989 bf16, 1979 int8); the prologue adds one read of C_in
// and O(mn) reductions.  The design moves the products onto the tensor
// cores and keeps their pipe fed (a stage partial instead of an add per
// k step, 256-byte stages, the prologue overlapped with the ring's fill).
// What it leaves: a 32-deep fp32 stage runs at about a third of the
// card's TF32 rate on mma.sync, and a wgmma loop (B split to K-major at
// landing) ran no faster on an H100, so the stage's memory pipeline is
// the next target (TMA, a producer warp); 576 tiles are 4.4 waves on 132
// SMs, and a tile's prologue and epilogue idle the tensor cores (one CTA
// an SM).
#include "abft_mma.cuh"

using namespace abft;
namespace am = abft_mma;

namespace {

constexpr int STATS_WIDTH = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float as_float(int x) { return static_cast<float>(x); }

// The C_in tile of this thread, (ty + 16 i, tx + 16 j), as fp32, zero past
// the edge: one branch-free block of loads, all in flight together.
template <typename TS, int BM, int BN>
__device__ __forceinline__ void load_tile(float (&v)[BM / 16][BN / 16],
                                          const void* c, int m, int n,
                                          int m0, int n0) {
  const TS* p = static_cast<const TS*>(c);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int row = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = n0 + tx + 16 * j;
      v[i][j] = (row < m && col < n)
          ? as_float(p[static_cast<long long>(row) * n + col]) : 0.0f;
    }
  }
}

template <typename TC> __device__ __forceinline__ TC to_acc(float x);
template <> __device__ __forceinline__ float to_acc<float>(float x) { return x; }
template <> __device__ __forceinline__ int to_acc<int>(float x) {
  return __float2int_rn(x);   // round half to even, as jnp.round
}

// (a, ia) ranks before (b, ib) under jnp.argmax: NaN first, then the larger
// value, ties to the lower index.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;   // NaN tests (no fast-math)
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

// Run by one whole warp: argmax of x[0, len), its value, and the largest
// value at any other index (0 if there is none), as the reference's
// max(where(sel, 0, x)) of non-negative residuals.
__device__ void warp_argmax(const float* x, int len, float* out_max,
                            int* out_idx, float* out_2nd) {
  const int lane = threadIdx.x % 32;
  float best = -__int_as_float(0x7f800000);   // -inf
  int bi = 0x7fffffff;
  for (int i = lane; i < len; i += 32)
    if (beats(x[i], i, best, bi)) { best = x[i]; bi = i; }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(FULL_MASK, best, off);
    const int oi = __shfl_down_sync(FULL_MASK, bi, off);
    if (beats(ob, oi, best, bi)) { best = ob; bi = oi; }
  }
  bi = __shfl_sync(FULL_MASK, bi, 0);
  float sec = 0.0f;
  for (int i = lane; i < len; i += 32)
    if (i != bi) sec = fmaxf(sec, x[i]);
  for (int off = 16; off > 0; off >>= 1)
    sec = fmaxf(sec, __shfl_down_sync(FULL_MASK, sec, off));
  if (lane == 0) {
    *out_max = best;
    *out_idx = bi;
    *out_2nd = sec;
  }
}

// |plain-sum checksum - carried|: the column (row) residuals of a tile
// into res[cc] (res[r]).  Element cc (r) is reduced by thread cc (r) of
// the CTA (BN, BM <= THREADS), so `carried` is that thread's value of the
// carried ccol[ti, 0, col] (crow[tj, row, 0]), loaded up front, 0 past
// the edge.
struct ColResidualSink {
  float* res;
  float carried;
  __device__ void operator()(int /*fi*/, int cc, float s) const {
    res[cc] = fabsf(s - carried);
  }
};

struct RowResidualSink {
  float* res;
  float carried;
  __device__ void operator()(int r, int /*fi*/, float s) const {
    res[r] = fabsf(s - carried);
  }
};

struct StoreSink {
  float* out;
  __device__ void operator()(int /*fi*/, int cc, float s) const { out[cc] = s; }
};

// The prologue of both routes: the C_in tile (ti, tj) of a grid of nt
// tile columns into v as fp32 in the epilogue's (ty + 16 i, tx + 16 j)
// layout, and with verify on the verify/correct of it against the carried
// state, writing the tile's stats.  `red` is shared memory of at least
// Smem<float, BM, BN>::EPI bytes, free again on return.
template <int BM, int BN>
__device__ __forceinline__ void prologue(
    float (&v)[BM / 16][BN / 16], const void* c_in, const float* ccol_in,
    const float* crow_in, const float* __restrict__ wm,
    const float* __restrict__ wn, float* __restrict__ stats, int m, int n,
    int f, int out_kind, int verify, float tol_c_unit, float tol_r_unit,
    float* red, int ti, int tj, int nt) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  __shared__ float res_c[BN];   // column residuals, then masked column sums
  __shared__ float res_r[BM];   // row residuals
  __shared__ float sc[5];       // cmax, c2nd, rmax, r2nd, scale
  __shared__ int si[2];         // cidx, ridx
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = ti * BM, n0 = tj * BN;
  float* st = stats + (static_cast<long long>(ti) * nt + tj) * STATS_WIDTH;
  static_assert(BM <= THREADS && BN <= THREADS, "one residual a thread");

  // every global load of the prologue first, so that they fly together:
  // the weights, this thread's carried plain-sum checksums, the tile
  TileWeights<BM, BN> w;
  float carried_c = 0.0f, carried_r = 0.0f;
  if (verify) {
    load_weights<BM, BN>(w, wm, wn, m, n, f, 1, m0, n0);
    if (tid < BN && n0 + tid < n)
      carried_c = ccol_in[static_cast<long long>(ti) * f * n + n0 + tid];
    if (tid < BM && m0 + tid < m)
      carried_r = crow_in[(static_cast<long long>(tj) * m + m0 + tid) * f];
  }
  if (out_kind == OUT_BF16)
    load_tile<__nv_bfloat16, BM, BN>(v, c_in, m, n, m0, n0);
  else if (out_kind == OUT_I32)
    load_tile<int, BM, BN>(v, c_in, m, n, m0, n0);
  else
    load_tile<float, BM, BN>(v, c_in, m, n, m0, n0);

  if (verify) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s += fabsf(v[i][j]);
    red[tid] = s;
    __syncthreads();
    if (tid == 0) {
      float t = 0.0f;
      for (int e = 0; e < THREADS; ++e) t += red[e];
      sc[4] = t / static_cast<float>(BM * BN) + 1e-30f;
    }
    __syncthreads();
    const float scale = sc[4];
    const float tol_c = tol_c_unit * scale;   // tol_factor * BM * eps_c * scale
    const float tol_r = tol_r_unit * scale;   // tol_factor * BN * eps_c * scale
    for (int pass = 0; pass < 2; ++pass) {
      col_sums<BM, BN>(v, w, 1, red, ColResidualSink{res_c, carried_c});
      row_sums<BM, BN>(v, w, 1, red, RowResidualSink{res_r, carried_r});
      if (tid < 32) {
        warp_argmax(res_c, BN, &sc[0], &si[0], &sc[1]);
      } else if (tid < 64) {
        warp_argmax(res_r, BM, &sc[2], &si[1], &sc[3]);
      }
      __syncthreads();
      const float cmax = sc[0], c2nd = sc[1], rmax = sc[2], r2nd = sc[3];
      const int cidx = si[0], ridx = si[1];
      const bool detected = cmax > tol_c || rmax > tol_r;
      const bool single = cmax > tol_c && rmax > tol_r &&
                          c2nd <= fmaxf(0.25f * cmax, tol_c) &&
                          r2nd <= fmaxf(0.25f * rmax, tol_r);
      if (pass == 0 && tid == 0) {
        st[0] = detected ? 1.0f : 0.0f;
        st[1] = single ? 1.0f : 0.0f;
        st[2] = single ? static_cast<float>(m0 + ridx) : -1.0f;
        st[3] = single ? static_cast<float>(n0 + cidx) : -1.0f;
        st[4] = cmax;
        st[5] = rmax;
        st[6] = tol_c;
        st[7] = scale;
      }
      if (!single) break;
      // masked re-sum: the column's plain sum without the located element
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (ty + 16 * i == ridx && tx + 16 * j == cidx) v[i][j] = 0.0f;
      col_sums<BM, BN>(v, w, 1, red, StoreSink{res_c});
      const float carried =
          n0 + cidx < n ? ccol_in[static_cast<long long>(ti) * f * n + n0 + cidx]
                        : 0.0f;
      const float w0r = m0 + ridx < m ? wm[m0 + ridx] : 0.0f;
      const float x_new = (carried - res_c[cidx]) / (w0r + 1e-30f);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (ty + 16 * i == ridx && tx + 16 * j == cidx) v[i][j] = x_new;
    }
  } else if (tid == 0) {
    for (int e = 0; e < STATS_WIDTH; ++e)
      st[e] = (e == 2 || e == 3) ? -1.0f : 0.0f;
  }
}

// CUDA-core route: every tile of TILES_M x TILES_N outside the tensor-core
// tiles (the chaos campaign's 32 x 32, small SUMMA blocks).
template <typename TIn, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
abft_matmul_acc_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                       const float* __restrict__ wm,
                       const float* __restrict__ wn, const void* c_in,
                       const float* ccol_in, const float* crow_in, void* c_out,
                       float* ccol_out, float* crow_out,
                       float* __restrict__ stats, int m, int k, int n, int f,
                       int out_kind, int verify, float tol_c_unit,
                       float tol_r_unit) {
  using TC = typename Compute<TIn>::type;
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  __shared__ __align__(16) unsigned char smem[Smem<TC, BM, BN>::BYTES];
  float v[TM][TN];
  prologue<BM, BN>(v, c_in, ccol_in, crow_in, wm, wn, stats, m, n, f,
                   out_kind, verify, tol_c_unit, tol_r_unit,
                   reinterpret_cast<float*>(smem), blockIdx.y, blockIdx.x,
                   gridDim.x);
  TC acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = to_acc<TC>(v[i][j]);
  mainloop<TIn, BM, BN>(a, b, m, k, n, blockIdx.y * BM, blockIdx.x * BN, acc,
                        smem);
  epilogue<TC, BM, BN>(acc, c_out, ccol_out, crow_out, wm, wn, m, n, f,
                       out_kind, smem, blockIdx.y, blockIdx.x);
}

// Tensor-core route, (128, 128) and (128, 64): the ring's first stages
// issued, the same prologue in the ring's free slot while they fly, the
// repaired tile staged into the mma fragments, abft_mma.cuh's ring
// mainloop, the fragments staged back, the same epilogue.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(THREADS, 1)
acc_mma_kernel(const T* __restrict__ a, const T* __restrict__ b,
               const float* __restrict__ wm, const float* __restrict__ wn,
               const void* c_in, const float* ccol_in, const float* crow_in,
               void* c_out, float* ccol_out, float* crow_out,
               float* __restrict__ stats, int m, int k, int n, int f,
               int out_kind, int verify, float tol_c_unit, float tol_r_unit,
               int wa, int wb) {
  using C = am::TileCfg<T, BM, BN>;
  using TC = typename am::Mma<T>::Acc;
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int mt = (m + BM - 1) / BM, nt = (n + BN - 1) / BN;
  int ti, tj;
  am::tile_of(mt, nt, ti, tj);
  const int m0 = ti * BM, n0 = tj * BN;
  // the ring's first stages fly while the prologue runs in its free slot
  am::ring_prefetch<T, BM, BN>(a, b, m, k, n, m0, n0, wa, wb, smem);
  unsigned char* slot = am::free_slot<T, BM, BN>(smem);
  TC acc[C::MF][C::NF][4];
  {
    float v[TM][TN];
    prologue<BM, BN>(v, c_in, ccol_in, crow_in, wm, wn, stats, m, n, f,
                     out_kind, verify, tol_c_unit, tol_r_unit,
                     reinterpret_cast<float*>(slot), ti, tj, nt);
    TC w[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) w[i][j] = to_acc<TC>(v[i][j]);
    am::tile_to_frags<T, BM, BN>(w, acc, slot);
  }
  am::ring_mainloop<T, BM, BN>(a, b, m, k, n, m0, n0, wa, wb, acc, smem);
  TC out[TM][TN];
  am::frags_to_tile<T, BM, BN>(acc, out, smem);
  epilogue<TC, BM, BN>(out, c_out, ccol_out, crow_out, wm, wn, m, n, f,
                       out_kind, smem, ti, tj);
}

template <typename T, int BM, int BN>
int launch_mma(const T* a, const T* b, const float* wm, const float* wn,
               const void* c_in, const float* ccol_in, const float* crow_in,
               void* c_out, float* ccol_out, float* crow_out, float* stats,
               int m, int k, int n, int f, int out_kind, int verify,
               float tol_c_unit, float tol_r_unit, int wa, int wb,
               cudaStream_t stream) {
  using C = am::TileCfg<T, BM, BN>;
  static int attr = -1;   // once per instantiation
  if (attr < 0)
    attr = static_cast<int>(cudaFuncSetAttribute(
        acc_mma_kernel<T, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM));
  if (attr != 0) return attr;
  const dim3 grid(((n + BN - 1) / BN) * ((m + BM - 1) / BM));
  acc_mma_kernel<T, BM, BN><<<grid, THREADS, C::SMEM, stream>>>(
      a, b, wm, wn, c_in, ccol_in, crow_in, c_out, ccol_out, crow_out, stats,
      m, k, n, f, out_kind, verify, tol_c_unit, tol_r_unit, wa, wb);
  return 0;
}

template <typename TIn>
int launch_typed(const void* a, const void* b, const float* wm,
                 const float* wn, const void* c_in, const float* ccol_in,
                 const float* crow_in, void* c_out, float* ccol_out,
                 float* crow_out, float* stats, int m, int k, int n, int f,
                 int bm, int bn, int out_kind, int verify, float tol_c_unit,
                 float tol_r_unit, int* info, cudaStream_t stream) {
  constexpr int S = sizeof(TIn);
  const TIn* ta = static_cast<const TIn*>(a);
  const TIn* tb = static_cast<const TIn*>(b);
  if (bm == 128 && (bn == 128 || bn == 64)) {
    const int wa = am::copy_width(a, static_cast<long long>(k) * S, S, 16);
    const int wb = am::copy_width(b, static_cast<long long>(n) * S, S, 16);
    if (info) { info[0] = 1; info[1] = wa; info[2] = wb; info[3] = 1; }
    if (bn == 128)
      return launch_mma<TIn, 128, 128>(
          ta, tb, wm, wn, c_in, ccol_in, crow_in, c_out, ccol_out, crow_out,
          stats, m, k, n, f, out_kind, verify, tol_c_unit, tol_r_unit, wa, wb,
          stream);
    return launch_mma<TIn, 128, 64>(
        ta, tb, wm, wn, c_in, ccol_in, crow_in, c_out, ccol_out, crow_out,
        stats, m, k, n, f, out_kind, verify, tol_c_unit, tol_r_unit, wa, wb,
        stream);
  }
  if (info) { info[0] = 0; info[1] = S; info[2] = S; info[3] = 1; }
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
#define ABFT_ACC_CASE(BM_, BN_)                                               \
  if (bm == BM_ && bn == BN_) {                                               \
    abft_matmul_acc_kernel<TIn, BM_, BN_><<<grid, THREADS, 0, stream>>>(      \
        ta, tb, wm, wn, c_in, ccol_in, crow_in, c_out, ccol_out, crow_out,    \
        stats, m, k, n, f, out_kind, verify, tol_c_unit, tol_r_unit);         \
    return 0;                                                                 \
  }
  ABFT_ACC_CASE(16, 32) ABFT_ACC_CASE(16, 64) ABFT_ACC_CASE(16, 128)
  ABFT_ACC_CASE(32, 32) ABFT_ACC_CASE(32, 64) ABFT_ACC_CASE(32, 128)
  ABFT_ACC_CASE(64, 32) ABFT_ACC_CASE(64, 64) ABFT_ACC_CASE(64, 128)
  ABFT_ACC_CASE(128, 32)
#undef ABFT_ACC_CASE
  return -3;
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous row-major tensors: a [m, k], b [k, n], wm [f, m] fp32,
// wn [n, f] fp32, c_in / c_out [m, n] of the output type,
// ccol_in / ccol_out [ceil(m/bm), f, n] fp32, crow_in / crow_out
// [ceil(n/bn), m, f] fp32, stats [ceil(m/bm), ceil(n/bn), 8] fp32.  c_out may
// be c_in and the new state the old one.  tol_c_unit / tol_r_unit are
// tol_factor * bm * eps_c and tol_factor * bn * eps_c.  `info`, a host
// array of 4 ints or null, receives the route the tile ran (1 tensor-core
// tiles, 0 CUDA cores), A's and B's copy widths in bytes and 1.  Launches
// on `stream` without synchronising.  Returns 0, cudaGetLastError() of the
// launch, or a negative code for arguments the kernel does not take (-1 f,
// -2 dtype pair, -3 tile, -4 empty shape).
extern "C" int abft_matmul_acc_launch(
    const void* a, const void* b, const void* wm, const void* wn,
    const void* c_in, const void* ccol_in, const void* crow_in, void* c_out,
    void* ccol_out, void* crow_out, void* stats, int m, int k, int n, int f,
    int bm, int bn, int in_kind, int out_kind, int verify, float tol_c_unit,
    float tol_r_unit, int* info, void* stream) {
  if (f < 1 || f > FMAX) return -1;
  if (m < 1 || k < 1 || n < 1) return -4;
  const float* fwm = static_cast<const float*>(wm);
  const float* fwn = static_cast<const float*>(wn);
  const float* fci = static_cast<const float*>(ccol_in);
  const float* fri = static_cast<const float*>(crow_in);
  float* fco = static_cast<float*>(ccol_out);
  float* fro = static_cast<float*>(crow_out);
  float* fst = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (in_kind == IN_F32 && (out_kind == OUT_F32 || out_kind == OUT_BF16)) {
    rc = launch_typed<float>(a, b, fwm, fwn, c_in, fci, fri, c_out, fco, fro,
                             fst, m, k, n, f, bm, bn, out_kind, verify,
                             tol_c_unit, tol_r_unit, info, s);
  } else if (in_kind == IN_BF16 &&
             (out_kind == OUT_F32 || out_kind == OUT_BF16)) {
    rc = launch_typed<__nv_bfloat16>(a, b, fwm, fwn, c_in, fci, fri, c_out,
                                     fco, fro, fst, m, k, n, f, bm, bn,
                                     out_kind, verify, tol_c_unit, tol_r_unit,
                                     info, s);
  } else if (in_kind == IN_I8 && out_kind == OUT_I32) {
    rc = launch_typed<int8_t>(a, b, fwm, fwn, c_in, fci, fri, c_out, fco, fro,
                              fst, m, k, n, f, bm, bn, out_kind, verify,
                              tol_c_unit, tol_r_unit, info, s);
  } else {
    return -2;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
