// Grouped one-shot products Y[rows of expert e] = X[rows of e] @ W[e] with
// the §4.3 residual of every row reduced in the epilogue, for Hopper
// (sm_90a): kernel #1g, the routed experts' products of a mixture-of-
// experts layer.
//
// Replaces no TPU kernel: the reference runs its experts as a padded
// [E, C, D] einsum outside any Pallas kernel, unprotected.  This is kernel
// #1's tensor-core route (abft_matmul.cu, route A) over a ragged batch of
// products, so that the experts' products are checked as every other
// projection is, without a capacity buffer and without a copy of the
// weights.
//
// Inputs: X [rows, k], the rows sorted by expert; offsets [E + 1] (int64,
// on the device): expert e owns rows offsets[e] .. offsets[e + 1]; the
// stacked weights W [E, k, n] and their f checksum columns Wcs [E, k, f]
// (Wcs[e] = W[e] @ w_r), a separate tensor, so that no [E, k, n + f]
// copy of a layer's weights is made; wn [n + f, f] = [w_r; -I].
// Outputs: Y [rows, n] and Ycs [rows, f] (fp32), and the per-tile row
// partials crow [nt + 1, rows, f] of [Y, Ycs] @ wn, taken of the stored
// values: summed over axis 0 (the caller's second pass, in tile order, so
// two calls give the same bits) they are each row's residual
// Y @ w_r - Ycs.  Column checksums are not formed: the residual is
// row-wise.
//
// Schedule: a 2-D grid, x over the nt = ceil(n / BN) column tiles of W plus
// one tile for the checksum columns, y over (expert, m-tile) slots, at most
// ceil(rows / BM) + E of them.  Each CTA reads the offsets into shared
// memory and finds its expert and m-tile from the running count of each
// expert's ceil(rows_e / BM) tiles; a slot past the last tile returns at
// once.  So the host reads nothing: the tile map lives on the device.
// Each tile runs abft_mma.cuh's ring mainloop (3xTF32 mma.sync, a 3-stage
// cp.async ring) with its expert's A rows and W columns as the operands'
// bases, and masks the expert's ragged rows and the ragged columns as
// kernel #1 does.  The checksum tile runs the same loop over Wcs's f
// columns.
//
// What bounds it on an H100: the operations (2 rows k n at 495/3 TFLOP/s
// in 3xTF32), as kernel #1 at training shapes.  What it leaves on the
// table, beside kernel #1's own (TMA, a producer warp, a persistent grid):
// the checksum tile runs a full BN-wide mainloop for f live columns, and
// each expert's last m-tile is ragged (on average half a tile of idle
// rows an expert).
#include "abft_mma.cuh"
#include "abft_tile.cuh"

using namespace abft;
namespace am = abft_mma;

namespace {

constexpr int EMAX = 1024;   // most experts a call

// Writes a row partial of tile column tj into crow [nt + 1, rows, f] at
// the expert's row; rows past the expert's own are dropped.
struct GroupedRowSink {
  float* crow;
  int tj, f, rows, m0, m;
  long long row0;
  __device__ void operator()(int r, int fi, float s) const {
    const int row = m0 + r;
    if (row < m)
      crow[(static_cast<long long>(tj) * rows + row0 + row) * f + fi] = s;
  }
};

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS, 1)
grouped_mma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ wcs,
                   const long long* __restrict__ offsets,
                   const float* __restrict__ wn, float* __restrict__ y,
                   float* __restrict__ ycs, float* __restrict__ crow,
                   int rows, int k, int n, int f, int e_count, int wa,
                   int wb, int wbc) {
  using C = am::TileCfg<float, BM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_off[EMAX + 1];
  __shared__ int s_e, s_mt;
  for (int i = threadIdx.x; i <= e_count; i += THREADS) s_off[i] = offsets[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long slot = blockIdx.y;
    long long before = 0;
    int e = -1, mt = 0;
    for (int i = 0; i < e_count; ++i) {
      const long long tiles = (s_off[i + 1] - s_off[i] + BM - 1) / BM;
      if (slot < before + tiles) {
        e = i;
        mt = static_cast<int>(slot - before);
        break;
      }
      before += tiles;
    }
    s_e = e;
    s_mt = mt;
  }
  __syncthreads();
  const int e = s_e;
  if (e < 0) return;
  const long long row0 = s_off[e];
  const int m = static_cast<int>(s_off[e + 1] - row0);
  const int m0 = s_mt * BM;
  const int nt = (n + BN - 1) / BN;
  const bool cs = static_cast<int>(blockIdx.x) == nt;   // checksum columns
  const int nb = cs ? f : n;
  const int n0 = cs ? 0 : blockIdx.x * BN;
  const float* a = x + row0 * k;
  const float* b = cs ? wcs + static_cast<long long>(e) * k * f
                      : w + static_cast<long long>(e) * k * n;
  const int wbb = cs ? wbc : wb;

  float acc[C::MF][C::NF][4];
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int j = 0; j < C::NF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
  am::ring_prefetch<float, BM, BN>(a, b, m, k, nb, m0, n0, wa, wbb, smem);
  am::ring_mainloop<float, BM, BN>(a, b, m, k, nb, m0, n0, wa, wbb, acc,
                                   smem);
  float v[BM / 16][BN / 16];
  am::frags_to_tile<float, BM, BN>(acc, v, smem);

  // the epilogue: store the tile, then the row sums of the stored values
  // against this tile's rows of wn
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* wnt = cs ? wn + static_cast<long long>(n) * f : wn;
  TileWeights<BM, BN> tw;
#pragma unroll
  for (int fi = 0; fi < FMAX; ++fi) {
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) tw.m[fi][i] = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = n0 + tx + 16 * j;
      tw.n[fi][j] = fi < f && col < nb
          ? wnt[static_cast<long long>(col) * f + fi] : 0.0f;
    }
  }
  float* out = cs ? ycs : y;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int row = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = n0 + tx + 16 * j;
      v[i][j] = (row < m && col < nb)
          ? store_rounded(out, (row0 + row) * nb + col, v[i][j], OUT_F32)
          : 0.0f;
    }
  }
  row_sums<BM, BN>(v, tw, f, reinterpret_cast<float*>(smem),
                   GroupedRowSink{crow, static_cast<int>(blockIdx.x), f, rows,
                                  m0, m, row0});
}

template <int BM, int BN>
int launch(const float* x, const float* w, const float* wcs,
           const long long* offsets, const float* wn, float* y, float* ycs,
           float* crow, int rows, int k, int n, int f, int e_count,
           int slots, int wa, int wb, int wbc, cudaStream_t stream) {
  using C = am::TileCfg<float, BM, BN>;
  static int attr = -1;   // once per instantiation
  if (attr < 0)
    attr = static_cast<int>(cudaFuncSetAttribute(
        grouped_mma_kernel<BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM));
  if (attr != 0) return attr;
  const dim3 grid((n + BN - 1) / BN + 1, slots);
  grouped_mma_kernel<BM, BN><<<grid, THREADS, C::SMEM, stream>>>(
      x, w, wcs, offsets, wn, y, ycs, crow, rows, k, n, f, e_count, wa, wb,
      wbc);
  return 0;
}

}  // namespace

// Plain C entry point, bound with ctypes.  Device pointers of contiguous
// row-major fp32 tensors: x [rows, k], w [E, k, n], wcs [E, k, f],
// offsets [E + 1] int64 (non-decreasing, offsets[0] = 0, offsets[E] =
// rows), wn [n + f, f], y [rows, n], ycs [rows, f], crow [nt + 1, rows, f]
// with nt = ceil(n / bn).  `slots` is the grid's y extent, at least the sum
// over experts of ceil(rows_e / bm) (ceil(rows / bm) + E always is).
// `info`, a host array of 3 ints or null, receives the copy widths of x,
// w and wcs in bytes.  Launches on `stream` without synchronising.
// Returns 0, cudaGetLastError() of the launch, or a negative code for
// arguments the kernel does not take (-1 f, -3 tile, -4 empty shape,
// -7 too many experts).
extern "C" int abft_matmul_grouped_launch(const void* x, const void* w,
                                          const void* wcs,
                                          const void* offsets,
                                          const void* wn, void* y, void* ycs,
                                          void* crow, int rows, int k, int n,
                                          int f, int e_count, int slots,
                                          int bm, int bn, int* info,
                                          void* stream) {
  if (f < 1 || f > FMAX) return -1;
  if (rows < 1 || k < 1 || n < 1 || e_count < 1 || slots < 1) return -4;
  if (e_count > EMAX) return -7;
  const int wa = am::copy_width(x, static_cast<long long>(k) * 4, 4, 16);
  const int wb = am::copy_width(w, static_cast<long long>(n) * 4, 4, 16);
  const int wbc = am::copy_width(wcs, static_cast<long long>(f) * 4, 4, 16);
  if (info) { info[0] = wa; info[1] = wb; info[2] = wbc; }
  const float* fx = static_cast<const float*>(x);
  const float* fw = static_cast<const float*>(w);
  const float* fc = static_cast<const float*>(wcs);
  const long long* off = static_cast<const long long*>(offsets);
  const float* fwn = static_cast<const float*>(wn);
  float* fy = static_cast<float*>(y);
  float* fycs = static_cast<float*>(ycs);
  float* fcrow = static_cast<float*>(crow);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (bm == 128 && bn == 128)
    rc = launch<128, 128>(fx, fw, fc, off, fwn, fy, fycs, fcrow, rows, k, n,
                          f, e_count, slots, wa, wb, wbc, s);
  else if (bm == 128 && bn == 64)
    rc = launch<128, 64>(fx, fw, fc, off, fwn, fy, fycs, fcrow, rows, k, n,
                         f, e_count, slots, wa, wb, wbc, s);
  else
    return -3;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
