// Flash-attention forward with an in-kernel ABFT checksum, for Hopper
// (sm_90a), on CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_call
// (reached through flash_attention_pallas and flash_attention_checked).
// Q [BH, Sq, D], K and V [BH, Sk, D] (fp32 or bf16, widened to fp32 at
// load), O [BH, Sq, D] in Q's type.  For each row: fp32 scores
// s = (q . k) * scale, then softcap * tanhf(s / softcap) when a softcap is
// set; a positional mask (q_pos the global row, k_pos the global key, top
// left aligned): causal q_pos >= k_pos, a two-sided window
// |q_pos - k_pos| < window; the online softmax (m, l, acc) with
// NEG_INF = -1e30 (not -inf, so a fully masked chunk gives corr = 1) and p
// masked to 0 explicitly; o = acc / max(l, 1e-30) (NaN kept), rounded once
// to O's type.  IEEE expf/tanhf/division: the build has no fast math.
//
// CHECKSUM adds the reference's checksum recurrence, carried beside the
// state: cs <- cs * corr + p . vsum (vsum = sum_d v, per key) and a second
// row sum l2 <- l2 * corr + sum p, summed from the P tile in shared memory
// (a path apart from l's, which sums p in registers).  The epilogue writes
// per row r_pv = |sum_d o - cs/l| / (|cs/l| + 1) over the fp32 o and
// r_l = |l2/l - 1|, both 0 on a row with no live key.  Liveness is read
// from l2 > 0, not from l, the state a fault hits: a NaN or non-positive l
// on a live row gives r_l = inf (the reference gates on l > 0 and misses
// such a fault);
// the wrapper takes the max over each bq-row tile with torch.amax, which
// keeps a NaN.
//
// Design.  The TPU kernel walks a sequential (bh, q-tile, kv-chunk) grid
// with the state in VMEM; here one CTA of 256 threads owns 64 rows of one
// bh (one flat grid.x over the (bh, 64-row tile) pairs, so B.H is bounded
// only by grid.x's 2^31 - 1) and loops over the keys itself, 64 keys at a time, K and V staged
// through shared memory as fp32 (Q stays there for the whole sweep), the
// score tile and acc in registers.  Thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty + 16 i (i < 4): the 16 threads of a row sit in one half
// warp, so the row max and sums are xor shuffles, which leave the same
// value in every lane.  Scores: thread owns keys tx + 16 j (j < 4), reads
// Q and K as float4 along d (K rows padded by 4 floats: conflict-free).
// P.V: thread owns columns 64 g + 4 tx + e (e < 4, g < D / 64), reads P as
// float4 along keys and V as float4 along d.  Chunks of keys that no row
// of the CTA may see (past the causal diagonal, outside the window band)
// are skipped: on such a chunk the reference's recurrence is the identity
// (m stays, corr = exp(0) = 1, p = 0).  The chaos inject of the reference
// (delta into acc[row, 0] or l[row] of bh 0 once keys [0, key_end) are
// folded) lands at that point of the sweep: a chunk is split at key_end if
// it straddles it, and an inject aimed at a skipped chunk lands where the
// sweep passes it.  Rows past Sq and keys past Sk are masked, never read
// as data (their smem is zero).
//
// What bounds it on an H100: operations.  4 D flops per (row, key) pair
// the mask admits (q.k and p.v): 2.1 GFLOP per head at S = 4096, D = 64,
// causal, against 4.2 MB of Q, K, V and O in fp32, about 500 flops a byte,
// far above the card's ~20 fp32 flops per byte of HBM; so the least time
// is the flops over the 67 TFLOP/s fp32 CUDA-core peak.  bf16 inputs are
// widened to fp32 here, so against the tensor cores' bf16 rate, which is
// their bound, the simple design is far off.  What it leaves on the
// table: wgmma on bf16 (and 3xTF32 for fp32) operands, TMA/cp.async
// staging of K and V overlapped with the math (here a plain load, a
// __syncthreads and then the math), and 2+ CTAs per SM at D = 256 (its
// tiles take 211 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BR = 64;             // rows per CTA
constexpr int BC = 64;             // keys per chunk
constexpr int PS = BC + 4;         // P row stride (floats)
constexpr float NEG_INF = -1e30f;

enum Kind { K_F32 = 0, K_BF16 = 1 };
enum Target { T_NONE = 0, T_ACC = 1, T_L = 2 };

struct Bf16 {
  uint16_t bits;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(Bf16 x) {
  return __uint_as_float(static_cast<uint32_t>(x.bits) << 16);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(Bf16* p, float v) {
  p->bits = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float hw_max(float v) {   // over a half warp
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float hw_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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
};

// Stage keys [c0, c1) of one bh into smem (fp32), rows past c1 zero; with
// CHECKSUM also vsum[c] = sum_d v[c, d].  One warp per key row.
template <typename T, int D, bool CHECKSUM>
__device__ __forceinline__ void stage_kv(const T* __restrict__ k,
                                         const T* __restrict__ v, float* ks,
                                         float* vs, float* vsum,
                                         long long c0, long long c1) {
  constexpr int KS = D + 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BC; r += THREADS / 32) {
    const long long c = c0 + r;
    float part = 0.0f;
    if (c < c1) {
      const T* kr = k + c * D;
      const T* vr = v + c * D;
#pragma unroll
      for (int e = 0; e < D / 32; ++e) {
        const int d = lane + 32 * e;
        ks[r * KS + d] = widen(kr[d]);
        const float x = widen(vr[d]);
        vs[r * D + d] = x;
        part += x;
      }
    } else {
#pragma unroll
      for (int e = 0; e < D / 32; ++e) {
        const int d = lane + 32 * e;
        ks[r * KS + d] = 0.0f;
        vs[r * D + d] = 0.0f;
      }
    }
    if (CHECKSUM) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) vsum[r] = part;
    }
  }
}

template <typename T, int D, bool CHECKSUM>
__global__ void __launch_bounds__(THREADS)
flash_kernel(Params prm) {
  constexpr int KS = D + 4;          // Q and K row stride (floats)
  constexpr int NG = D / 64;         // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BR * KS;
  float* vs = ks + BC * KS;
  float* ps = vs + BC * D;
  float* vsum = ps + BR * PS;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // the flat grid: blockIdx.x = bh * q tiles + q tile
  const long long sq = prm.sq, sk = prm.sk;
  const long long qtiles = (sq + BR - 1) / BR;
  const long long bh = blockIdx.x / qtiles;
  const long long r0 = (blockIdx.x % qtiles) * BR;
  const T* q = static_cast<const T*>(prm.q) + bh * sq * D;
  const T* k = static_cast<const T*>(prm.k) + bh * sk * D;
  const T* v = static_cast<const T*>(prm.v) + bh * sk * D;

  // Q tile, rows past Sq zero
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < BR; r += THREADS / 32) {
      const long long row = r0 + r;
#pragma unroll
      for (int e = 0; e < D / 32; ++e) {
        const int d = lane + 32 * e;
        qs[r * KS + d] = row < sq ? widen(q[row * D + d]) : 0.0f;
      }
    }
  }

  // keys some row of this CTA may see: [kbeg, kend)
  const long long rlast = (r0 + BR < sq ? r0 + BR : sq) - 1;
  long long kbeg = 0, kend = sk;
  if (prm.causal && rlast + 1 < kend) kend = rlast + 1;
  if (prm.has_window) {
    if (rlast + prm.window < kend) kend = rlast + prm.window;
    if (r0 - prm.window + 1 > kbeg) kbeg = r0 - prm.window + 1;
  }

  float m[4], l[4], cs[4], l2[4];
  float acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
    cs[i] = 0.0f;
    l2[i] = 0.0f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.0f;
  }

  // the chaos inject: one row of bh 0, applied once
  const bool inj_here = prm.target != T_NONE && bh == 0 &&
                        prm.inj_row >= r0 && prm.inj_row < r0 + BR;
  const int inj_i = static_cast<int>(prm.inj_row - r0);   // local row
  bool injected = false;
  auto inject = [&]() {
    if (!inj_here || injected) return;
    injected = true;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ty + 16 * i != inj_i) continue;
      if (prm.target == T_L) l[i] += prm.inj_delta;     // every lane's copy
      else if (tx == 0) acc[i][0][0] += prm.inj_delta;  // column 0
    }
  };
  if (prm.inj_key_end <= kbeg) inject();

  for (long long c0 = kbeg; c0 < kend;) {
    long long c1 = c0 + BC < kend ? c0 + BC : kend;
    if (inj_here && c0 < prm.inj_key_end && prm.inj_key_end < c1)
      c1 = prm.inj_key_end;
    __syncthreads();             // the previous chunk's K, V, P are spent
    stage_kv<T, D, CHECKSUM>(k, v, ks, vs, vsum, c0, c1);
    __syncthreads();

    // scores: rows ty + 16 i, keys c0 + tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * KS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * KS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = r0 + ty + 16 * i;
      float sm[4];
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long c = c0 + tx + 16 * j;
        bool valid = c < c1;
        if (prm.causal) valid = valid && row >= c;
        if (prm.has_window)
          valid = valid && (row - c) < prm.window && (c - row) < prm.window;
        float x = s[i][j] * prm.scale;
        if (prm.softcap != 0.0f) x = prm.softcap * tanhf(x / prm.softcap);
        ok[j] = valid;
        sm[j] = valid ? x : NEG_INF;
        mx = fmaxf(mx, sm[j]);
      }
      const float m_new = fmaxf(m[i], hw_max(mx));
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sm[j] - m_new) : 0.0f;
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        psum += p;
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + hw_sum(psum);
      m[i] = m_new;
    }
    __syncthreads();             // P complete

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= corr[i];
#pragma unroll 2
    for (int c = 0; c < BC; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * PS + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &vs[(c + cc) * D + 64 * g + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                          : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][g][0] = fmaf(p, vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, vv.w, acc[i][g][3]);
          }
        }
      }
    }
    if (CHECKSUM) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float pc = 0.0f, pl = 0.0f;
#pragma unroll
        for (int jj = 0; jj < BC / 16; ++jj) {
          const int c = tx + 16 * jj;
          const float p = ps[(ty + 16 * i) * PS + c];
          pc = fmaf(p, vsum[c], pc);
          pl += p;
        }
        cs[i] = cs[i] * corr[i] + hw_sum(pc);
        l2[i] = l2[i] * corr[i] + hw_sum(pl);
      }
    }
    if (c1 == prm.inj_key_end) inject();
    c0 = c1;
  }
  inject();                      // an inject past the last key seen

  // epilogue
  T* o = static_cast<T*>(prm.o) + bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = r0 + ty + 16 * i;
    const float l_safe = l[i] != l[i] ? l[i] : fmaxf(l[i], 1e-30f);
    float osum = 0.0f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = acc[i][g][e] / l_safe;
        osum += x;
        if (row < sq) store(&o[row * D + 64 * g + 4 * tx + e], x);
      }
    if (CHECKSUM) {
      osum = hw_sum(osum);
      if (tx == 0 && row < sq) {
        const bool live = l2[i] > 0.0f;   // l itself may be the fault
        const float want = cs[i] / l_safe;
        const float r_pv =
            live ? fabsf(osum - want) / (fabsf(want) + 1.0f) : 0.0f;
        const float r_l = !live ? 0.0f
            : l[i] > 0.0f ? fabsf(l2[i] / l_safe - 1.0f)
                          : __int_as_float(0x7f800000);   // +inf
        float* rr = prm.rows + (static_cast<long long>(bh) * sq + row) * 2;
        rr[0] = r_pv;
        rr[1] = r_l;
      }
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BR) * (D + 4) + static_cast<size_t>(BC) * (D + 4) +
          static_cast<size_t>(BC) * D + static_cast<size_t>(BR) * PS + BC);
}

template <typename T, int D, bool CHECKSUM>
int launch(const Params& prm, int bh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_kernel<T, D, CHECKSUM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(
      static_cast<long long>((prm.sq + BR - 1) / BR) * bh));
  kern<<<grid, THREADS, smem, stream>>>(prm);
  return 0;
}

template <typename T, bool CHECKSUM>
int launch_d(const Params& prm, int bh, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64, CHECKSUM>(prm, bh, stream);
    case 128: return launch<T, 128, CHECKSUM>(prm, bh, stream);
    case 256: return launch<T, 256, CHECKSUM>(prm, bh, stream);
    default: return -3;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Device pointers of contiguous
// row-major tensors: q [bh, sq, d], k and v [bh, sk, d], o [bh, sq, d] in
// q's type (kind 0 fp32, 1 bf16); rows [bh, sq, 2] fp32 when `checksum`
// (else ignored).  `window` is read when `has_window`; softcap 0 is none.
// The inject (target 1 acc, 2 l; 0 none) adds `inj_delta` to row
// `inj_row` of bh 0 once keys [0, inj_key_end) are folded.  Launches on
// `stream` without synchronising.  Returns 0, a CUDA error code, or a
// negative code for arguments the kernel does not take (-1 sizes, -2 kind,
// -3 head dim).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* rows,
    int bh, int sq, int sk, int d, int kind, int checksum, float scale,
    int causal, int has_window, long long window, float softcap,
    int target, long long inj_row, long long inj_key_end, float inj_delta,
    void* stream) {
  // the flat grid: (bh, q tile) pairs up to grid.x's 2^31 - 1
  if (bh < 1 || sq < 1 || sk < 1 ||
      static_cast<long long>(bh) * ((sq + BR - 1) / BR) > 0x7fffffffLL)
    return -1;
  if (checksum && rows == nullptr) return -1;
  Params prm{q, k, v, o, static_cast<float*>(rows), sq, sk, scale, causal,
             has_window, window, softcap, target, inj_row, inj_key_end,
             inj_delta};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (kind == K_F32) {
    rc = checksum ? launch_d<float, true>(prm, bh, d, s)
                  : launch_d<float, false>(prm, bh, d, s);
  } else if (kind == K_BF16) {
    rc = checksum ? launch_d<Bf16, true>(prm, bh, d, s)
                  : launch_d<Bf16, false>(prm, bh, d, s);
  } else {
    return -2;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
