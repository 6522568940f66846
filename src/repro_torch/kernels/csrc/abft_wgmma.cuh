// Kernel #2's fp32 tensor-core mainloop for Hopper (sm_90a): a TMA ring
// feeding warpgroup wgmma over 3xTF32 operand planes.
//
// The operands arrive split: A_hi, A_lo [P, m, ldk] and B_hi, B_lo [Q, n,
// ldk] (B transposed), each element already rounded to TF32 as
// abft_mma.cuh's split_tf32 rounds it (tf32_split.cu writes them once per
// SUMMA panel), so both operands lie K-major as tf32 wgmma reads them and
// the mainloop does no arithmetic on their way to the tensor core.  The
// TMA maps span the whole batch, so a panel's maps are encoded once and a
// launch names its pair of blocks (a, b) by their batch coordinates.
//
// The ring: STAGES slots in dynamic shared memory, each holding 32 k (one
// 128-byte row of fp32) of the four planes, A_hi, A_lo (BM rows each) and
// B_hi, B_lo (BN rows each), loaded by four TMA boxes with the 128-byte
// swizzle that the wgmma descriptors name.  TMA zero-fills past m, n and
// k, which is the ragged tiles' zero padding.  One thread issues the loads
// (no producer warp: kernel #2's prologue and abft_tile.cuh's epilogue
// synchronise the whole CTA), a slot's `full` barrier counting its bytes
// and its `empty` barrier one arrival from each of the 8 warps once their
// products of it are done; the slot is refilled with the stage STAGES on.
//
// The products: two warpgroups of four warps, each owning BM / 2 = 64 rows
// of the tile, run per 8-deep k step the three terms wgmma.m64nBNk8 lo.hi,
// hi.lo, hi.hi (small ones first) into a partial summed from zero over 64
// k, two stages (scale-d 0 on the first product), and the running sum
// takes the partial by one fp32 add: a late SUMMA step carries a C_in far
// larger than a partial, and the tensor core's own accumulation may
// truncate.  That is abft_mma.cuh's fp32 arithmetic term for term: on an
// H100 the two give the same product bit for bit (a partial of 32 k, one
// stage, gave a 5 % smaller RMS error but a 20-30 % larger largest one,
// and a partial of 128 k a 60 % larger RMS error).  While one warpgroup
// adds its partial the other's products keep the tensor cores busy.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "abft_tile.cuh"

namespace abft_wgmma {

using abft::THREADS;

constexpr int BK = 32;          // k a stage: one 128-byte row of fp32
constexpr int ROW = BK * 4;     // bytes of a plane's row in a stage
constexpr int STAGES = 3;       // slots of the ring
constexpr int SPAN = 2;         // stages a partial spans: 64 k, as
                                // abft_mma.cuh's fp32 ring stage

template <int BM, int BN>
struct Cfg {
  static_assert(BM == 128 && (BN == 128 || BN == 64), "two 64-row warpgroups");
  static constexpr int M = BM, N = BN;               // the tile
  static constexpr int A_PLANE = BM * ROW;           // one A plane a stage
  static constexpr int B_PLANE = BN * ROW;
  static constexpr int A_HI = 0, A_LO = A_PLANE;     // offsets in a slot,
  static constexpr int B_HI = 2 * A_PLANE;           // each 1024-aligned
  static constexpr int B_LO = 2 * A_PLANE + B_PLANE;
  static constexpr int STAGE = 2 * A_PLANE + 2 * B_PLANE;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int NACC = BN / 2;                // accumulator floats
  static constexpr int CS_ROW = BN + 4;              // staged C, words
  static constexpr int STAGED = BM * CS_ROW * 4;
  static constexpr int HALF = (BM / 2) * CS_ROW * 4; // one warpgroup's rows
  static constexpr int EPI = abft::Smem<float, BM, BN>::EPI;
  // dynamic bytes, with room to align the ring to the swizzle's 1024
  static constexpr int SMEM = (RING > STAGED ? RING : STAGED) + 1024;
  // the prologue runs in the slot left free while the first ones fly
  static_assert(STAGE >= HALF && STAGE >= EPI, "prologue slot");
};

// ---- shared-memory addresses, barriers, TMA --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Order this thread's generic-proxy accesses of shared memory before later
// async-proxy ones (TMA writing bytes the prologue used).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The box at (inner coordinate c0, row c1, block c2) of a 3-D tensor map
// into `dst`, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(
                   map))
               : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Descriptor of a K-major operand tile in shared memory under the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// byte offset), the tile 1024-aligned; an 8-deep k step further into the
// row is 32 bytes on the start address (2 in its 16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3ffff) >> 4)
         | (static_cast<uint64_t>(1) << 16)           // leading offset, unused
         | (static_cast<uint64_t>(1024 >> 4) << 32)   // stride byte offset
         | (static_cast<uint64_t>(1) << 62);          // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the registers at this point of the program: the compiler may not move
// their reads or writes across it (the tensor core writes them
// asynchronously between an issue and its wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B for a 64 x N x 8 TF32 step, A and B from shared memory;
// scale_d 0 ignores d's old value.
__device__ __forceinline__ void wgmma_k8(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_k8(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the accumulator layout -------------------------------------------------

// Tile row and column of accumulator float e of this thread: warpgroup wg
// owns rows 64 wg .. 64 wg + 63, its warp w rows 16 w + g and 16 w + g + 8
// (g = lane / 4), float 4 j + h of n-block j at column 8 j + 2 (lane % 4)
// + h % 2, the second row for h >= 2 (PTX ISA, "wgmma .m64nNk8 D").
__device__ __forceinline__ int acc_row(int e) {
  const int tid = threadIdx.x, lane = tid % 32;
  return 64 * (tid / 128) + 16 * ((tid / 32) % 4) + lane / 4
         + 8 * ((e % 4) / 2);
}
__device__ __forceinline__ int acc_col(int e) {
  return 8 * (e / 4) + 2 * (threadIdx.x % 4) + e % 2;
}

// The tile held in the (ty + 16 i, tx + 16 j) layout of abft_tile.cuh into
// the accumulators, through `smem` (at least Cfg::HALF bytes), one
// warpgroup's 64 rows at a time; the bytes are then free for TMA to fill.
template <class C>
__device__ __forceinline__ void tile_to_acc(
    const float (&v)[C::M / 16][C::N / 16], float (&acc)[C::NACC],
    unsigned char* smem) {
  float* cs = reinterpret_cast<float*>(smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < C::M / 32; ++i)
#pragma unroll
      for (int j = 0; j < C::N / 16; ++j)
        cs[(ty + 16 * i) * C::CS_ROW + tx + 16 * j] = v[h * C::M / 32 + i][j];
    __syncthreads();
    if (static_cast<int>(threadIdx.x) / 128 == h) {
#pragma unroll
      for (int e = 0; e < C::NACC; ++e)
        acc[e] = cs[(acc_row(e) - 64 * h) * C::CS_ROW + acc_col(e)];
    }
    fence_proxy_async();
    __syncthreads();
  }
}

// The inverse, all rows at once through `smem` (Cfg::STAGED bytes).
template <class C>
__device__ __forceinline__ void acc_to_tile(const float (&acc)[C::NACC],
                                            float (&v)[C::M / 16][C::N / 16],
                                            unsigned char* smem) {
  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int e = 0; e < C::NACC; ++e)
    cs[acc_row(e) * C::CS_ROW + acc_col(e)] = acc[e];
  __syncthreads();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < C::M / 16; ++i)
#pragma unroll
    for (int j = 0; j < C::N / 16; ++j)
      v[i][j] = cs[(ty + 16 * i) * C::CS_ROW + tx + 16 * j];
  __syncthreads();     // the bytes are free again
}

// ---- the ring ---------------------------------------------------------------

// The four planes' maps, A_hi, A_lo, B_hi, B_lo (3-D, boxes of BK k by BM
// or BN rows of one block), as kernel parameters.
struct Maps {
  CUtensorMap a_hi, a_lo, b_hi, b_lo;
};

// Where a tile reads: its first rows in A's and B's planes and the blocks
// (batch coordinates) they lie in.
struct Origin {
  int m0, n0, a, b;
};

// The ring's barriers: a slot's bytes landed, a slot's products done.
struct Bars {
  uint64_t full[STAGES], empty[STAGES];
};

// Run by one thread: stage kt of the tile at `o` into its slot.
template <class C>
__device__ __forceinline__ void load_stage(const Maps& mp, int kt,
                                           const Origin& o,
                                           unsigned char* ring, Bars& bar) {
  const int s = kt % STAGES;
  unsigned char* st = ring + s * C::STAGE;
  mbar_expect_tx(&bar.full[s], C::STAGE);
  tma_load(st + C::A_HI, &mp.a_hi, &bar.full[s], kt * BK, o.m0, o.a);
  tma_load(st + C::A_LO, &mp.a_lo, &bar.full[s], kt * BK, o.m0, o.a);
  tma_load(st + C::B_HI, &mp.b_hi, &bar.full[s], kt * BK, o.n0, o.b);
  tma_load(st + C::B_LO, &mp.b_lo, &bar.full[s], kt * BK, o.n0, o.b);
}

// Set up the ring's barriers and issue its first STAGES - 1 stages; the
// last slot's bytes are the caller's (`free_slot`) until `mainloop`.
// Every thread of the CTA calls it.
template <class C>
__device__ __forceinline__ void ring_start(const Maps& mp, int k,
                                           const Origin& o,
                                           unsigned char* ring, Bars& bar) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.empty[s], THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    tma_prefetch(&mp.a_hi);
    tma_prefetch(&mp.a_lo);
    tma_prefetch(&mp.b_hi);
    tma_prefetch(&mp.b_lo);
  }
  __syncthreads();
  const int kt_n = (k + BK - 1) / BK;
  if (threadIdx.x == 0)
    for (int kt = 0; kt < STAGES - 1 && kt < kt_n; ++kt)
      load_stage<C>(mp, kt, o, ring, bar);
}

template <class C>
__device__ __forceinline__ unsigned char* free_slot(unsigned char* ring) {
  return ring + (STAGES - 1) * C::STAGE;
}

// acc += A[m0:+BM, :] @ B[:, n0:+BN] of blocks (a, b) over the planes,
// after `ring_start` and the caller's use of the free slot; the ring's bytes
// are free again when it returns.  Stage kt: wait for its slot, its
// products into the partial (from zero on a span's first stage), the
// partial into the running sum on a span's last, the slot released and
// (one thread) refilled with stage kt + STAGES once all 8 warps have
// released it.
template <class C>
__device__ __forceinline__ void mainloop(const Maps& mp, int k,
                                         const Origin& o,
                                         float (&acc)[C::NACC],
                                         unsigned char* ring, Bars& bar) {
  const int kt_n = (k + BK - 1) / BK;
  if (threadIdx.x == 0 && STAGES - 1 < kt_n)
    load_stage<C>(mp, STAGES - 1, o, ring, bar);
  const int wrow = (threadIdx.x / 128) * (C::M / 2) * ROW;  // warpgroup's rows
  float part[C::NACC];
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % STAGES;
    const unsigned parity = (kt / STAGES) & 1;
    mbar_wait(&bar.full[s], parity);
    const unsigned char* st = ring + s * C::STAGE;
    const uint64_t ah = desc_sw128(st + C::A_HI + wrow);
    const uint64_t al = desc_sw128(st + C::A_LO + wrow);
    const uint64_t bh = desc_sw128(st + C::B_HI);
    const uint64_t bl = desc_sw128(st + C::B_LO);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      wgmma_k8(part, al + 2 * ks, bh + 2 * ks, ks > 0 || kt % SPAN != 0);
      wgmma_k8(part, ah + 2 * ks, bl + 2 * ks, 1);
      wgmma_k8(part, ah + 2 * ks, bh + 2 * ks, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    if (kt % SPAN == SPAN - 1 || kt == kt_n - 1) {
#pragma unroll
      for (int e = 0; e < C::NACC; ++e) acc[e] += part[e];
    }
    if (threadIdx.x % 32 == 0) mbar_arrive(&bar.empty[s]);
    if (threadIdx.x == 0 && kt + STAGES < kt_n) {
      mbar_wait(&bar.empty[s], parity);
      load_stage<C>(mp, kt + STAGES, o, ring, bar);
    }
    __syncwarp();
  }
  __syncthreads();     // every warp is done with the ring
}

}  // namespace abft_wgmma
