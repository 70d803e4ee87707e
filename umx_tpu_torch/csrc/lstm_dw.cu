// K6, the merged BLSTM layer's hidden-hidden weight gradient, in its Hopper
// form: a TMA-fed warpgroup-MMA GEMM that rounds its f32 operands to bf16
// on the chip.
//
// Replaces: umx_tpu/ops/lstm_pallas.py:_make_merged_bwd_kernel, the `flush`
// of the TPU backward kernel, which adds a block's (G, steps*B) x
// (steps*B, 4G) product of bf16 operands into an f32 accumulator per chain.
//
// Contract (as lstm_train.cu's K6, whose mma.sync kernel stays as the form
// "mma_sync"): hs (T, RB, G), h0 (RB, G), dxp (T, RB, 4G), all f32, rows
// chain-major (row = r*B + b); dW (R, G, 4G) f32 with
//   dW[r] = sum over t, b of bf16(h_{t-1}[r*B+b])^T bf16(dxp[t, r*B+b]),
// h_{-1} = h0, bf16 rounding to nearest even, f32 sums.  Needs G % 4 == 0
// (TMA takes strides of 16 bytes); at any other G it runs at a width padded
// with zero units (ops/lstm_cuda.py:dw_width: umx_lstm_dw_wgmma copies the
// operands, or the trainer hands them over padded), which leaves every real
// entry of dW the same products in the same order.
//
// What bounds it: at UMX-L training (T*B = 4096, R 8, G 512) 68.7 GFLOP of
// bf16 products (0.069 ms at the card's dense peak) over 335 MB of f32
// operands and 33.5 MB of dW (0.110 ms at 3.35 TB/s).  The mma.sync form
// read every 128-column slice of both operands through L2 once per tile
// (2.15 GB a launch) with register-staged loads, and ran at 0.58 ms.
//
// Design.  One block computes a 128 x BN tile of dW[r] (BN 256, or 128
// where that fills more of the card: ops/lstm_cuda.py:dw_plan) over the
// chain's whole contraction, k = (t, b), in stages of 32 pairs:
//  - Warp 0 issues the stage's copies with TMA (cp.async.bulk.tensor):
//    one 4-d box of hs (128 units x Bp rows x 1 chain x tb steps, the
//    steps t-1 of the stage's t), one of dxp (BN/2 columns, the block's
//    half of the tile's columns); at t = 0 a 3-d box of h0 in place of
//    hs's (a stage of one step) or into a region of its own.  Bp is B
//    rounded up to a power of two (32 above 32: then a stage is one step's
//    32-row chunk), tb = 32 / Bp; rows and steps outside the tensors come
//    in as zeros, so any T*B and any G % 4 == 0 take the same code.
//  - Blocks come in clusters of 2 with the same columns and neighbouring
//    128-unit tiles (the count of unit tiles padded to even): each block
//    brings one half of the dxp tile and multicasts it to both, so each
//    dxp byte leaves L2 once per 256 units of dW instead of once per 128.
//  - Three f32 stages in flight (48 KiB each at BN 256).  Two warpgroups
//    (warps 4-11) first round a landed stage to bf16 (cvt.rn.bf16x2.f32,
//    round to nearest even, as the plain version), 12 float4 a thread at
//    addresses fixed for the launch, all 12 loads in flight, into one of
//    three bf16 stages in the 128-byte swizzled, MN-major layout wgmma
//    reads (no transpose: both operands keep the contraction index as
//    their slow one); then each issues wgmma.mma_async.m64nBNk16 on its
//    64 units, both operands from shared memory, the 64 x BN f32 sums in
//    registers (128 a thread at BN 256).  The tensor cores run the
//    products of stages s - 1 and s while stage s + 1 is rounded: before
//    a barrier a warpgroup waits only for its products of stage s - 2,
//    whose bf16 stage the next rounding rewrites.
//  - An mbarrier a stage orders copy -> round; a named barrier orders
//    round -> product.  Each warp frees the f32 stage as soon as it has
//    read its part of it, in both blocks of its cluster (the next
//    multicast writes into both).  setmaxnreg moves warpgroup 0's
//    registers to the other two (40 and 232 of the launch's 168 a thread).
//  - Every DWH_PROMOTE stages the tensor cores' sums go into the tile in
//    dW (stored, then added in f32, round to nearest): the tensor cores'
//    own f32 sums drop low bits at every step, which over 8192 pairs (B
//    32) comes to 1e-5 of max|dW|.
//  - Where the tiles leave the card nearly empty (ops/lstm_cuda.py:dw_plan:
//    R x unit-tile pairs x column tiles well below the clusters it holds,
//    e.g. 8 clusters at G 24, R 8), the contraction is split into S slices
//    of consecutive stages, one cluster each: slice z sums its stages as
//    above into its own partial tile, and a second kernel adds the S
//    partial tiles in slice order.
// Every output has one owner and one order of summation over k (the stages
// in order, the wgmma's within a stage, the chunks of DWH_PROMOTE stages in
// order, the slices in order): no atomics, the same bits from run to run.  Shared
// memory holds 225 KiB at BN 256 (one block an SM); per stage of 32 pairs
// it moves 48 KiB in by TMA, 48 out and 24 in by the rounding and 40 out
// to the tensor cores, and L2 sends the block 32 KiB.  On an H100 80GB HBM3
// at 700 W that is 0.25 ms at UMX-L, ~1370 clocks a stage against the 1250
// that 160 KiB take at shared memory's 128 bytes a clock, where the
// products alone (with the copies and barriers) take 0.20 ms.  Variants
// and the phases of a stage: chip_forms.py k6_forms.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int DWH_BM = 128;          // dW rows (hidden units) a block
constexpr int DWH_BK = 32;           // (t, b) pairs a stage
constexpr int DWH_STAGES = 3;        // f32 stages (TMA)
constexpr int DWH_BSTAGES = 3;       // bf16 stages (rounded, read by wgmma)
constexpr int DWH_CLUSTER = 2;       // blocks a cluster: two unit tiles, one dxp tile
constexpr int DWH_MMA_WARPS = 8;     // warpgroups 1 and 2: rounding, then products
constexpr int DWH_THREADS = 32 * DWH_MMA_WARPS + 128;  // warp 0 of warpgroup 0: the copies
constexpr int CONVERT_BATCH = 12;    // loads in flight a rounding thread
// stages whose products the tensor cores sum in their registers before the
// sums go into dW (f32, round to nearest): the tensor cores' own f32 sums
// drop low bits at each step, and over a whole chain (256 stages at B 32)
// that drift reaches 1e-5 of max|dW|
constexpr int DWH_PROMOTE = 128;
constexpr int DWH_PROMOTE_BATCH = 16;  // float2 loads in flight a thread when the sums go in
constexpr unsigned DWH_POLLS_UNTIMED = 1u << 12;    // polls before a wait reads the clock
constexpr long long DWH_MAX_WAIT_CLOCKS = 8000000000LL;  // then ~4 s of waiting traps

// Shared memory of the form at BN columns a block (offsets from a
// 1024-byte aligned base: the swizzle atoms of the bf16 stages).
template <int BN>
struct DwhLayout {
  static constexpr int A32 = DWH_BK * DWH_BM * 4;  // f32 h rows of a stage
  static constexpr int B32 = DWH_BK * BN * 4;      // f32 dxp rows (two halves of BN/2)
  static constexpr int STAGE32 = A32 + B32;
  static constexpr int A16 = DWH_BK * DWH_BM * 2;  // bf16, two 64-unit blocks
  static constexpr int B16 = DWH_BK * BN * 2;      // bf16, BN/64 blocks of 64 columns
  static constexpr int STAGE16 = A16 + B16;
  static constexpr int H0 = 16 * DWH_BM * 4;       // h0's rows (Bp <= 16 where tb > 1)
  static constexpr int OFF16 = DWH_STAGES * STAGE32;
  static constexpr int OFFH0 = OFF16 + DWH_BSTAGES * STAGE16;
  static constexpr int OFFBAR = OFFH0 + H0;
  static constexpr int BARS = 2 * DWH_STAGES;
  static constexpr int BYTES = OFFBAR + BARS * 8 + 1024;  // + the alignment slack
};

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// arrive on the barrier at the same offset in block `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, unsigned cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed; a
// wait of seconds traps instead of hanging the card (the clock is read only
// once a wait has polled for a while)
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  unsigned done = 0;
  long long start = 0;
  for (unsigned polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls >= DWH_POLLS_UNTIMED && (polls & 1023) == 0) {
      const long long now = clock64();
      if (polls == DWH_POLLS_UNTIMED) {
        start = now;
      } else if (now - start > DWH_MAX_WAIT_CLOCKS) {
        __trap();
      }
    }
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the box lands at `dst` in every block of the cluster named in `mask`, and
// completes bytes on the barrier at `bar` in each of them
__device__ __forceinline__ void tma_load_4d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, uint16_t mask, int c0,
                                                      int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma's shared-memory matrix descriptor: 128-byte swizzle, start address,
// leading byte offset (MN-major: the next 64 elements of M or N) and
// stride byte offset (the next 8 rows of K), both in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

#define D8(b)                                                                              \
  "+f"(d[(b) + 0]), "+f"(d[(b) + 1]), "+f"(d[(b) + 2]), "+f"(d[(b) + 3]), "+f"(d[(b) + 4]), \
      "+f"(d[(b) + 5]), "+f"(d[(b) + 6]), "+f"(d[(b) + 7])

// D (64 x 128, f32, in registers) += A (64 x 16) . B (16 x 128), bf16, both
// read from shared memory MN-major (imm-trans-a = imm-trans-b = 1).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 256) += A (64 x 16) . B (16 x 256), as wgmma_n128.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72), D8(80),
        D8(88), D8(96), D8(104), D8(112), D8(120)
      : "l"(da), "l"(db), "r"(1));
}

#undef D8

template <int N>
__device__ __forceinline__ void wgmma_bn(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 256) {
    wgmma_n256(d, da, db);
  } else {
    wgmma_n128(d, da, db);
  }
}

// keeps the compiler from moving reads or writes of the sums across the
// asynchronous products
template <int NR>
__device__ __forceinline__ void fence_sums(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float4 lds_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts_u2(uint32_t addr, uint2 v) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x), "r"(v.y) : "memory");
}

__device__ __forceinline__ uint2 round4_bf16(float4 v) {
  uint2 out;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(out.x) : "f"(v.y), "f"(v.x));
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(out.y) : "f"(v.w), "f"(v.z));
  return out;
}

// Byte offset, in a bf16 stage block of 32 rows x 64 columns (128 bytes a
// row, the 16-byte chunks of row k XORed with k % 8: TMA's and wgmma's
// 128-byte swizzle), of columns [4 q4, 4 q4 + 4) of row k (q4 < 16).
__device__ __forceinline__ uint32_t swz(int k, int q4) {
  return (uint32_t)(k * 128 + ((((q4 >> 1) ^ (k & 7))) << 4) + ((q4 & 1) << 3));
}

// grid = 2 x m_pairs x n_tiles x R x slices blocks in clusters of 2;
// cluster c takes unit tiles 2 (c % m_pairs) + {0, 1}, column tile (c /
// m_pairs) % n_tiles, chain (c / (m_pairs n_tiles)) % R and slice z = c /
// (m_pairs n_tiles R): stages [z per_slice, min((z + 1) per_slice, stages)),
// its sums into dw + z R G 4G (ops/lstm_cuda.py:dw_tiles, dw_blocks).
template <int BN>
__global__ void __cluster_dims__(DWH_CLUSTER, 1, 1) __launch_bounds__(DWH_THREADS, 1)
    lstm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_hs,
                         const __grid_constant__ CUtensorMap map_h0,
                         const __grid_constant__ CUtensorMap map_dxp, float* __restrict__ dw,
                         int G, int R, int m_pairs, int n_tiles, int stages, int per_slice,
                         int bp, int tb, int nbc) {
  using L = DwhLayout<BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t base = raw + pad;
  const uint32_t full32 = base + L::OFFBAR;           // f32 stage landed (1 arrival + bytes)
  const uint32_t empty32 = full32 + 8 * DWH_STAGES;   // rounded, in both blocks

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  unsigned rank;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int cluster = blockIdx.x / DWH_CLUSTER;
  const int mp = cluster % m_pairs;
  const int nt = (cluster / m_pairs) % n_tiles;
  const int r = (cluster / (m_pairs * n_tiles)) % R;
  const int z = cluster / (m_pairs * n_tiles * R);
  const int m0 = (2 * mp + (int)rank) * DWH_BM;
  const int n0 = nt * BN;
  const int G4 = 4 * G;
  // this slice's stages: s0 + i for i < count (the loops below count i, so
  // that slots and phases start afresh in every slice)
  const int s0 = z * per_slice;
  const int count = min(per_slice, stages - s0);

  if (tid == 0) {
    for (int s = 0; s < DWH_STAGES; ++s) {
      mbar_init(full32 + 8 * s, 1);
      mbar_init(empty32 + 8 * s, DWH_MMA_WARPS * DWH_CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // both blocks' barriers exist before either copies or arrives into the other
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");

  if (warp < 4) {
    // ---- copies: one thread issues every stage's boxes; the registers of
    // warpgroup 0 go to the products' warpgroups (168 a thread at launch)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0 && lane == 0) {
      const unsigned bytes = (unsigned)(L::A32 + L::B32);
      for (int i = 0; i < count; ++i) {
        const int slot = i % DWH_STAGES;
        if (i >= DWH_STAGES) mbar_wait(empty32 + 8 * slot, (unsigned)((i / DWH_STAGES - 1) & 1));
        const int u0 = (s0 + i) * tb;
        const int t0 = u0 / nbc;
        const int b0 = (u0 % nbc) * DWH_BK;
        const uint32_t bar = full32 + 8 * slot;
        const uint32_t st = base + slot * L::STAGE32;
        if (t0 == 0 && tb == 1) {
          // a stage of one step at t = 0 (B above 16; one a box of 32 rows
          // above 32): h_{-1} = h0 fills the stage's h rows
          mbar_expect_tx(bar, bytes);
          tma_load_3d(st, &map_h0, bar, m0, b0, r);
        } else {
          // h_{t-1}: hs at steps t0 - 1 ...; at t0 = 0 (stage 0 alone, since
          // then one box holds all B rows) step -1 comes in as zeros and
          // h0's rows go to their own region
          mbar_expect_tx(bar, bytes + (t0 == 0 ? (unsigned)(bp * DWH_BM * 4) : 0u));
          tma_load_4d(st, &map_hs, bar, m0, b0, r, t0 - 1);
          if (t0 == 0) tma_load_3d(base + L::OFFH0, &map_h0, bar, m0, b0, r);
        }
        tma_load_4d_multicast(st + L::A32 + rank * (L::B32 / 2), &map_dxp, bar,
                              (uint16_t)((1u << DWH_CLUSTER) - 1), n0 + (int)rank * (BN / 2),
                              b0, r, t0);
      }
      // stay until both blocks have rounded every stage: no arrival from
      // the other block may reach this one after it exits
      for (int i = count > DWH_STAGES ? count - DWH_STAGES : 0; i < count; ++i)
        mbar_wait(empty32 + 8 * (i % DWH_STAGES), (unsigned)((i / DWH_STAGES) & 1));
    }
    return;
  }

  // ---- rounding and products: warpgroup w takes units [m0 + 64 w, m0 + 64 w + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int w = warp / 4 - 1;
  const int ct = tid - 128;
  // The rounding: a stage's f32 float4 i = ct + THREADS j (h's 32 rows of
  // 32, then dxp's two halves of 32 rows of HALF) is this thread's item j,
  // 4 values rounded into 8 bytes of a 64-column block of bf16 rows
  constexpr int HALF = BN / 8;                   // float4 a row of a dxp half
  constexpr int THREADS = 32 * DWH_MMA_WARPS;
  constexpr int H_ITEMS = 32 * 32 / THREADS;     // h items a thread: rows hk + 8 j
  constexpr int D_ROWS = THREADS / HALF;         // dxp rows a pass of THREADS items
  constexpr int D_PASSES = 32 / D_ROWS;          // passes a dxp half
  constexpr int PER = H_ITEMS + 2 * D_PASSES;    // items a thread and stage
  static_assert(32 % D_ROWS == 0 && D_ROWS % 8 == 0, "dxp rows a pass");
  const int hk = ct >> 5, hq = ct & 31;
  const uint32_t h_src = hk * 512 + hq * 16;
  const uint32_t h_dst = (hq >> 4) * (32 * 128) + swz(hk, hq & 15);
  const int dk = ct / HALF, dq = ct % HALF;
  const uint32_t d_src = L::A32 + dk * (BN / 2 * 4) + dq * 16;
  const uint32_t d_dst = L::A16 + (dq >> 4) * (32 * 128) + swz(dk, dq & 15);
  // d[4 j + e]: unit 16 (warp % 4) + lane / 4 (+ 8 for e >= 2), column
  // 8 j + 2 (lane % 4) (+ 1 for odd e)
  const int row = m0 + 64 * w + 16 * (warp & 3) + (lane >> 2);
  float* out = dw + (((size_t)z * R + r) * G + row) * G4 + n0 + 2 * (lane & 3);
  float d[BN / 2];
  // the sums of DWH_PROMOTE stages go into the tile's sums in dW, which
  // this thread alone owns: stored the first time, then added in f32
  // (round to nearest), DWH_PROMOTE_BATCH loads in flight
  auto promote = [&](bool first) {
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += DWH_PROMOTE_BATCH / 2) {
      float2 o[DWH_PROMOTE_BATCH];
#pragma unroll
      for (int u = 0; u < DWH_PROMOTE_BATCH; ++u) {
        const int j = j0 + u / 2, e = u & 1;
        o[u] = make_float2(0.0f, 0.0f);
        if (!first && n0 + 8 * j + 2 * (lane & 3) < G4 && row + 8 * e < G)
          o[u] = *reinterpret_cast<const float2*>(out + (size_t)(8 * e) * G4 + 8 * j);
      }
#pragma unroll
      for (int u = 0; u < DWH_PROMOTE_BATCH; ++u) {
        const int j = j0 + u / 2, e = u & 1;
        if (n0 + 8 * j + 2 * (lane & 3) < G4 && row + 8 * e < G) {
          float2 v = make_float2(d[4 * j + 2 * e], d[4 * j + 2 * e + 1]);
          if (!first) v = make_float2(o[u].x + v.x, o[u].y + v.y);
          *reinterpret_cast<float2*>(out + (size_t)(8 * e) * G4 + 8 * j) = v;
        }
      }
    }
  };
  for (int i = 0; i < count; ++i) {
    const int s = s0 + i;  // the stage: only stage 0 reads h0's own region
    if (i % DWH_PROMOTE == 0) {
#pragma unroll
      for (int v = 0; v < BN / 2; ++v) d[v] = 0.0f;
    }
    const int slot = i % DWH_STAGES;
    mbar_wait(full32 + 8 * slot, (unsigned)((i / DWH_STAGES) & 1));
    // round the f32 stage into bf16 stage s % 3, in the swizzled MN-major
    // layout (both warpgroups' products of stage s - 3, which read it, are
    // done: the barrier of the last stage)
    {
      // rows [0, bp) of stage 0 are h0's, in their own region where the
      // stage has more steps than one
      const uint32_t f32 = base + slot * L::STAGE32;
      const uint32_t h0_rows = s == 0 && tb > 1 ? base + L::OFFH0 : f32;
      const uint32_t b16 = base + L::OFF16 + (i % DWH_BSTAGES) * L::STAGE16;
      // item j of this thread: h row hk + 8 j (j < H_ITEMS), then dxp's
      // half jj / D_PASSES, row dk + D_ROWS (jj % D_PASSES); the offsets
      // past the thread's own are constants
      auto src_of = [&](int j) -> uint32_t {
        if (j < H_ITEMS) return (hk + 8 * j < bp ? h0_rows : f32) + h_src + j * 8 * 512;
        const int jj = j - H_ITEMS;
        return f32 + d_src + (jj / D_PASSES) * (32 * BN / 2 * 4) +
               (jj % D_PASSES) * D_ROWS * (BN / 2 * 4);
      };
      auto dst_of = [&](int j) -> uint32_t {
        if (j < H_ITEMS) return b16 + h_dst + j * 8 * 128;
        const int jj = j - H_ITEMS;
        return b16 + d_dst + (jj / D_PASSES) * (BN / 128) * (32 * 128) +
               (jj % D_PASSES) * D_ROWS * 128;
      };
#pragma unroll
      for (int j0 = 0; j0 < PER; j0 += CONVERT_BATCH) {
        float4 v[CONVERT_BATCH];
#pragma unroll
        for (int u = 0; u < CONVERT_BATCH; ++u)
          if (j0 + u < PER) v[u] = lds_f4(src_of(j0 + u));
#pragma unroll
        for (int u = 0; u < CONVERT_BATCH; ++u)
          if (j0 + u < PER) sts_u2(dst_of(j0 + u), round4_bf16(v[u]));
      }
    }
    // this warp has read its part of the f32 stage: one arrival a warp in
    // each block frees it for the next copies into both
    __syncwarp();
    if (lane == 0)
      for (unsigned c = 0; c < DWH_CLUSTER; ++c) mbar_arrive_cluster(empty32 + 8 * slot, c);
    // this warpgroup's products of stage s - 2 are done (those of s - 1 may
    // still run); after the barrier both warpgroups' are, so stage s + 1
    // may round into the bf16 stage they read.  The rounded values reach
    // wgmma's (async) proxy, and both warpgroups have the whole stage s.
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_sums(d);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(1, THREADS);
    const uint32_t a16 = base + L::OFF16 + (i % DWH_BSTAGES) * L::STAGE16 + w * (32 * 128);
    const uint32_t b16 = base + L::OFF16 + (i % DWH_BSTAGES) * L::STAGE16 + L::A16;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < DWH_BK / 16; ++kk)
      wgmma_bn<BN>(d, wgmma_desc(a16 + kk * 2048, 32 * 128, 1024),
                   wgmma_desc(b16 + kk * 2048, 32 * 128, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if ((i + 1) % DWH_PROMOTE == 0 || i + 1 == count) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_sums(d);
      promote(i < DWH_PROMOTE);
    }
  }
}

// dw[e] = parts[0][e] + parts[1][e] + ... + parts[slices - 1][e], f32, in
// slice order (n4 float4 of dW a slice, 16-byte aligned)
__global__ void __launch_bounds__(256) lstm_dw_sum_slices_kernel(const float4* __restrict__ parts,
                                                                 float4* __restrict__ dw, int n4,
                                                                 int slices) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n4; e += gridDim.x * blockDim.x) {
    float4 acc = parts[e];
    for (int z = 1; z < slices; ++z) {
      const float4 v = parts[(size_t)z * n4 + e];
      acc = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z, acc.w + v.w);
    }
    dw[e] = acc;
  }
}

// As lstm_dw_sum_slices_kernel where the kernel ran at a padded width Gp >
// G: dw (R, G, 4G) takes the real units' rows and gate columns of the
// slices' sums (R, Gp, 4Gp), in slice order
__global__ void __launch_bounds__(256) lstm_dw_sum_cut_kernel(const float* __restrict__ parts,
                                                              float* __restrict__ dw, int R,
                                                              int G, int Gp, int slices) {
  const int n = R * G * 4 * G;
  const size_t part = (size_t)R * Gp * 4 * Gp;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    const int col = e % (4 * G), ru = e / (4 * G);
    const int r = ru / G, u = ru % G, g = col / G, c = col % G;
    const size_t src = ((size_t)r * Gp + u) * 4 * Gp + g * Gp + c;
    float acc = parts[src];
    for (int z = 1; z < slices; ++z) acc += parts[z * part + src];
    dw[e] = acc;
  }
}

// Zero-unit copies at width Gp of hs (T RB, G), h0 (RB, G) and dxp (T RB, 4
// G: each gate block padded): rows of h at Gp, rows of dxp at 4 Gp
__global__ void __launch_bounds__(256) lstm_dw_pad_kernel(const float* __restrict__ hs,
                                                          const float* __restrict__ h0,
                                                          const float* __restrict__ dxp,
                                                          float* __restrict__ hs_p,
                                                          float* __restrict__ h0_p,
                                                          float* __restrict__ dxp_p, int rows_t,
                                                          int RB, int G, int Gp) {
  const long long nh = (long long)(rows_t + RB) * Gp, nd = (long long)rows_t * 4 * Gp;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < nh + nd;
       e += (long long)gridDim.x * blockDim.x) {
    if (e < nh) {
      const long long row = e / Gp;
      const int u = (int)(e % Gp);
      const bool in_hs = row < rows_t;
      const float* src = in_hs ? hs + row * G : h0 + (row - rows_t) * G;
      (in_hs ? hs_p + row * Gp : h0_p + (row - rows_t) * Gp)[u] = u < G ? src[u] : 0.0f;
    } else {
      const long long f = e - nh, row = f / (4 * Gp);
      const int col = (int)(f % (4 * Gp)), g = col / Gp, u = col % Gp;
      dxp_p[f] = u < G ? dxp[row * 4 * G + g * G + u] : 0.0f;
    }
  }
}

using encode_fn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                               const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                               const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                               CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (the library links
// no libcuda); nullptr where it is missing
encode_fn tensor_map_encoder() {
  static encode_fn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (encode_fn)p;
  }
  return fn;
}

// A tiled map of f32 `ptr` with `rank` dimensions (innermost first), their
// byte strides (dims 1..rank-1) and the box; elements outside read as zeros.
bool encode_f32(encode_fn enc, CUtensorMap* map, const float* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank, const_cast<float*>(ptr),
             dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel at BN columns a block with its shared memory allowed;
// cudaErrorInvalidValue for a BN the form has not.
cudaError_t dwh_setup(int bn, const void** fn, int* smem) {
  if (bn == 256) {
    *fn = (const void*)lstm_dw_wgmma_kernel<256>;
    *smem = DwhLayout<256>::BYTES;
  } else if (bn == 128) {
    *fn = (const void*)lstm_dw_wgmma_kernel<128>;
    *smem = DwhLayout<128>::BYTES;
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

}  // namespace

// K6's Hopper form at BN columns a block (128 or 256): how many of its
// clusters the current device holds at once, and the dynamic shared memory
// a block asks for.  Returns the first CUDA error.
extern "C" int umx_lstm_dw_capacity(int bn, int* clusters, int* smem) {
  const void* fn = nullptr;
  *clusters = 0;
  cudaError_t e = dwh_setup(bn, &fn, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DWH_CLUSTER);
  cfg.blockDim = dim3(DWH_THREADS);
  cfg.dynamicSmemBytes = (size_t)*smem;
  return (int)cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
}

// K6's Hopper form: dW (R, G, 4G) from hs, h0 and dxp, the kernel run at
// width Gp (G rounded up to a multiple of 4 or more, with zero units; Gp ==
// G where G % 4 == 0); one launch of the plan ops/lstm_cuda.py:dw_plan gives
// at Gp: BN columns a block, bp rows a step (B rounded up to a power of
// two, 32 above 32), tb steps a stage, nbc chunks of 32 rows a step (tb > 1
// only where nbc is 1), `stages` stages of 32 (t, b) pairs, in `slices`
// slices of `per_slice` stages (the last may be shorter).  With one slice
// at Gp == G the sums go into dw; otherwise slice z's into parts + z R Gp
// 4Gp (slices x R x Gp x 4Gp floats), and a second launch adds them into
// dw in slice order (and cuts the padding).  Where Gp > G, `padded` (T RB
// Gp + RB Gp + T RB 4Gp floats) first takes zero-unit copies of hs, h0 and
// dxp (one launch).  Pointers 16-byte aligned.  Returns the first CUDA
// error; cudaErrorNotSupported where tensor maps are missing.
extern "C" int umx_lstm_dw_wgmma(const float* hs, const float* h0, const float* dxp, float* dw,
                                 float* parts, float* padded, int T, int R, int B, int G, int Gp,
                                 int bn, int bp, int tb, int nbc, int stages, int slices,
                                 int per_slice, void* stream) {
  const bool cut = Gp != G;
  const long long rows_t = (long long)T * R * B;
  if (T < 1 || R < 1 || B < 1 || G < 1 || Gp < 4 || Gp % 4 != 0 || Gp < G || Gp - G >= 8 ||
      bp < 1 || bp > DWH_BK || (bp & (bp - 1)) != 0 || bp * tb != DWH_BK ||
      (tb > 1 && nbc != 1) || nbc * bp < B || (B <= DWH_BK && bp < B) ||
      (long long)stages * tb < (long long)T * nbc || slices < 1 || per_slice < 1 ||
      (long long)(slices - 1) * per_slice >= stages || (long long)slices * per_slice < stages ||
      ((slices > 1 || cut) && parts == nullptr) || (cut && padded == nullptr) ||
      rows_t * 4 * Gp > 2147483647LL || (long long)R * Gp * Gp > 2147483647LL ||
      (((uintptr_t)dw | (uintptr_t)parts | (uintptr_t)padded) & 15) != 0 ||
      (!cut && (((uintptr_t)hs | (uintptr_t)h0 | (uintptr_t)dxp) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  int smem = 0;
  cudaError_t e = dwh_setup(bn, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  const encode_fn enc = tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cut) {
    // the kernel reads zero-unit copies at width Gp
    float* hs_p = padded;
    float* h0_p = hs_p + rows_t * Gp;
    float* dxp_p = h0_p + (long long)R * B * Gp;
    const long long n = (rows_t + (long long)R * B) * Gp + rows_t * 4 * Gp;
    const int grid = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    lstm_dw_pad_kernel<<<grid, 256, 0, st>>>(hs, h0, dxp, hs_p, h0_p, dxp_p, (int)rows_t, R * B,
                                             G, Gp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    hs = hs_p;
    h0 = h0_p;
    dxp = dxp_p;
  }
  const cuuint64_t g = (cuuint64_t)Gp, b = (cuuint64_t)B, rr = (cuuint64_t)R;
  CUtensorMap map_hs, map_h0, map_dxp;
  // hs's steps 0 .. T-2 are some step's h_{t-1}; step T-1 is never read
  const cuuint64_t hs_dims[4] = {g, b, rr, (cuuint64_t)(T > 1 ? T - 1 : 1)};
  const cuuint64_t hs_strides[3] = {4 * g, 4 * g * b, 4 * g * b * rr};
  const cuuint32_t hs_box[4] = {DWH_BM, (cuuint32_t)bp, 1, (cuuint32_t)tb};
  const cuuint64_t dx_dims[4] = {4 * g, b, rr, (cuuint64_t)T};
  const cuuint64_t dx_strides[3] = {16 * g, 16 * g * b, 16 * g * b * rr};
  const cuuint32_t dx_box[4] = {(cuuint32_t)(bn / 2), (cuuint32_t)bp, 1, (cuuint32_t)tb};
  if (!encode_f32(enc, &map_hs, hs, 4, hs_dims, hs_strides, hs_box) ||
      !encode_f32(enc, &map_h0, h0, 3, hs_dims, hs_strides, hs_box) ||
      !encode_f32(enc, &map_dxp, dxp, 4, dx_dims, dx_strides, dx_box))
    return (int)cudaErrorInvalidValue;
  int m_pairs = ((Gp + DWH_BM - 1) / DWH_BM + 1) / 2;
  int n_tiles = (4 * Gp + bn - 1) / bn;
  const long long blocks = (long long)DWH_CLUSTER * m_pairs * n_tiles * R * slices;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  float* sums = slices > 1 || cut ? parts : dw;
  void* args[] = {&map_hs, &map_h0,  &map_dxp,   &sums, &Gp, &R,  &m_pairs,
                  &n_tiles, &stages, &per_slice, &bp,   &tb,  &nbc};
  e = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(DWH_THREADS), args, (size_t)smem, st);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess || sums == dw) return (int)e;
  if (cut) {
    const int n = R * G * 4 * G;
    const int grid = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
    lstm_dw_sum_cut_kernel<<<grid, 256, 0, st>>>(parts, dw, R, G, Gp, slices);
  } else {
    const int n4 = R * G * G;  // float4 of dW: R G 4G / 4
    const int grid = (n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024;
    lstm_dw_sum_slices_kernel<<<grid, 256, 0, st>>>(reinterpret_cast<const float4*>(parts),
                                                    reinterpret_cast<float4*>(dw), n4, slices);
  }
  return (int)cudaGetLastError();
}
