// Backward of the merged BLSTM layer: the reverse-time sweep (K5) and the
// hidden-hidden weight gradient (K6).
//
// Replaces: umx_tpu/ops/lstm_pallas.py:_make_merged_bwd_kernel, the TPU
// kernel of the custom VJP's backward, which walks the time blocks in
// reverse carrying (dh, dc) in VMEM scratch and accumulates dW_hh once per
// block (its `flush`) into a VMEM-resident f32 accumulator.
//
// Contract (same rows and layouts as lstm_merged.cu; rows chain-major,
// row = r*B + b).  From the residuals of the forward (K4): gates (T, RB, 4G)
// activated i|f|g|o, cs (T, RB, G), hs (T, RB, G), and h0, c0 (RB, G); the
// bf16 weight whh (R, G, 4G); the cotangents dhs (T, RB, G), dhT, dcT.
// Per step, t = T-1 ... 0, with cprev = cs[t-1] (c0 at t = 0):
//   dh  = dh_carry + dhs[t];  tc = tanh(cs[t])
//   dct = dc_carry + dh o (1 - tc^2)
//   dg  = [dct g i(1-i), dct cprev f(1-f), dct i (1-g^2), dh tc o(1-o)]
//   dxp[t] = dg (f32);  dc_carry = dct f;  dh_carry = bf16(dg) . whh[r]^T
// and dW[r] = sum over t, b of bf16(h_{t-1})^T bf16(dg_t), h_{-1} = h0, with
// f32 accumulation.  The dh/dc carries stay f32.  Outputs dxp (T, RB, 4G),
// dW (R, G, 4G), dh0, dc0 (RB, G), all f32.
//
// K5, the reverse sweep.  What bounds it: like the forward, its T steps
// depend on each other, and each needs all of W_hh (16.8 MB at UMX-L)
// against a few rows of dg, so a layer costs T times one step's latency and
// W_hh has to stay on chip.  The product is the forward's transposed: it
// contracts over the 4G gate columns and yields G units per chain and row,
// so the exchange between a chain's blocks carries 4G bf16 a row and step,
// four times the forward's.
// Design: ONE cooperative launch runs the whole sweep of all chains and up
// to 16 rows per chain.  A chain is split over ceil(G/32) blocks of 8
// warps; a block owns 32 hidden units.  Warp w holds, for the block's 32
// units (two mma m-tiles), the gate columns of its own 16 k-tiles of the
// contraction (columns [256 w, 256 w + 256) at G = 512) as
// mma.sync.m16n8k16 A-fragments in 128 registers a thread for the whole
// layer: whh is (R, G, 4G) with the gate column fastest, so a fragment
// register is one aligned 32-bit load, once.  The batch rows are the mma's
// n columns (two n-tiles for 9-16 rows), so a row's sum has one order at
// every B.  The eight warps' partial sums meet in shared memory and the
// thread that owns (unit, row) adds them in a fixed order with explicit
// roundings, then applies the cell: dc stays in its register for the whole
// layer.  Everything of the cell that does not depend on the carry
// (gates[t], cs[t], cprev, dhs[t]; tanh(c) and the five coefficient
// products) is loaded one step ahead (prefetched into L2 three steps ahead)
// and formed before the wait, so that after the carry arrives a cell is
// seven multiply-adds.
// The exchange of bf16(dg) goes through device memory (L2), like the
// forward's, but as plain data and one flag per block and step: a block
// stores its 32 units x 4 gates x rows (a warp writes 64 contiguous bytes
// per row and gate), synchronises, and one thread publishes the step's tag
// with a release store.  A consumer warp needs only the columns of its own
// k-tiles: its lanes poll the flags of the blocks that produce them (one
// 128-byte line per chain) with acquire loads, then the warp copies its
// 8 KB (16 rows x 512 bytes) from L2 to shared memory with cp.async.cg, 16
// pieces of 16 bytes a lane in flight, bypassing L1, and multiplies as soon
// as they are in: warps never wait for each other before the product.  (At
// up to 8 rows a step is short and eight polling warps a block slow the
// producers' stores down: there warp 0 polls for the block, 2.4 against
// 3.1 us a step at six rows; at 16 rows the warps' own waits win, 4.1
// against 4.5.)  The
// exchange buffer is double-buffered by step parity (a block writes step
// i + 1 only after every block of its chain has published step i, which
// each did after reading all of step i - 1).  A poll that lasts seconds
// traps instead of hanging the card.  After step 0 one more product gives
// dh0.  Rows beyond 16 and chains beyond what the card holds at once are
// further launches, planned by the wrapper; G above 512 is refused
// (cudaErrorInvalidConfiguration): there the block form below runs.
// Requires G % 8 == 0.
//
// K5's block form (the wide K5, G above 512).  What bounds it: a chain's
// bf16 W_hh is 8 G^2 bytes, 3.28 MB at G 640 (UMX-style chains of hidden
// 1280), 26.2 MB for R 8, against the card's 63.8 MB of registers and shared
// memory; read from L2 every step (the streaming sweep, lstm_scan_train.cu)
// it costs about 58 us a step.  The resident form's split (a block owns 32
// units against all 4G columns, the 4G columns of dg staged from the
// exchange) needs 20 blocks a chain at G 640, 160 for R 8, more than one
// wave; a block of 48 units would need 80 KiB of staged dg rows and 27 KiB
// of warp partials beside 240 KiB of W_hh, more than an SM holds at 16
// rows.  So this form splits the contraction instead (K11's "partial"
// exchange, in bf16 on the tensor cores): block b of a chain owns U units
// [bU, bU + U) and their 4U gate columns of the contraction, and W_hh^T of
// those columns for EVERY unit of the chain (G x 4U bf16, loaded once and
// kept on the chip: the first KREG of a warp's k-tiles as mma A-fragments
// in registers, the rest in shared memory, 16 bytes a thread and tile, in
// the order the thread holds them).  A step: the block's cells (its U units
// x the launch's rows, several a thread) form dg of its own 4U columns and
// write bf16(dg) into shared memory, where the block's own product reads
// it: dg never leaves the block.  The product's m dimension is the chain's
// units (warp w takes m-tiles w, w + 8, ...), its k dimension the block's
// local columns (local column l is gate l / U of unit bU + l % U), its n
// the rows: each warp sums its m-tiles over all KL local k-tiles in one
// accumulator each, ascending, and stores the f32 sums, G a row, to the
// exchange, a block's slice of it; then the block's flag is released, as
// the resident form releases its own.  A cell's carry is the sum of the
// nblk blocks' partials of its (unit, row), read from L2 (ld.global.cg)
// after warp 0 has seen every flag of the chain, added in block order: one
// order, set by the form, whatever B, the row group or the chains beside.
// The exchange is double-buffered by step parity, its tags and trap as the
// resident form's.  No warp partials meet in shared memory, and shared
// memory holds only W_hh's shared tiles and the block's own dg rows (5 KiB
// at 16 rows), so a launch takes 16 rows.  The forms (bww_kernel below,
// ops/lstm_cuda.py:BWD_BLOCK_FORMS; 8 warps, so a thread may have 255
// registers, not the 168 of a 10-warp block): 40 units a block and 5
// m-tiles a warp up to G 640 (16 blocks a chain: R 8 in one wave of 128
// blocks; 24 of a warp's 50 tiles in registers), 32 units and 8 m-tiles up
// to G 1024 (two chain groups for R 8); wider chains stream.
//
// K6, the weight gradient, in its earlier form "mma_sync": the wrapper runs
// it where TMA cannot take the operands' strides (G % 4 != 0) and by name
// as the yardstick of the Hopper form in lstm_dw.cu, which runs everywhere
// else.  What bounds it: 2 * R*G*4G*T*B flops (69 GFLOP
// per layer at UMX-L training, T*B = 4096) on bf16-rounded operands, which
// the tensor cores take exactly, over 335 MB of f32 operands that the
// sweep left in device memory: at the card's peaks 0.07 ms of products and
// 0.11 ms of bytes, so the design has to keep both busy.  The TPU runs
// this product on its matrix unit inside the backward kernel; here it is
// one tensor-core GEMM per chain after the sweep.  Both operands are
// stored with the contraction index n = (t, b) as the slow one (hs is
// (n, m), dxp is (n, c)), which is the transposed form for mma.sync:
// a block stages 32 (t, b) pairs of a 128 x 128 tile of dW[r] at a time,
// 16-byte f32 loads rounded with __float22bfloat162_rn on their way into
// shared memory (rows padded to 272 bytes), and ldmatrix.trans hands the
// fragments to mma.sync.m16n8k16 with f32 accumulators, 8 warps of 64 x 32
// each.  The next stage's global loads are in flight in registers while
// this stage is multiplied, and two blocks share an SM, so one block's
// loads overlap the other's products.  h_{t-1} of step 0 is h0.  Each
// output has one owner and a fixed order of summation over n: no split, no
// atomics, bit-stable from run to run.  Ragged G, 4G and T*B are masked
// with zeros on the way in and on the store.
//
// K5 measured on an H100 80GB HBM3 at 700 W at the UMX-L training shape
// (T = 256, R = 8, B = 16, G = 512): 1.06 to 1.19 ms per layer over five
// runs, 4.1 to 4.6 us per step (2.2 us at one row per chain, 2.4 at six);
// 196 / 236 registers for one / two n-tiles, no spills.  A step at 16 rows,
// in cycles of one thread: wait for the flags 1540, copy 1200, product 560,
// partial sums 410, cell, exchange stores, barrier and release 1560, dxp
// and the next coefficients 430.  Its earlier form, one grid per step with W_hh re-read from L2 and
// the product on the CUDA cores, took 11.5 ms per layer, 45 us per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BW_WARPS = 8;
constexpr int BW_THREADS = 32 * BW_WARPS;
constexpr int BW_UNITS = 32;              // hidden units owned by one block (two m-tiles)
constexpr int BW_KT = 16;                 // k-tiles of 16 gate columns a warp holds
constexpr int BW_G_MAX = BW_WARPS * BW_KT * 16 / 4;  // 512
constexpr int BW_ROWS = 16;               // rows per chain in one launch
constexpr int BW_DPAD = 4;                // words of padding per staged dg row (bank spread)
constexpr int BW_PSTRIDE = BW_UNITS + 4;  // floats per row of a warp's partial sums
constexpr int BW_FLAGS = 32;              // flag words per chain: one 128-byte line
constexpr unsigned BW_MAX_POLLS = 1u << 24;

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" : : "l"(p));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" : : "l"(p), "r"(v) : "memory");
}

// 16 bytes from device memory (through L2, not L1) into shared memory
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" : : "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" : : : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Dynamic shared memory of one K5 block: the warps' partial sums and the
// staged bf16(dg) rows of NT n-tiles.
__host__ __device__ constexpr size_t bwd_smem_bytes(int nt, int G) {
  return (size_t)(BW_WARPS * BW_ROWS * BW_PSTRIDE + nt * 8 * (2 * G + BW_DPAD)) * 4;
}

// What the cell needs beside the carry, for one (unit, row) and one step.
struct BwdCoef {
  float dhs, a, i, f, g, o, fg;
};

// grid = (ceil(G/32), chains of this launch).  NT n-tiles of 8 rows.
// dgx: exchange (R, 2, BW_ROWS, 4G) bf16; flags (R, BW_FLAGS) words, zeroed
// by the caller before the layer's first launch; tag0 makes the tags of
// this launch unique among the launches that share the buffers.
template <int NT>
__global__ void __launch_bounds__(BW_THREADS, 1)
lstm_bwd_resident_kernel(const float* __restrict__ gates,        // (T, RB, 4G)
                         const float* __restrict__ cs,           // (T, RB, G)
                         const float* __restrict__ c0,           // (RB, G)
                         const __nv_bfloat16* __restrict__ whh,  // (R, G, 4G)
                         const float* __restrict__ dhs,          // (T, RB, G)
                         const float* __restrict__ dhT,          // (RB, G)
                         float* __restrict__ dc,                 // (RB, G), in place
                         float* __restrict__ dxp,                // (T, RB, 4G)
                         float* __restrict__ dh0,                // (RB, G)
                         __nv_bfloat16* dgx, unsigned* flags, int T, int R, int B, int b0,
                         int nb, int G, int r0, unsigned tag0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* part = reinterpret_cast<float*>(smem_raw);  // (warps, BW_ROWS, BW_PSTRIDE)
  uint32_t* dg_s =                                    // (NT * 8 rows, 2G + pad words)
      reinterpret_cast<uint32_t*>(smem_raw + BW_WARPS * BW_ROWS * BW_PSTRIDE * 4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group: tile rows g and g + 8, B/C column g
  const int tq = lane & 3;
  const int r = r0 + blockIdx.y;
  const int G4 = 4 * G;
  const int RB = R * B;
  const int SW = 2 * G + BW_DPAD;  // words per staged row; SW % 32 in {4, 20}
  const int u0 = blockIdx.x * BW_UNITS;

  // This warp's slice of the contraction: k-tiles [kt0, kt0 + ktn) of the
  // G/4 k-tiles of 16 gate columns, columns [col0, col1).
  const int ktw = (G / 4 + BW_WARPS - 1) / BW_WARPS;
  const int kt0 = warp * ktw;
  const int ktn = max(0, min(ktw, G / 4 - kt0));
  const int col0 = kt0 * 16;
  const int col1 = col0 + ktn * 16;

  // A-fragments: m = unit, k = gate column.  Register 0: (unit g, columns
  // 2tq, 2tq+1), 1: (unit g + 8, same), 2/3: the columns 8 higher.
  uint32_t wf[2][BW_KT][4];
  {
    const uint32_t* wr = reinterpret_cast<const uint32_t*>(whh + (size_t)r * G * G4);
    const int rw = G4 / 2;  // words per W_hh row
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int ua = u0 + mt * 16 + g;
      const int ub = ua + 8;
#pragma unroll
      for (int kt = 0; kt < BW_KT; ++kt) {
        wf[mt][kt][0] = wf[mt][kt][1] = wf[mt][kt][2] = wf[mt][kt][3] = 0u;
        if (kt < ktn) {
          const int w0 = col0 / 2 + kt * 8 + tq;
          if (ua < G) {
            wf[mt][kt][0] = __ldg(wr + (size_t)ua * rw + w0);
            wf[mt][kt][2] = __ldg(wr + (size_t)ua * rw + w0 + 4);
          }
          if (ub < G) {
            wf[mt][kt][1] = __ldg(wr + (size_t)ub * rw + w0);
            wf[mt][kt][3] = __ldg(wr + (size_t)ub * rw + w0 + 4);
          }
        }
      }
    }
  }

  // Lane l polls block l's flag where that block produces any of this
  // warp's columns (column q G + u comes from the block that owns unit u).
  bool polls = false;
  if (lane < (int)gridDim.x && ktn > 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lo = q * G + lane * BW_UNITS;
      const int hi = q * G + min(lane * BW_UNITS + BW_UNITS, G);
      polls = polls || (lo < col1 && hi > col0);
    }
  }

  // The cell: warp = row of the n-tile, lane = unit of the block.
  const int u = u0 + lane;
  bool valid[NT];
  size_t row[NT];
  float dcc[NT], cs_cur[NT];
  BwdCoef k[NT];
  float nx[NT][6];  // the next step's i, f, g, o, dhs, cprev
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    valid[j] = u < G && (j * 8 + warp) < nb;
    row[j] = (size_t)r * B + b0 + j * 8 + warp;
    dcc[j] = cs_cur[j] = 0.0f;
#pragma unroll
    for (int e = 0; e < 6; ++e) nx[j][e] = 0.0f;
  }

  const size_t x_step = (size_t)RB * G4;
  const size_t h_step = (size_t)RB * G;
  // i, f, g, o, dhs and cprev of step t for cell j, into nx
  auto load_step = [&](int j, int t) {
    const float* gp = gates + (size_t)t * x_step + row[j] * G4 + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) nx[j][q] = gp[(size_t)q * G];
    nx[j][4] = dhs[(size_t)t * h_step + row[j] * G + u];
    nx[j][5] = t > 0 ? cs[(size_t)(t - 1) * h_step + row[j] * G + u] : c0[row[j] * G + u];
  };
  auto prefetch_step = [&](int j, int t) {
    const float* gp = gates + (size_t)t * x_step + row[j] * G4 + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) prefetch_l2(gp + (size_t)q * G);
    prefetch_l2(dhs + (size_t)t * h_step + row[j] * G + u);
    if (t > 0) prefetch_l2(cs + (size_t)(t - 1) * h_step + row[j] * G + u);
  };
  // explicit roundings throughout: the same bits whatever the compiler
  // makes of the code around them (a row must not depend on NT)
  auto coefficients = [&](int j) {
    const float ig = nx[j][0], fg = nx[j][1], gg = nx[j][2], og = nx[j][3];
    const float tc = tanhf(cs_cur[j]);
    k[j].dhs = nx[j][4];
    k[j].a = __fmul_rn(og, __fsub_rn(1.0f, __fmul_rn(tc, tc)));
    k[j].i = __fmul_rn(__fmul_rn(gg, ig), __fsub_rn(1.0f, ig));
    k[j].f = __fmul_rn(__fmul_rn(nx[j][5], fg), __fsub_rn(1.0f, fg));
    k[j].g = __fmul_rn(ig, __fsub_rn(1.0f, __fmul_rn(gg, gg)));
    k[j].o = __fmul_rn(__fmul_rn(tc, og), __fsub_rn(1.0f, og));
    k[j].fg = fg;
    cs_cur[j] = nx[j][5];  // cprev of this step is c of the next
  };

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (valid[j]) {
      dcc[j] = dc[row[j] * G + u];
      cs_cur[j] = cs[(size_t)(T - 1) * h_step + row[j] * G + u];
      load_step(j, T - 1);
      if (T > 1) prefetch_step(j, T - 2);
      if (T > 2) prefetch_step(j, T - 3);
    }
    coefficients(j);
  }

  // Rows beyond nb (and the padding) stay zero.
  for (int i = tid; i < NT * 8 * SW; i += BW_THREADS) dg_s[i] = 0u;
  __syncthreads();

  __nv_bfloat16* dgx_r = dgx + (size_t)r * 2 * BW_ROWS * G4;
  unsigned* flag_r = flags + (size_t)r * BW_FLAGS;
  float* pw = part + warp * BW_ROWS * BW_PSTRIDE;

  // Iteration i handles step t = T - 1 - i; iteration T only forms dh0.
  for (int i = 0; i <= T; ++i) {
    const int t = T - 1 - i;
    // the next step's operands, in flight during the wait; a prefetch two
    // steps earlier has put them into L2
    if (t >= 1) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (valid[j]) {
          load_step(j, t - 1);
          if (t >= 3) prefetch_step(j, t - 3);
        }
      }
    }

    float carry[NT];
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j) carry[j] = valid[j] ? dhT[row[j] * G + u] : 0.0f;
    } else {
      float acc[2][NT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
      // Wait for bf16(dg) of the step before.  Two n-tiles: each warp
      // waits for the producers of its own columns only and goes on alone.
      // One n-tile (a step is shorter, and eight polling warps a block get
      // in the producers' way): warp 0 polls for the block.
      const unsigned want = tag0 + (unsigned)i;
      if (NT == 2 ? polls : (warp == 0 && lane < (int)gridDim.x)) {
        unsigned polled = 0;
        while ((int)(ld_acquire(flag_r + lane) - want) < 0) {
          if (++polled > BW_MAX_POLLS) __trap();
        }
      }
      if (NT == 2) {
        __syncwarp();
      } else {
        __syncthreads();
      }
      if (ktn > 0) {
        // columns [col0, col1) of every row, from L2 into shared memory
        const __nv_bfloat16* src = dgx_r + (size_t)((i - 1) & 1) * BW_ROWS * G4 + col0 + lane * 8;
        uint32_t* dst = dg_s + col0 / 2 + lane * 4;
        if (lane < 2 * ktn) {
          for (int b = 0; b < nb; ++b) cp_async16(dst + b * SW, src + (size_t)b * G4);
        }
        cp_async_wait_all();
        __syncwarp();

        const uint32_t* bs = dg_s + col0 / 2 + tq;
#pragma unroll
        for (int kt = 0; kt < BW_KT; ++kt) {
          if (kt < ktn) {
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const uint32_t* bp = bs + (j * 8 + g) * SW + kt * 8;
              const uint32_t b0r = bp[0], b1r = bp[4];
              mma_bf16(acc[0][j], wf[0][kt], b0r, b1r);
              mma_bf16(acc[1][j], wf[1][kt], b0r, b1r);
            }
          }
        }
      }
      // accumulator (unit mt*16 + g [+ 8], row j*8 + 2tq [+ 1]) -> part[warp][row][unit]
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float* pp = pw + (j * 8 + 2 * tq) * BW_PSTRIDE + mt * 16 + g;
          pp[0] = acc[mt][j][0];
          pp[BW_PSTRIDE] = acc[mt][j][1];
          pp[8] = acc[mt][j][2];
          pp[BW_PSTRIDE + 8] = acc[mt][j][3];
        }
      }
      __syncthreads();
      // the eight warps' partial sums, always in this order
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* pr = part + (j * 8 + warp) * BW_PSTRIDE + lane;
        float s = pr[0];
#pragma unroll
        for (int w = 1; w < BW_WARPS; ++w) s = __fadd_rn(s, pr[w * BW_ROWS * BW_PSTRIDE]);
        carry[j] = s;
      }
    }

    if (i == T) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (valid[j]) {
          dh0[row[j] * G + u] = carry[j];
          dc[row[j] * G + u] = dcc[j];
        }
      }
      break;
    }

    float dg[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (valid[j]) {
        const float dh = __fadd_rn(carry[j], k[j].dhs);
        const float dct = __fmaf_rn(dh, k[j].a, dcc[j]);
        dg[j][0] = __fmul_rn(dct, k[j].i);
        dg[j][1] = __fmul_rn(dct, k[j].f);
        dg[j][2] = __fmul_rn(dct, k[j].g);
        dg[j][3] = __fmul_rn(dh, k[j].o);
        dcc[j] = __fmul_rn(dct, k[j].fg);
        // a warp writes 64 contiguous bytes per gate
        __nv_bfloat16* de = dgx_r + ((size_t)(i & 1) * BW_ROWS + j * 8 + warp) * G4 + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) de[(size_t)q * G] = __float2bfloat16(dg[j][q]);
      }
    }
    // every thread's exchange stores, then the block's flag; the barrier
    // also frees `part` for the next step's partial sums
    __syncthreads();
    if (tid == 0) st_release(flag_r + blockIdx.x, tag0 + (unsigned)i + 1u);

    // dxp after the flag, so that the release does not wait for it
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (valid[j]) {
        float* dx = dxp + (size_t)t * x_step + row[j] * G4 + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) dx[(size_t)q * G] = dg[j][q];
      }
    }

    // the next step's coefficients, while the flag travels
    if (t >= 1) {
#pragma unroll
      for (int j = 0; j < NT; ++j) coefficients(j);
    }
  }
}

// ---------------------------------------------------------------------------
// K5's block form (G above 512)
// ---------------------------------------------------------------------------

constexpr int BWW_WARPS = 8;
constexpr int BWW_THREADS = 32 * BWW_WARPS;
constexpr int BWW_FLAGS = 128;  // flag words per chain: one per block, four lines
constexpr int BWW_PCHUNK = 8;   // partials a cell has in flight

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(x));
}

// Dynamic shared memory of a block of the form (MTW m-tiles a warp, KL local
// k-tiles, KREG of a warp's tiles in registers) at a row tile of `rows`: the
// shared tiles (16 bytes a thread each) and the block's bf16 dg rows.
__host__ __device__ constexpr size_t bww_smem_bytes(int mtw, int kl, int kreg, int rows) {
  return (size_t)16 * (mtw * kl - kreg) * BWW_THREADS + (size_t)4 * rows * (8 * kl + BW_DPAD);
}

// grid = (blocks a chain, chains of this launch), BWW_THREADS threads.  NT
// n-tiles of 8 rows; a block owns U = 4 KL units.  px: exchange (R, 2,
// blocks a chain, BW_ROWS, G) f32; flags (R, BWW_FLAGS) words, zeroed by the
// caller before the layer's first launch; tag0 as the resident form's.
template <int NT, int MTW, int KL, int KREG>
__global__ void __launch_bounds__(BWW_THREADS, 1)
lstm_bwd_block_kernel(const float* __restrict__ gates,        // (T, RB, 4G)
                      const float* __restrict__ cs,           // (T, RB, G)
                      const float* __restrict__ c0,           // (RB, G)
                      const __nv_bfloat16* __restrict__ whh,  // (R, G, 4G)
                      const float* __restrict__ dhs,          // (T, RB, G)
                      const float* __restrict__ dhT,          // (RB, G)
                      float* __restrict__ dc,                 // (RB, G), in place
                      float* __restrict__ dxp,                // (T, RB, 4G)
                      float* __restrict__ dh0,                // (RB, G)
                      float* px, unsigned* flags, int T, int R, int B, int b0, int nb, int G,
                      int r0, unsigned tag0) {
  constexpr int U = 4 * KL;      // units a block owns: 4U local columns, KL k-tiles
  constexpr int ROWS = 8 * NT;   // rows of the launch's row tile
  constexpr int CELLS = (U * ROWS + BWW_THREADS - 1) / BWW_THREADS;
  constexpr int TILES = MTW * KL;  // a warp's A tiles; tile s = kt * MTW + i
  constexpr int SW = 2 * U + BW_DPAD;  // words per dg row; SW % 32 in {4, 20}
  static_assert(KREG <= TILES, "register tiles beyond the warp's tiles");
  extern __shared__ __align__(16) unsigned char bww_smem[];
  uint4* w_s = reinterpret_cast<uint4*>(bww_smem);  // (TILES - KREG, warps, 32 lanes)
  uint32_t* dgl =                                    // (ROWS, SW) words of bf16 pairs
      reinterpret_cast<uint32_t*>(bww_smem + (size_t)16 * (TILES - KREG) * BWW_THREADS);
  unsigned short* dgh = reinterpret_cast<unsigned short*>(dgl);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group: tile rows g and g + 8, B/C column g
  const int tq = lane & 3;
  const int r = r0 + blockIdx.y;
  const int nblk = gridDim.x;
  const int G4 = 4 * G;
  const int RB = R * B;
  const int MT = (G + 15) / 16;  // m-tiles of the chain's units
  const int u0 = blockIdx.x * U;

  // A-fragments: m = unit v of the chain, k = local column l, the gate
  // l / U of unit u0 + l % U.  Register 0: (unit 16 m + g, columns 2tq,
  // 2tq+1 of the k-tile), 1: (unit + 8, same), 2/3: the columns 8 higher.
  // l is even and U is even, so a register is two neighbouring units of
  // one gate: one aligned 32-bit load.  Zero beyond G.
  uint32_t wf[KREG > 0 ? KREG : 1][4];
  {
    const unsigned short* wr = reinterpret_cast<const unsigned short*>(whh) + (size_t)r * G * G4;
    auto word = [&](int v, int l) -> uint32_t {
      const int u = u0 + l % U;
      if (v >= G || u >= G) return 0u;
      return *reinterpret_cast<const uint32_t*>(wr + (size_t)v * G4 + (size_t)(l / U) * G + u);
    };
#pragma unroll
    for (int s = 0; s < TILES; ++s) {
      const int kt = s / MTW;
      const int m = warp + BWW_WARPS * (s % MTW);
      const int va = m * 16 + g;
      const int l = kt * 16 + 2 * tq;
      uint32_t a[4] = {0u, 0u, 0u, 0u};
      if (m < MT) {
        a[0] = word(va, l);
        a[1] = word(va + 8, l);
        a[2] = word(va, l + 8);
        a[3] = word(va + 8, l + 8);
      }
      if (s < KREG) {  // a constant once unrolled; the guard keeps wf's index in range
#pragma unroll
        for (int e = 0; e < 4; ++e) wf[s < KREG ? s : 0][e] = a[e];
      } else {
        // the thread's own slot: no other thread reads it, so no barrier
        w_s[((s - KREG) * BWW_WARPS + warp) * 32 + lane] = make_uint4(a[0], a[1], a[2], a[3]);
      }
    }
  }

  // The cells: cell c = tid + BWW_THREADS e is unit u0 + c % U, row c / U
  // of the row tile (neighbouring threads, neighbouring units).
  bool valid[CELLS];
  int uu[CELLS], nn[CELLS];
  size_t row[CELLS];
  float dcc[CELLS], cs_cur[CELLS];
  BwdCoef k[CELLS];
  float nx[CELLS][6];  // the next step's i, f, g, o, dhs, cprev
#pragma unroll
  for (int j = 0; j < CELLS; ++j) {
    const int c = tid + BWW_THREADS * j;
    nn[j] = c / U;
    uu[j] = u0 + c % U;
    valid[j] = c < U * ROWS && uu[j] < G && nn[j] < nb;
    row[j] = (size_t)r * B + b0 + nn[j];
    dcc[j] = cs_cur[j] = 0.0f;
#pragma unroll
    for (int e = 0; e < 6; ++e) nx[j][e] = 0.0f;
  }

  const size_t x_step = (size_t)RB * G4;
  const size_t h_step = (size_t)RB * G;
  auto load_step = [&](int j, int t) {
    const float* gp = gates + (size_t)t * x_step + row[j] * G4 + uu[j];
#pragma unroll
    for (int q = 0; q < 4; ++q) nx[j][q] = gp[(size_t)q * G];
    nx[j][4] = dhs[(size_t)t * h_step + row[j] * G + uu[j]];
    nx[j][5] =
        t > 0 ? cs[(size_t)(t - 1) * h_step + row[j] * G + uu[j]] : c0[row[j] * G + uu[j]];
  };
  auto prefetch_step = [&](int j, int t) {
    const float* gp = gates + (size_t)t * x_step + row[j] * G4 + uu[j];
#pragma unroll
    for (int q = 0; q < 4; ++q) prefetch_l2(gp + (size_t)q * G);
    prefetch_l2(dhs + (size_t)t * h_step + row[j] * G + uu[j]);
    if (t > 0) prefetch_l2(cs + (size_t)(t - 1) * h_step + row[j] * G + uu[j]);
  };
  // the resident form's cell, with its explicit roundings
  auto coefficients = [&](int j) {
    const float ig = nx[j][0], fg = nx[j][1], gg = nx[j][2], og = nx[j][3];
    const float tc = tanhf(cs_cur[j]);
    k[j].dhs = nx[j][4];
    k[j].a = __fmul_rn(og, __fsub_rn(1.0f, __fmul_rn(tc, tc)));
    k[j].i = __fmul_rn(__fmul_rn(gg, ig), __fsub_rn(1.0f, ig));
    k[j].f = __fmul_rn(__fmul_rn(nx[j][5], fg), __fsub_rn(1.0f, fg));
    k[j].g = __fmul_rn(ig, __fsub_rn(1.0f, __fmul_rn(gg, gg)));
    k[j].o = __fmul_rn(__fmul_rn(tc, og), __fsub_rn(1.0f, og));
    k[j].fg = fg;
    cs_cur[j] = nx[j][5];
  };

#pragma unroll
  for (int j = 0; j < CELLS; ++j) {
    if (valid[j]) {
      dcc[j] = dc[row[j] * G + uu[j]];
      cs_cur[j] = cs[(size_t)(T - 1) * h_step + row[j] * G + uu[j]];
      load_step(j, T - 1);
      if (T > 1) prefetch_step(j, T - 2);
      if (T > 2) prefetch_step(j, T - 3);
    }
    coefficients(j);
  }

  // Rows beyond nb, units beyond G and the padding stay zero.
  for (int i = tid; i < ROWS * SW; i += BWW_THREADS) dgl[i] = 0u;
  __syncthreads();

  const size_t slice = (size_t)BW_ROWS * G;  // one block's partials of a step
  float* px_r = px + (size_t)r * 2 * nblk * slice;
  unsigned* flag_r = flags + (size_t)r * BWW_FLAGS;

  // Iteration i handles step t = T - 1 - i; iteration T only forms dh0.
  for (int i = 0; i <= T; ++i) {
    const int t = T - 1 - i;
    if (t >= 1) {
#pragma unroll
      for (int j = 0; j < CELLS; ++j) {
        if (valid[j]) {
          load_step(j, t - 1);
          if (t >= 3) prefetch_step(j, t - 3);
        }
      }
    }

    float carry[CELLS];
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < CELLS; ++j) carry[j] = valid[j] ? dhT[row[j] * G + uu[j]] : 0.0f;
    } else {
      // every block of the chain has published its partials of the step
      // before: warp 0 waits for the flags, the barrier holds the others
      const unsigned want = tag0 + (unsigned)i;
      if (warp == 0) {
        for (int bb = lane; bb < nblk; bb += 32) {
          unsigned polled = 0;
          while ((int)(ld_acquire(flag_r + bb) - want) < 0) {
            if (++polled > BW_MAX_POLLS) __trap();
          }
        }
      }
      __syncthreads();
      // the nblk partials of each cell, BWW_PCHUNK in flight, added in
      // block order
      const float* src = px_r + (size_t)((i - 1) & 1) * nblk * slice;
#pragma unroll
      for (int j = 0; j < CELLS; ++j) carry[j] = 0.0f;
      for (int c0b = 0; c0b < nblk; c0b += BWW_PCHUNK) {
        float p[CELLS][BWW_PCHUNK];
#pragma unroll
        for (int e = 0; e < BWW_PCHUNK; ++e) {
#pragma unroll
          for (int j = 0; j < CELLS; ++j) {
            p[j][e] = (valid[j] && c0b + e < nblk)
                          ? __ldcg(src + (size_t)(c0b + e) * slice + (size_t)nn[j] * G + uu[j])
                          : 0.0f;
          }
        }
#pragma unroll
        for (int e = 0; e < BWW_PCHUNK; ++e) {
          if (c0b + e < nblk) {
#pragma unroll
            for (int j = 0; j < CELLS; ++j)
              carry[j] = c0b + e == 0 ? p[j][e] : __fadd_rn(carry[j], p[j][e]);
          }
        }
      }
    }

    if (i == T) {
#pragma unroll
      for (int j = 0; j < CELLS; ++j) {
        if (valid[j]) {
          dh0[row[j] * G + uu[j]] = carry[j];
          dc[row[j] * G + uu[j]] = dcc[j];
        }
      }
      break;
    }

    float dg[CELLS][4];
#pragma unroll
    for (int j = 0; j < CELLS; ++j) {
      if (valid[j]) {
        const float dh = __fadd_rn(carry[j], k[j].dhs);
        const float dct = __fmaf_rn(dh, k[j].a, dcc[j]);
        dg[j][0] = __fmul_rn(dct, k[j].i);
        dg[j][1] = __fmul_rn(dct, k[j].f);
        dg[j][2] = __fmul_rn(dct, k[j].g);
        dg[j][3] = __fmul_rn(dh, k[j].o);
        dcc[j] = __fmul_rn(dct, k[j].fg);
        // local column q U + (unit - u0) of row nn
        unsigned short* de = dgh + (size_t)nn[j] * 2 * SW + (uu[j] - u0);
#pragma unroll
        for (int q = 0; q < 4; ++q) de[q * U] = (unsigned short)bf16_bits(dg[j][q]);
      }
    }
    __syncthreads();

    // the product: this warp's m-tiles over the block's KL k-tiles
    float acc[MTW][NT][4];
#pragma unroll
    for (int a = 0; a < MTW; ++a)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < KL; ++kt) {
      uint32_t bfr[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t* bp = dgl + (j * 8 + g) * SW + kt * 8 + tq;
        bfr[j][0] = bp[0];
        bfr[j][1] = bp[4];
      }
#pragma unroll
      for (int a = 0; a < MTW; ++a) {
        const int s = kt * MTW + a;
        if (warp + BWW_WARPS * a < MT) {
          uint32_t fa[4];
          if (s < KREG) {
#pragma unroll
            for (int e = 0; e < 4; ++e) fa[e] = wf[s < KREG ? s : 0][e];
          } else {
            const uint4 a4 = w_s[((s - KREG) * BWW_WARPS + warp) * 32 + lane];
            fa[0] = a4.x;
            fa[1] = a4.y;
            fa[2] = a4.z;
            fa[3] = a4.w;
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[a][j], fa, bfr[j][0], bfr[j][1]);
        }
      }
    }
    // accumulator (unit 16 m + g [+ 8], row j*8 + 2tq [+ 1]) -> this
    // block's slice of the exchange, (row, unit)
    float* dst = px_r + ((size_t)(i & 1) * nblk + blockIdx.x) * slice;
#pragma unroll
    for (int a = 0; a < MTW; ++a) {
      const int va = (warp + BWW_WARPS * a) * 16 + g;
      if (va - g < G) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n0 = j * 8 + 2 * tq;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int v = va + (e >> 1) * 8;
            const int n = n0 + (e & 1);
            if (v < G && n < nb) dst[(size_t)n * G + v] = acc[a][j][e];
          }
        }
      }
    }
    // every thread's exchange stores, then the block's flag; the barrier
    // also frees the dg rows for the next step's cells
    __syncthreads();
    if (tid == 0) st_release(flag_r + blockIdx.x, tag0 + (unsigned)i + 1u);

    // dxp after the flag, so that the release does not wait for it
#pragma unroll
    for (int j = 0; j < CELLS; ++j) {
      if (valid[j]) {
        float* dx = dxp + (size_t)t * x_step + row[j] * G4 + uu[j];
#pragma unroll
        for (int q = 0; q < 4; ++q) dx[(size_t)q * G] = dg[j][q];
      }
    }

    // the next step's coefficients, while the flag travels
    if (t >= 1) {
#pragma unroll
      for (int j = 0; j < CELLS; ++j) coefficients(j);
    }
  }
}

constexpr int DW_BM = 128;     // dW rows (hidden units) per K6 block
constexpr int DW_BN = 128;      // dW columns (gate columns) per K6 block
constexpr int DW_BK = 32;       // (t, b) pairs per shared-memory stage
constexpr int DW_LD = DW_BM + 8;  // bf16 per staged row: 272 bytes, conflict-free ldmatrix
constexpr int DW_THREADS = 256;
constexpr int DW_F4 = DW_BK * DW_BM / 4 / DW_THREADS;  // float4 loads per thread and operand

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Four neighbouring f32 of a row of `width`, zeros beyond it; one 16-byte
// load where the row's alignment allows.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int i, int width,
                                        bool vec) {
  if (vec && i + 3 < width) return __ldg(reinterpret_cast<const float4*>(row + i));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < width) v.x = __ldg(row + i);
  if (i + 1 < width) v.y = __ldg(row + i + 1);
  if (i + 2 < width) v.z = __ldg(row + i + 2);
  if (i + 3 < width) v.w = __ldg(row + i + 3);
  return v;
}

__device__ __forceinline__ uint2 round4(const float4& v) {
  const __nv_bfloat162 lo = __float22bfloat162_rn(make_float2(v.x, v.y));
  const __nv_bfloat162 hi = __float22bfloat162_rn(make_float2(v.z, v.w));
  uint2 out;
  out.x = *reinterpret_cast<const uint32_t*>(&lo);
  out.y = *reinterpret_cast<const uint32_t*>(&hi);
  return out;
}

// grid = (ceil(4G/128), ceil(G/128), R); 8 warps as 2 (rows) x 4 (columns),
// each owning 64 x 32 of the tile as 4 x 4 mma tiles.
__global__ void __launch_bounds__(DW_THREADS, 2)
lstm_dw_kernel(const float* __restrict__ hs,    // (T, RB, G)
               const float* __restrict__ h0,    // (RB, G)
               const float* __restrict__ dxp,   // (T, RB, 4G)
               float* __restrict__ dw,          // (R, G, 4G)
               int T, int R, int B, int G) {
  __shared__ __align__(16) __nv_bfloat16 As[2][DW_BK][DW_LD];  // bf16(h_{t-1}), n-major
  __shared__ __align__(16) __nv_bfloat16 Bs[2][DW_BK][DW_LD];  // bf16(dg_t), n-major
  const int r = blockIdx.z;
  const int m0 = blockIdx.y * DW_BM;
  const int n0 = blockIdx.x * DW_BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;
  const int G4 = 4 * G;
  const int RB = R * B;
  const int N = T * B;
  const bool vec = (G & 3) == 0;  // rows of hs and dxp are 16-byte aligned

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // A stage goes in two halves of 16 pairs; of each half this thread
  // brings pair kk = e / 32, columns 4 * (e % 32), e = tid + 256 * (2 * half + i)
  float4 ra[DW_F4 / 2], rb[DW_F4 / 2];
  auto fetch = [&](int k0, int half) {
#pragma unroll
    for (int i = 0; i < DW_F4 / 2; ++i) {
      const int e = tid + (2 * half + i) * DW_THREADS;
      const int n = k0 + e / 32;
      const int q = (e % 32) * 4;
      ra[i] = rb[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (n < N) {
        const int t = n / B;
        const size_t row = (size_t)r * B + (size_t)(n - t * B);
        const float* a = t == 0 ? h0 + row * G : hs + ((size_t)(t - 1) * RB + row) * G;
        ra[i] = load4(a, m0 + q, G, vec);
        rb[i] = load4(dxp + ((size_t)t * RB + row) * G4, n0 + q, G4, vec);
      }
    }
  };
  auto stage = [&](int buf, int half) {
#pragma unroll
    for (int i = 0; i < DW_F4 / 2; ++i) {
      const int e = tid + (2 * half + i) * DW_THREADS;
      *reinterpret_cast<uint2*>(&As[buf][e / 32][(e % 32) * 4]) = round4(ra[i]);
      *reinterpret_cast<uint2*>(&Bs[buf][e / 32][(e % 32) * 4]) = round4(rb[i]);
    }
  };

  // ldmatrix row addresses: lane l gives row l % 8 of 8 x 8 matrix l / 8
  const int lrow = lane & 7;
  const int lmat = lane >> 3;
  const int a_k = (lmat >> 1) * 8 + lrow;  // A: matrices (k lo, m lo), (k lo, m hi), (k hi, ...)
  const int a_m = (lmat & 1) * 8;
  const int b_k = (lmat & 1) * 8 + lrow;   // B: (k lo, n lo), (k hi, n lo), (k lo, n hi), ...
  const int b_n = (lmat >> 1) * 8;

  const int stages = (N + DW_BK - 1) / DW_BK;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    fetch(0, half);
    stage(0, half);
  }
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < stages;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // the next stage's loads fly while this half is multiplied
      if (more) fetch((s + 1) * DW_BK, half);
      const int kk = half * 16;
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4_trans(af[i], &As[buf][kk + a_k][wm + i * 16 + a_m]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(bfr[j], &Bs[buf][kk + b_k][wn + j * 16 + b_n]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2], bfr[j >> 1][(j & 1) * 2 + 1]);
      if (more) stage(buf ^ 1, half);
    }
    __syncthreads();
  }

  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + g + half * 8;
      if (m >= G) continue;
      float* out = dw + ((size_t)r * G + m) * G4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn + j * 8 + 2 * tq;
        if (c < G4) out[c] = acc[i][j][half * 2];
        if (c + 1 < G4) out[c + 1] = acc[i][j][half * 2 + 1];
      }
    }
  }
}

using bww_fn = void (*)(const float*, const float*, const float*, const __nv_bfloat16*,
                        const float*, const float*, float*, float*, float*, float*, unsigned*,
                        int, int, int, int, int, int, int, unsigned);

// K5's block forms, (m-tiles a warp, units a block) -> (k-tiles a warp keeps
// in registers): 5 m-tiles and 40 units (G <= 640), 24 of 50 tiles; 8
// m-tiles and 32 units (G <= 1024), 20 of 64.  ops/lstm_cuda.py:
// BWD_BLOCK_FORMS mirrors the table.  0: no such form.
int bww_kreg(int mtw, int units) {
  return mtw == 5 && units == 40 ? 24 : mtw == 8 && units == 32 ? 20 : 0;
}

// The instantiation of the form for nb rows a chain; nullptr for a form the
// table has not.
bww_fn bww_kernel(int mtw, int units, int nb) {
  const bool two = nb > 8;
  if (mtw == 5 && units == 40)
    return two ? lstm_bwd_block_kernel<2, 5, 10, 24> : lstm_bwd_block_kernel<1, 5, 10, 24>;
  if (mtw == 8 && units == 32)
    return two ? lstm_bwd_block_kernel<2, 8, 8, 20> : lstm_bwd_block_kernel<1, 8, 8, 20>;
  return nullptr;
}

// The kernel for (mtw, units, nb) with the dynamic shared memory it asks
// for allowed; cudaErrorInvalidValue for a form the table has not.
cudaError_t bww_setup(int mtw, int units, int nb, bww_fn* fn, size_t* smem) {
  *fn = bww_kernel(mtw, units, nb);
  if (*fn == nullptr) return cudaErrorInvalidValue;
  *smem = bww_smem_bytes(mtw, units / 4, bww_kreg(mtw, units), nb > 8 ? 16 : 8);
  return cudaFuncSetAttribute((const void*)*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

// K5's block form on the current device: blocks of the form (mtw m-tiles a
// warp, `units` units a block) at a row tile of `rows` (8 or 16): `smem`,
// the dynamic shared memory a block asks for, and `blocks`, how many such
// blocks the device holds at once (0 where a block's shared memory is more
// than the device allows).  Returns the first CUDA error;
// cudaErrorInvalidConfiguration where the device has no cooperative launch.
extern "C" int umx_lstm_bwd_block_layout(int mtw, int units, int rows, int* blocks, int* smem) {
  int dev = 0, sms = 0, coop = 0, smem_max = 0, per_sm = 0;
  *blocks = 0;
  *smem = 0;
  if ((rows != 8 && rows != BW_ROWS) || bww_kernel(mtw, units, rows) == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorInvalidConfiguration;
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  *smem = (int)bww_smem_bytes(mtw, units / 4, bww_kreg(mtw, units), rows);
  if (*smem > smem_max) return (int)cudaSuccess;
  bww_fn fn = nullptr;
  size_t bytes = 0;
  e = bww_setup(mtw, units, rows, &fn, &bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)fn, BWW_THREADS, bytes);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  return (int)cudaSuccess;
}

// K5's block form: one launch, the whole reverse sweep of chains [r0, r0 +
// nr) and rows [b0, b0 + nb) of each, nb <= 16, in the form (mtw, units),
// which must hold G (ceil(G/16) <= 8 mtw m-tiles, at most 128 blocks a
// chain).  `dc` holds dcT on entry and dc0 on return for those rows.  `px`
// is the exchange, R * 2 * ceil(G/units) * 16 * G f32; `flags` R * 128
// words, zeroed before the layer's first launch; `tag0` the number of steps
// earlier launches ran on the same buffers.  Returns the first CUDA error.
extern "C" int umx_lstm_bwd_block(const float* gates, const float* cs, const float* c0,
                                  const void* whh, const float* dhs, const float* dhT, float* dc,
                                  float* dxp, float* dh0, void* px, void* flags, int T, int R,
                                  int B, int G, int mtw, int units, int r0, int nr, int b0, int nb,
                                  unsigned tag0, void* stream) {
  if (G % 8 != 0 || G < 8 || T < 1 || B < 1 || nb < 1 || nb > BW_ROWS || b0 < 0 ||
      b0 + nb > B || nr < 1 || r0 < 0 || r0 + nr > R || units < 8 ||
      (G + 15) / 16 > BWW_WARPS * mtw || (G + units - 1) / units > BWW_FLAGS)
    return (int)cudaErrorInvalidValue;
  bww_fn fn = nullptr;
  size_t smem = 0;
  cudaError_t e = bww_setup(mtw, units, nb, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(whh);
  float* pxp = static_cast<float*>(px);
  unsigned* fl = static_cast<unsigned*>(flags);
  void* args[] = {&gates, &cs, &c0, &w,  &dhs, &dhT, &dc, &dxp, &dh0, &pxp,
                  &fl,    &T,  &R,  &B,  &b0,  &nb,  &G,  &r0,  &tag0};
  const dim3 grid((G + units - 1) / units, nr);
  e = cudaLaunchCooperativeKernel((const void*)fn, grid, dim3(BWW_THREADS), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K5: how many of its blocks the current device holds at once at width G
// (what a cooperative launch may ask for).  Returns the first CUDA error;
// cudaErrorInvalidConfiguration where the device has no cooperative launch
// or G is above 512.
extern "C" int umx_lstm_bwd_capacity(int G, int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (G < 8 || G > BW_G_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = bwd_smem_bytes(2, G);
  e = cudaFuncSetAttribute(lstm_bwd_resident_kernel<2>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_bwd_resident_kernel<2>,
                                                    BW_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  return (int)cudaSuccess;
}

// K5: one launch, the whole reverse sweep of chains [r0, r0 + nr) and rows
// [b0, b0 + nb) of each, nb <= 16.  `dc` holds dcT on entry and dc0 on
// return for those rows.  `dgx` is the exchange buffer, R * 2 * 16 * 4G
// bf16; `flags` R * 32 words, zeroed before the layer's first launch;
// `tag0` is the number of steps earlier launches ran on the same buffers.
// Returns the first CUDA error; cudaErrorInvalidConfiguration where G is
// above 512.
extern "C" int umx_lstm_bwd(const float* gates, const float* cs, const float* c0,
                            const void* whh, const float* dhs, const float* dhT, float* dc,
                            float* dxp, float* dh0, void* dgx, void* flags, int T, int R, int B,
                            int G, int r0, int nr, int b0, int nb, unsigned tag0, void* stream) {
  if (G % 8 != 0 || G < 8 || T < 1 || B < 1 || nb < 1 || nb > BW_ROWS || b0 < 0 ||
      b0 + nb > B || nr < 1 || r0 < 0 || r0 + nr > R)
    return (int)cudaErrorInvalidValue;
  if (G > BW_G_MAX) return (int)cudaErrorInvalidConfiguration;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(whh);
  __nv_bfloat16* dgp = static_cast<__nv_bfloat16*>(dgx);
  unsigned* fl = static_cast<unsigned*>(flags);
  void* args[] = {&gates, &cs, &c0, &w,  &dhs, &dhT, &dc, &dxp, &dh0, &dgp,
                  &fl,    &T,  &R,  &B,  &b0,  &nb,  &G,  &r0,  &tag0};
  const int nt = nb > 8 ? 2 : 1;
  const void* fn = nt == 2 ? (const void*)lstm_bwd_resident_kernel<2>
                           : (const void*)lstm_bwd_resident_kernel<1>;
  const size_t smem = bwd_smem_bytes(nt, G);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((G + BW_UNITS - 1) / BW_UNITS, nr);
  e = cudaLaunchCooperativeKernel(fn, grid, dim3(BW_THREADS), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K6: dW (R, G, 4G) from hs, h0 and dxp; one launch.
extern "C" int umx_lstm_dw(const float* hs, const float* h0, const float* dxp, float* dw,
                           int T, int R, int B, int G, void* stream) {
  if (B < 1 || T < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((4 * G + DW_BN - 1) / DW_BN, (G + DW_BM - 1) / DW_BM, R);
  lstm_dw_kernel<<<grid, DW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(hs, h0, dxp, dw,
                                                                            T, R, B, G);
  return (int)cudaGetLastError();
}
