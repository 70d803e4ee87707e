// Per-target BLSTM recurrence for one LSTM layer (K9): one launch runs all
// T timesteps of every chain, each chain's W_hh and state staying on chip.
//
// Replaces: umx_tpu/ops/lstm_pallas.py:_make_kernel (reached via
// lstm_layer_pallas), the TPU kernel whose grid is (targets, time blocks)
// with one target's W_hh and h/c resident in VMEM while the grid walks
// that target's time blocks.
//
// Contract (the same function as the merged kernel at one batch row, with
// the chains laid out (T#, D) as the TPU kernel has them):
//   xp  (T#, T, D, 4G) f32   input projections + both biases, gates i|f|g|o
//   whh (T#, D, G, 4G) bf16  hidden-hidden weights, contracted over G
//   h0, c0 (T#, D, G)  f32
// Per step:  gates = xp_t + bf16(h_{t-1}) . whh[chain]   (f32 accumulation)
//            c = sigmoid(f) c + sigmoid(i) tanh(g);  h = sigmoid(o) tanh(c)
// Outputs hs (T#, T, D, G), hT, cT (T#, D, G), all f32.  Any T: the TPU
// kernel's time blocks (and their padding) are its DMA granularity only.
//
// What bounds it on the H100: the T steps are dependent, so a layer costs
// T times one step's latency; the bytes (x_proj and hs once, W_hh once)
// would take tens of microseconds.  A step is a (1 x G) by (G x 4G)
// product per chain; what it waits for is W_hh (2 MiB a chain at G = 512)
// and then the exchange of the new h between the blocks that share a chain.
//
// Design.  What the TPU kernel adds is residency, and this card's form of
// it is a thread-block cluster per chain: grid = (CL, T# x D) with cluster
// dimension CL.  How many clusters the card holds at once is a matter of
// its GPCs: an H100 SXM holds 7 clusters of 10 to 16 blocks at one block an
// SM, but 9 clusters of 9 and 15 of 8, so a chain must fit 9 blocks for
// UMX-L's 8 chains to run in one wave: 240 KiB of W_hh a block, more than
// its shared memory.  So W_hh is split between the register file and shared
// memory:
//   * a block of 16 warps owns U <= 64 hidden units, a warp 4 of them as
//     one mma row tile (tile row g is gate g / 4 of unit g % 4, row g + 8
//     gate g / 4 + 2, the layout of lstm_merged.cu).  A warp's
//     mma.sync issue one after the other whatever their accumulators, so
//     the tensor pipe fills only with several warps on each scheduler:
//     four here;
//   * k-tiles 0..15 of the row tile stay in registers as
//     mma.sync.m16n8k16 A-fragments for the whole layer (64 registers a
//     thread), k-tiles 16.. in shared memory in fragment order, a lane's
//     four words as one 16-byte load (128 KiB a block at G = 512; nothing
//     at G <= 256), loaded a pair of tiles ahead of the mma that use them,
//     the first pair before the step's wait;
//   * the one batch row is column 0 of the mma's 8 columns.  h is kept in
//     shared memory as bf16, permuted so that the B-fragment of a pair of
//     k-tiles is one 16-byte load for the four lanes that feed column 0;
//     the other lanes read 16 bytes of zeros (16 loads a warp and step);
//   * four accumulators, added in a fixed order, so the bits do not depend
//     on timing;
//   * the cell runs on 8 lanes of every warp: lane 4 g' activates gates i
//     and g of unit g', lane 4 (g' + 4) gates f and o, they swap the results
//     by one shuffle each and both carry c and h in registers (two
//     activations deep instead of four);
//   * the new h goes to every block of the cluster through distributed
//     shared memory with st.async: a warp packs its 4 values into 2 words
//     and its 32 lanes store them to up to 16 destinations in one
//     instruction.  Each store counts its bytes off an mbarrier of the
//     destination block (complete_tx), which that block armed with the 2 G
//     bytes of a whole h; a block waits on its own barrier only.  No
//     cluster-wide barrier and no release/acknowledge round trip is left in
//     a step.  Two h buffers (and two barriers) are enough: a block reaches
//     step t + 1's stores only after it has all of h_t, which every block
//     sent after it had finished reading h_{t-1};
//   * the hs store and the next step's x_proj loads follow the stores,
//     while they fly (issued among the mma they cost the product more).
// Chains never talk to each other: no grid-wide barrier, no cooperative
// launch.  A wait that lasts seconds traps instead of hanging the card.
//
// Cluster size.  The wrapper asks umx_lstm_pertarget_clusters how many
// clusters of each size 1..16 the device holds at once for this G (0 where
// a block's units or shared memory do not fit) and chooses: fewest waves,
// then fewest units per block.  If fewer clusters fit than there are
// chains, the rest run in a second wave: slower, still right.  A G that no
// cluster size takes is refused (on the H100's 227 KB: G above 704).
// Requires G % 8 == 0 and a 16-byte aligned W_hh (the wrapper checks).
//
// Measured on an H100 80GB HBM3 at 700 W (T = 2584, 8 chains): 6.35 ms a
// layer at G = 512 in one wave of 9 blocks a chain (2.46 us a step; 12.94 ms
// in the earlier form, 16 blocks a chain with W_hh in shared memory, two
// waves), 3.42 ms at G = 256.  Of a step's ~4000 cycles the product takes
// ~2170: 128 mma a scheduler with one useful column of eight, which is what
// the tensor cores take for them; the rest is the cell (~600), the stores
// and their flight (~800) and the wait (~450).  128 registers, 20 bytes of
// spills outside the loop.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int PT_WARPS = 16;
constexpr int PT_THREADS = 32 * PT_WARPS;
constexpr int PT_WARP_UNITS = 4;                        // one mma row tile
constexpr int PT_MAX_UNITS = PT_WARPS * PT_WARP_UNITS;  // 64
constexpr int PT_KREG = 16;                             // k-tiles of the row tile in registers
constexpr int PT_MAX_CLUSTER = 16;
constexpr unsigned PT_MAX_POLLS = 1u << 24;

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(x));
}

__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint4& a, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// W_hh[k][col] and W_hh[k+1][col] as one register (low half: k); 0 beyond G.
__device__ __forceinline__ uint32_t w_pair(const unsigned short* __restrict__ w, int k, int col,
                                           int G, int G4) {
  if (k >= G) return 0u;  // G is even, so k < G implies k + 1 < G
  const uint32_t lo = w[(size_t)k * G4 + col];
  const uint32_t hi = w[(size_t)(k + 1) * G4 + col];
  return lo | (hi << 16);
}

// The A-fragment of k-tile kt for tile columns col_a (rows 0-7) and col_b (rows 8-15).
__device__ __forceinline__ uint4 w_fragment(const unsigned short* __restrict__ w, int kt, int tq,
                                            int col_a, int col_b, int G, int G4) {
  const int k = kt * 16 + 2 * tq;
  return make_uint4(w_pair(w, k, col_a, G, G4), w_pair(w, k, col_b, G, G4),
                    w_pair(w, k + 8, col_a, G, G4), w_pair(w, k + 8, col_b, G, G4));
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" : : "l"(p));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address of this block's shared-memory address `addr` in block `rank`
// of the cluster (distributed shared memory).
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" : : "r"(bar), "r"(count) : "memory");
}

// One arrival that also announces `bytes` of asynchronous stores to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(bar), "r"(bytes)
               : "memory");
}

// One poll (it does not suspend the thread, so a bounded number of polls is
// a bounded time).
__device__ __forceinline__ bool mbar_test_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Store 4 bytes into another block's shared memory; the store itself
// counts 4 bytes off that block's barrier when it has landed.
__device__ __forceinline__ void st_async_u32(uint32_t remote_addr, uint32_t value,
                                             uint32_t remote_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               :
               : "r"(remote_addr), "r"(value), "r"(remote_bar)
               : "memory");
}

// Where word w (units 2w, 2w + 1 as bf16) of h lies in a buffer: within its
// group of 16 words (one pair of k-tiles) word r = tq + 4 s sits at 4 tq + s,
// so that lane tq's B-fragments of both k-tiles are 16 neighbouring bytes.
__device__ __forceinline__ int h_pos(int w) { return (w & ~15) | ((w & 3) << 2) | ((w >> 2) & 3); }

// k-tiles, k-tile pairs and k-tiles held in shared memory (an even number) at width G
__host__ __device__ inline int pt_ktiles(int G) { return (G + 15) / 16; }
__host__ __device__ inline int pt_pairs(int G) { return (pt_ktiles(G) + 1) / 2; }
__host__ __device__ inline int pt_smem_tiles(int G) {
  const int n = 2 * pt_pairs(G) - PT_KREG;
  return n > 0 ? n : 0;
}

__global__ void __launch_bounds__(PT_THREADS, 1)
lstm_pertarget_kernel(const float* __restrict__ xp,           // (T#, T, D, 4G)
                      const __nv_bfloat16* __restrict__ whh,  // (T#, D, G, 4G)
                      const float* __restrict__ h0,           // (T#, D, G)
                      const float* __restrict__ c0,           // (T#, D, G)
                      float* __restrict__ hs,                 // (T#, T, D, G)
                      float* __restrict__ hT,                 // (T#, D, G)
                      float* __restrict__ cT,                 // (T#, D, G)
                      int T, int D, int G, int U) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  const int r = blockIdx.y;  // chain = target * D + direction
  const int j = r / D;
  const int d = r % D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group: tile rows g and g + 8, B/C column g
  const int tq = lane & 3;
  const int G4 = 4 * G;
  const int KT = pt_ktiles(G);
  const int HW = pt_pairs(G) * 16;  // words of one h buffer
  const int KS = pt_smem_tiles(G);
  const int nu = max(0, min(U, G - rank * U));  // units this block owns (a multiple of 4)
  const int u0 = rank * U + warp * PT_WARP_UNITS;  // this warp's 4 units
  const bool active = warp * PT_WARP_UNITS < nu;

  // shared memory: 16 bytes of zeros, two barriers, two h buffers, W_hh tiles
  uint4* zero16 = reinterpret_cast<uint4*>(smem_raw);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_raw + 16);
  uint32_t* h_s = reinterpret_cast<uint32_t*>(smem_raw + 32);         // (2, HW)
  uint4* w_s = reinterpret_cast<uint4*>(smem_raw + 32 + 2 * HW * 4);  // (16 warps, KS, 32)

  // W_hh: tile row g is gate g / 4 of unit u0 + g % 4, row g + 8 gate g / 4 + 2.
  // k-tiles below PT_KREG into registers, the rest into shared memory (each
  // lane reads back what it wrote: no barrier, no bank conflict)
  uint4 wf[PT_KREG];
  {
    const unsigned short* wr =
        reinterpret_cast<const unsigned short*>(whh) + (size_t)r * G * G4;
    const int col_a = (g >> 2) * G + u0 + (g & 3);
    const int col_b = col_a + 2 * G;
#pragma unroll
    for (int kt = 0; kt < PT_KREG; ++kt) {
      wf[kt] = make_uint4(0u, 0u, 0u, 0u);
      if (active && kt < KT) wf[kt] = w_fragment(wr, kt, tq, col_a, col_b, G, G4);
    }
    for (int s = 0; s < KS; ++s) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (active && PT_KREG + s < KT) v = w_fragment(wr, PT_KREG + s, tq, col_a, col_b, G, G4);
      w_s[(warp * KS + s) * 32 + lane] = v;
    }
  }

  // h_{-1} = h0, bf16, permuted; words beyond G stay zero in both buffers
  if (tid == 0) {
    *zero16 = make_uint4(0u, 0u, 0u, 0u);
    mbar_init(smem_u32(bars), 1);
    mbar_init(smem_u32(bars + 1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 2 * HW; i += PT_THREADS) h_s[i] = 0u;
  __syncthreads();
  for (int w = tid; w < G / 2; w += PT_THREADS) {
    const float2 v = *reinterpret_cast<const float2*>(h0 + (size_t)r * G + 2 * w);
    h_s[h_pos(w)] = bf16_bits(v.x) | (bf16_bits(v.y) << 16);
  }
  // Step t >= 1 reads buffer t % 2 when barrier t % 2 has counted all of
  // h_{t-1}: one arrival of this block and 2 G bytes of stores from the
  // cluster.  The first use of each barrier is armed here, the later ones
  // by thread 0 when the use before has completed.
  const uint32_t h_bytes = 2u * (uint32_t)G;
  if (tid == 0) {
    if (T > 1) mbar_arrive_expect_tx(smem_u32(bars + 1), h_bytes);
    if (T > 2) mbar_arrive_expect_tx(smem_u32(bars), h_bytes);
  }

  // Lanes 4 g' and 4 (g' + 4), g' < 4, share hidden unit u0 + g': the lower
  // holds its gates i and g, the upper f and o; both carry c and h.
  const int u = u0 + (g & 3);
  const bool cell = active && tq == 0;
  const bool owner = cell && g < 4;
  const bool low = g < 4;
  const size_t x_step = (size_t)D * G4;
  const size_t h_step = (size_t)D * G;
  // this lane's two gates of x_proj: i | f at (g / 4) G, g | o at (g / 4 + 2) G
  const float* xp_r = xp + ((size_t)j * T * D + d) * G4 + (size_t)(g >> 2) * G + u;
  float* hs_r = hs + ((size_t)j * T * D + d) * G;
  float c = 0.0f, h_last = 0.0f, x0 = 0.0f, x1 = 0.0f;
  if (cell) {
    c = c0[(size_t)r * G + u];
    h_last = h0[(size_t)r * G + u];
    x0 = xp_r[0];
    x1 = xp_r[2 * (size_t)G];
    if (T > 1) {
      prefetch_l2(xp_r + x_step);
      prefetch_l2(xp_r + x_step + 2 * (size_t)G);
    }
    if (T > 2) {
      prefetch_l2(xp_r + 2 * x_step);
      prefetch_l2(xp_r + 2 * x_step + 2 * (size_t)G);
    }
  }

  // the four lanes of mma column 0 read h, the others 16 bytes of zeros
  const uint4* hq0 = (g == 0) ? reinterpret_cast<const uint4*>(h_s) + tq : zero16;
  const int hq_stride = (g == 0) ? 4 : 0;    // 16-byte words per pair of k-tiles
  const int hq_buf = (g == 0) ? HW / 4 : 0;  // 16-byte words per buffer
  const uint4* wt = w_s + warp * KS * 32 + lane;  // this lane's tiles, 32 apart

  // lane l sends word l / 16 of its warp's two (units u0 + 2 i, u0 + 2 i + 1)
  // to block l % 16 of the cluster: that block's h buffers and barriers
  const uint32_t dst_rank = (uint32_t)(lane & 15);
  // (a block that owns no unit reads no h and is sent none)
  const bool sends = active && (int)dst_rank < CL && (int)dst_rank * U < G;
  const uint32_t dst_h = map_to_rank(
      smem_u32(h_s + h_pos((u0 >> 1) + (lane >> 4))), sends ? dst_rank : (uint32_t)rank);
  const uint32_t dst_bar = map_to_rank(smem_u32(bars), sends ? dst_rank : (uint32_t)rank);

  // every block of the cluster is running, has filled its own h buffer and
  // set up its barriers before any block stores into it
  cluster.sync();

  for (int t = 0; t < T; ++t) {
    // the first pair of shared-memory tiles does not depend on h: ask for it
    // before the wait
    uint4 wa0 = make_uint4(0u, 0u, 0u, 0u), wa1 = wa0, wb0 = wa0, wb1 = wa0;
    if (active && KS > 0) {
      wa0 = wt[0];
      wa1 = wt[32];
    }
    if (active && t > 0) {
      // -- wait: all of h_{t-1} has landed in buffer t % 2 (every warp that
      // waits also sends, so none can fall a whole use of a barrier behind)
      const uint32_t bar = smem_u32(bars + (t & 1));
      const uint32_t parity = (uint32_t)((t - 1) >> 1) & 1u;
      unsigned polls = 0;
      while (!mbar_test_wait(bar, parity)) {
        if (++polls > PT_MAX_POLLS) __trap();
      }
      if (tid == 0 && t + 2 < T) mbar_arrive_expect_tx(bar, h_bytes);
    }
    if (active) {
      // -- product: gates = bf16(h_{t-1}) . W_hh, column 0 of the tile
      const uint4* hq = hq0 + (t & 1) * hq_buf;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = 0.0f;
      // the tiles in shared memory, a pair ahead of the mma that use them
      for (int s = 0; s < KS; s += 4) {
        if (s + 2 < KS) {
          wb0 = wt[(s + 2) * 32];
          wb1 = wt[(s + 3) * 32];
        }
        const uint4 b = hq[(PT_KREG / 2 + s / 2) * hq_stride];
        mma_m16n8k16(acc[0], wa0, b.x, b.y);
        mma_m16n8k16(acc[1], wa1, b.z, b.w);
        if (s + 4 < KS) {
          wa0 = wt[(s + 4) * 32];
          wa1 = wt[(s + 5) * 32];
        }
        if (s + 2 < KS) {
          const uint4 b2 = hq[(PT_KREG / 2 + s / 2 + 1) * hq_stride];
          mma_m16n8k16(acc[2], wb0, b2.x, b2.y);
          mma_m16n8k16(acc[3], wb1, b2.z, b2.w);
        }
      }
#pragma unroll
      for (int q = 0; q < PT_KREG / 2; ++q) {
        if (2 * q < KT) {
          const uint4 b = hq[q * hq_stride];
          mma_m16n8k16(acc[(q & 1) * 2], wf[2 * q], b.x, b.y);
          mma_m16n8k16(acc[(q & 1) * 2 + 1], wf[2 * q + 1], b.z, b.w);
        }
      }

      // -- cell: lane 4 g' activates gates i and g of its unit, lane
      // 4 (g' + 4) gates f and o; they swap the results and both update c, h
      const float v0 = __fadd_rn(__fadd_rn(acc[0][0], acc[1][0]), __fadd_rn(acc[2][0], acc[3][0]));
      const float v1 = __fadd_rn(__fadd_rn(acc[0][2], acc[1][2]), __fadd_rn(acc[2][2], acc[3][2]));
      const float a0 = sigmoidf_(__fadd_rn(x0, v0));  // i or f
      const float p1 = __fadd_rn(x1, v1);
      const float a1 = low ? tanhf(p1) : sigmoidf_(p1);  // g or o
      const float r0 = __shfl_xor_sync(0xffffffffu, a0, 16);
      const float r1 = __shfl_xor_sync(0xffffffffu, a1, 16);
      const float ig = low ? a0 : r0;
      const float gg = low ? a1 : r1;
      const float fg = low ? r0 : a0;
      const float og = low ? r1 : a1;
      c = __fmaf_rn(fg, c, __fmul_rn(ig, gg));
      h_last = __fmul_rn(og, tanhf(c));

      // -- exchange: lanes 0 and 8 pack units (u0, u0 + 1) and (u0 + 2,
      // u0 + 3); every lane stores its word into the next buffer of its block
      const uint32_t mine = bf16_bits(h_last);
      const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 4);  // unit u ^ 1
      const uint32_t word = __shfl_sync(0xffffffffu, mine | (other << 16), (lane >> 4) * 8);
      if (sends && t + 1 < T) {
        const uint32_t nb = (uint32_t)((t + 1) & 1);
        st_async_u32(dst_h + nb * (uint32_t)HW * 4u, word, dst_bar + nb * 8u);
      }
    }

    // -- while the stores fly: this step's output, the next step's input
    // (issued among the step's mma they slow the product down by more)
    if (owner) hs_r[(size_t)t * h_step + u] = h_last;
    if (cell && t + 1 < T) {
      const float* xn = xp_r + (size_t)(t + 1) * x_step;
      x0 = xn[0];
      x1 = xn[2 * (size_t)G];
      if (t + 3 < T) {
        prefetch_l2(xn + 2 * x_step);
        prefetch_l2(xn + 2 * x_step + 2 * (size_t)G);
      }
    }
  }

  if (owner) {
    hT[(size_t)r * G + u] = h_last;
    cT[(size_t)r * G + u] = c;
  }
  // no block leaves while another may still store into its shared memory
  cluster.sync();
}

int units_per_block(int G, int CL) {
  const int per = (G + CL - 1) / CL;
  return (per + PT_WARP_UNITS - 1) / PT_WARP_UNITS * PT_WARP_UNITS;
}

size_t smem_bytes(int G) {
  return 32 + (size_t)2 * pt_pairs(G) * 16 * 4 + (size_t)PT_WARPS * pt_smem_tiles(G) * 32 * 16;
}

// The launch configuration for clusters of CL blocks; attr must outlive cfg.
cudaError_t configure(int G, int R, int CL, cudaStream_t st, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  const size_t smem = smem_bytes(G);
  cudaError_t e = cudaFuncSetAttribute(lstm_pertarget_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)(smem > 48 * 1024 ? smem : 48 * 1024));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(lstm_pertarget_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           CL > 8 ? 1 : 0);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CL, R, 1);
  cfg->blockDim = dim3(PT_THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

cudaError_t smem_limit_of_device(int* limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace

// held[cl], cl = 1..16 (17 ints, host memory): how many clusters of cl
// blocks the current device holds at once for R chains of width G; 0 where
// a block would own more than 64 units, its share of W_hh does not fit its
// shared memory, or the device cannot place the cluster.
extern "C" int umx_lstm_pertarget_clusters(int G, int R, int* held) {
  if (G % 8 != 0 || G < 8 || R < 1) return (int)cudaErrorInvalidValue;
  int smem_limit = 0;
  cudaError_t e = smem_limit_of_device(&smem_limit);
  if (e != cudaSuccess) return (int)e;
  held[0] = 0;
  for (int cl = 1; cl <= PT_MAX_CLUSTER; ++cl) {
    held[cl] = 0;
    if (units_per_block(G, cl) > PT_MAX_UNITS || smem_bytes(G) > (size_t)smem_limit) continue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    int n = 0;
    if (configure(G, R, cl, nullptr, &cfg, attr) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, lstm_pertarget_kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();  // a cluster the device cannot place is not an error of the stream
      continue;
    }
    held[cl] = n;
  }
  return (int)cudaSuccess;
}

// K9: the whole layer in one launch on clusters of CL blocks that own U
// units each (the wrapper's choice among what umx_lstm_pertarget_clusters
// reports).  Returns the first CUDA error; cudaErrorInvalidConfiguration
// where the choice does not hold a chain.
extern "C" int umx_lstm_pertarget(const float* xp, const void* whh, const float* h0,
                                  const float* c0, float* hs, float* hT, float* cT, int T,
                                  int n_targets, int D, int G, int CL, int U, void* stream) {
  if (G % 8 != 0 || G < 8 || T < 1 || n_targets < 1 || D < 1) return (int)cudaErrorInvalidValue;
  int smem_limit = 0;
  cudaError_t e = smem_limit_of_device(&smem_limit);
  if (e != cudaSuccess) return (int)e;
  if (CL < 1 || CL > PT_MAX_CLUSTER || U != units_per_block(G, CL) || U > PT_MAX_UNITS ||
      smem_bytes(G) > (size_t)smem_limit)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(whh);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  e = configure(G, n_targets * D, CL, st, &cfg, attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, lstm_pertarget_kernel, xp, w, h0, c0, hs, hT, cT, T, D, G, U);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
