// Merged BLSTM recurrence for one LSTM layer, all chains at once:
// inference (K1) and the training forward with residuals (K4).
//
// Replaces: umx_tpu/ops/lstm_pallas.py:_make_merged_kernel (K1, reached via
// lstm_layer_pallas_merged) and _make_merged_train_kernel (K4, the forward
// half of the custom VJP of lstm_layer_pallas_merged_batched), the TPU
// kernels that run the recurrence of all targets x directions of one layer
// with every chain's W_hh resident in VMEM.
//
// Contract (same as the TPU kernels): R = T#*D independent chains, each
// with B batch rows; rows are chain-major, row = r*B + b.
//   xp  (T, R*B, 4G) f32   input projections + both biases, gate order i|f|g|o
//   whh (R, G, 4G)   bf16  hidden-hidden weights, contracted over G
//   h0, c0 (R*B, G)  f32
// Per step:  gates = xp_t + bf16(h_{t-1}) . whh[r]   (f32 accumulation)
//            c = sigmoid(f) c + sigmoid(i) tanh(g);  h = sigmoid(o) tanh(c)
// Outputs hs (T, R*B, G), hT (R*B, G) f32; c is updated in place and
// ends as cT.  K4 also writes the residuals of the backward (K5, K6 in
// lstm_train.cu): the ACTIVATED gates (T, R*B, 4G) and c (T, R*B, G) of
// every step.  The TPU kernel's per-time-block h/c inputs are an artefact
// of its time blocking; with no time blocking they are h0/c0.
//
// What bounds the recurrence on the H100: its T steps depend on each
// other, so a layer costs T times one step's latency; the bytes (xp and hs
// once, W_hh once) would take tens of microseconds.  A step needs the whole
// of W_hh (UMX-L: 8 x 512 x 2048 bf16 = 16.8 MB) against a few rows of h.
// Read from L2 every step, W_hh alone costs 5-30 us per step; kept on
// chip, a step is as long as its one exchange of h.
//
// The resident form (K1 and K4): ONE launch runs all T steps of all chains and up
// to 16 rows per chain.  A chain's W_hh (2 MiB at G = 512) fits neither one
// block's shared memory nor eight, but the card's register files hold
// 33 MB: a chain is split over ceil(G/32) blocks of 8 warps, each warp owns
// 4 hidden units (their 16 gate columns, ordered i|f|g|o x 4 units, are
// the 16 rows of an mma tile) and keeps its 16 x G slice of W_hh^T as
// mma.sync.m16n8k16 A-fragments in registers for the whole layer (128
// registers a thread at G = 512).  The batch rows are the mma's n = 8
// columns (two n-tiles for 9-16 rows): W_hh is never re-read, a row's sum
// has the same order at every B (one mma column per row, even and odd
// k-tiles in two accumulators), and at one row the tile is 8x wasted but
// free, since a step is bound by latency.  wgmma would need 64-row tiles
// and shared-memory operands for a product of a few hundred kFLOP per
// block; mma.sync with register operands is the fitting instruction.
// A warp's accumulator holds all four gates of its units after one
// shuffle, so every thread applies the cell for one (unit, row): c stays in
// its register; the next step's xp is loaded before this step's wait, from
// L2, where a prefetch two steps earlier has put it (a poll must not queue
// behind a load from device memory).
//
// The exchange of h between a chain's blocks goes through device memory
// (L2): UMX-L takes 8 chains x 16 blocks = 128 of the card's 132 SMs, more
// than thread-block clusters can tie together (a cluster lives in one GPC),
// so the launch is cooperative (all blocks co-resident, or it is refused)
// and a chain's blocks synchronise among themselves only; chains never
// wait for each other.  Each 64-bit word of the exchange buffer carries
// two bf16 values of h_t and, in its upper half, the step's tag: a
// consumer polls the words it needs until their tags match, so data and
// flag arrive in one store, with no fence, counter or second round trip
// (the scheme of NCCL's low-latency protocol).  The buffer is
// double-buffered by step parity: a block writes h_{t+1} only after it has
// read all of h_t, which every block wrote after reading all of h_{t-1}.
// A poll that lasts seconds traps instead of hanging the card.
//
// Rows beyond 16 per chain run as further launches of the same kernel on
// their row group (rows are independent), chains beyond what the card
// holds at once as further launches on their chain group; the wrapper
// plans both.  Requires G % 8 == 0.
//
// The wide forms (K1 and K4 above G 512, where a warp's 16 x G slice no
// longer fits 128 registers): the same kernel in another block form, a
// template on the warps a block has and the k-tiles a warp keeps in
// registers (resident_form below; ops/lstm_cuda.py:MERGED_BLOCK_FORMS
// mirrors the table and plans the launches).  A warp keeps its first KREG
// k-tiles in registers and the rest in shared memory, stored in the order
// the thread holds them: one 16-byte ld.shared a thread brings a tile in,
// four wavefronts a warp, what an ldmatrix.x4 of a row-major tile moves,
// without its bank conflicts or its address arithmetic.  So a step reads
// no W_hh from L2 at any width a chain's W_hh fits the chip in.  A block
// may have 10 warps (40 units), so that UMX-style R 8 chains of G 640
// (26.2 MB of bf16 W_hh) run as 8 x 16 blocks in one wave, or 6 or 4 warps
// with 40 register tiles, so that a wider chain spreads over more SMs; the
// h buffers are dynamic shared memory, sized by G.  The shared tiles are
// summed in the same order as the register tiles (even k-tiles into one
// accumulator, odd into the other, ascending k), so the sum of a (unit,
// row) has one order whatever the block form, the rows or the chains
// beside it: a row is bit-equal to itself run alone, and the wide K4 gives
// the wide K1's bits.  The exchange, its tags, the double buffer, the
// cooperative launch and the poll trap are K1's.
//
// K4 is the same kernel with a compile-time flag: the thread that owns
// (unit, row) after the gate shuffle holds the four activated gates and c
// in registers and stores them, after the step's h has gone to the
// exchange, so that no consumer's poll waits behind them.  The mma order
// and the cell are K1's, so hs, hT and cT are K1's bits; rows beyond 16 and
// chains beyond the card's capacity are further launches, as for K1, and
// there is no upper B.
//
// Measured on an H100 80GB HBM3 at 700 W (T = 256, R = 8, B = 16, G = 512):
// K1 1.65 ms per layer, K4 1.74 ms: the 0.09 ms between them is what the
// 335 MB of residuals cost at the card's memory rate, so staging them
// through shared memory into full lines has nothing left to gain (K4's
// earlier form, one grid per step with W_hh re-read from L2, took 8.71 ms).
// 186 / 212 registers (K1, one / two n-tiles), 183 / 212 (K4), no spills.
// The 10-warp wide form at G 640 (T 2584, R 8, B 1): 7.29 ms, 2.82 us a step
// (the streaming form it replaces: 23.07 ms); at G 1024 (8 warps, two chain
// groups of four) 18.29 ms (72.07); K4 at G 640, T 256, B 16: 2.23 ms (9.45).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// ---------------------------------------------------------------------------
// K1: the resident recurrence
// ---------------------------------------------------------------------------

constexpr int RES_KT = 32;                // k-tiles of 16 a warp of K1's form (8 warps) holds
constexpr int RES_ROWS = 16;              // rows per chain in one launch
constexpr int RES_HPAD = 4;               // words of padding per h row (bank spread)
constexpr int RES_POLL = 4;               // exchange words a thread has in flight
constexpr unsigned RES_MAX_POLLS = 1u << 24;

// The block forms: warps a block, and the k-tiles a warp keeps in registers
// (4 a tile); its further k-tiles sit in shared memory.  An SM's four
// partitions have 16 Ki registers each and a block's warps are spread over
// them, so a thread of a block of 8, 6 or 4 warps may have 255 registers and
// one of 10 warps (3 on a partition) 168.  Beside its tiles a thread uses
// about 84 (K1 at two n-tiles: 212 of which 128 are tiles): 8 warps keep 32
// tiles, 6 and 4 keep 40, 10 keep 20.  0: no such form.
__host__ __device__ constexpr int resident_kreg(int warps) {
  return warps == 8 ? RES_KT : warps == 10 ? 20 : (warps == 6 || warps == 4) ? 40 : 0;
}

// Dynamic shared memory of a block of `warps` warps at width G and a row
// tile of `rows` (8 or 16): h of two steps (rows x (ceil(G/16) 8 + pad)
// words each) and the k-tiles beyond the registers' (16 bytes a thread
// each).  K1's form up to G 512 has no shared tiles.
size_t resident_smem(int G, int warps, int rows) {
  const int kt = (G + 15) / 16;
  const int ks = kt > resident_kreg(warps) ? kt - resident_kreg(warps) : 0;
  return sizeof(uint32_t) * 2 * rows * (kt * 8 + RES_HPAD) + (size_t)16 * ks * 32 * warps;
}

__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// W_hh[k][col] and W_hh[k+1][col] as one register (low half: k); 0 beyond G.
__device__ __forceinline__ uint32_t w_pair(const unsigned short* __restrict__ w, int k, int col,
                                           int G, int G4) {
  if (k >= G) return 0u;  // G is even, so k < G implies k + 1 < G
  const uint32_t lo = w[(size_t)k * G4 + col];
  const uint32_t hi = w[(size_t)(k + 1) * G4 + col];
  return lo | (hi << 16);
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" : : "l"(p));
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(x));
}

// grid = (ceil(G / (4 WARPS)), chains of this launch), 32 WARPS threads,
// dynamic shared memory resident_smem(G, WARPS, 8 NT).  NT n-tiles of 8
// rows.  hx: exchange words (R, 2, RES_ROWS, G/2), zeroed by the caller
// before the layer's first launch; tag0 makes the tags of this launch
// unique among the launches that share the buffer.  RESID (K4): also write
// the activated gates (T, RB, 4G) and c (T, RB, G) of every step.
template <int NT, bool RESID, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, 1)
lstm_resident_kernel(const float* __restrict__ xp,          // (T, RB, 4G)
                     const __nv_bfloat16* __restrict__ whh,  // (R, G, 4G)
                     const float* __restrict__ h0,           // (RB, G)
                     float* __restrict__ c,                  // (RB, G), in place
                     float* __restrict__ hs,                 // (T, RB, G)
                     float* __restrict__ hT,                 // (RB, G)
                     float* __restrict__ gates,              // (T, RB, 4G), RESID only
                     float* __restrict__ cs,                 // (T, RB, G), RESID only
                     unsigned long long* hx, int T, int R, int B, int b0, int nb, int G, int r0,
                     unsigned tag0) {
  constexpr int THREADS = 32 * WARPS;
  constexpr int UNITS = 4 * WARPS;  // hidden units owned by one block
  constexpr int KREG = resident_kreg(WARPS);
  static_assert(KREG % 2 == 0, "the shared tiles start on an even k-tile");
  extern __shared__ __align__(16) uint32_t res_smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // mma group: tile rows g and g + 8, B/C column g
  const int tq = lane & 3;
  const int r = r0 + blockIdx.y;
  const int G4 = 4 * G;
  const int GH = G / 2;
  const int RB = R * B;
  const int KT = (G + 15) / 16;
  const int HSW = KT * 8 + RES_HPAD;  // words per h row; HSW % 32 in {4, 12, 20, 28}
  const int HBUF = NT * 8 * HSW;
  // bf16 h_{t-1} of this chain's rows, two steps: (2, NT*8 rows, HSW words);
  // then the k-tiles beyond KREG: (KT - KREG, WARPS, 32 lanes) x 16 bytes
  uint32_t* h_s = res_smem;
  uint4* w_s = reinterpret_cast<uint4*>(res_smem + 2 * HBUF);
  const int u0 = blockIdx.x * UNITS + warp * 4;  // this warp's 4 units
  const bool active = u0 < G;  // G % 4 == 0: a warp's units are all in or all out

  // Tile row g is gate (g / 4) of unit u0 + g % 4, row g + 8 gate (g / 4) + 2.
  uint32_t wf[KREG][4];
  {
    const unsigned short* wr =
        reinterpret_cast<const unsigned short*>(whh) + (size_t)r * G * G4;
    const int col_a = (g >> 2) * G + u0 + (g & 3);
    const int col_b = col_a + 2 * G;
#pragma unroll
    for (int kt = 0; kt < KREG; ++kt) {
      wf[kt][0] = wf[kt][1] = wf[kt][2] = wf[kt][3] = 0u;
      if (active && kt < KT) {
        const int k = kt * 16 + 2 * tq;
        wf[kt][0] = w_pair(wr, k, col_a, G, G4);
        wf[kt][1] = w_pair(wr, k, col_b, G, G4);
        wf[kt][2] = w_pair(wr, k + 8, col_a, G, G4);
        wf[kt][3] = w_pair(wr, k + 8, col_b, G, G4);
      }
    }
    // the thread's own slots: no other thread reads them, so no barrier
    if (active) {
      for (int kt = KREG; kt < KT; ++kt) {
        const int k = kt * 16 + 2 * tq;
        w_s[((kt - KREG) * WARPS + warp) * 32 + lane] =
            make_uint4(w_pair(wr, k, col_a, G, G4), w_pair(wr, k, col_b, G, G4),
                       w_pair(wr, k + 8, col_a, G, G4), w_pair(wr, k + 8, col_b, G, G4));
      }
    }
  }

  // After the gate shuffle a thread owns unit u, row (j*8 + n) of the group.
  const int u = u0 + (g & 3);
  const int n = 2 * tq + (g >> 2);
  bool valid[NT];
  size_t row[NT];
  float cc[NT], hl[NT], xg[NT][4], xn[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    valid[j] = active && (j * 8 + n) < nb;
    row[j] = (size_t)r * B + b0 + j * 8 + n;
    cc[j] = 0.0f;
    hl[j] = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) xg[j][q] = xn[j][q] = 0.0f;
    if (valid[j]) {
      cc[j] = c[row[j] * G + u];
      hl[j] = h0[row[j] * G + u];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* x0 = xp + row[j] * G4 + (size_t)q * G + u;
        xg[j][q] = *x0;
        if (T > 1) prefetch_l2(x0 + (size_t)RB * G4);
        if (T > 2) prefetch_l2(x0 + 2 * (size_t)RB * G4);
      }
    }
  }

  // Rows beyond nb and k beyond G stay zero in both buffers.
  for (int i = tid; i < 2 * HBUF; i += THREADS) h_s[i] = 0u;
  __syncthreads();
  for (int i = tid; i < nb * GH; i += THREADS) {
    const int b = i / GH;
    const int kp = i % GH;
    const float2 v =
        *reinterpret_cast<const float2*>(h0 + ((size_t)r * B + b0 + b) * G + 2 * kp);
    h_s[b * HSW + kp] = bf16_bits(v.x) | (bf16_bits(v.y) << 16);
  }

  const size_t x_step = (size_t)RB * G4;
  const size_t h_step = (size_t)RB * G;
  unsigned long long* hx_r = hx + (size_t)r * 2 * RES_ROWS * GH;

  for (int t = 0; t < T; ++t) {
    uint32_t* hb = h_s + (t & 1) * HBUF;
    // xp of the next step, before this step's wait; a prefetch two steps
    // earlier has put it into L2, so that no poll queues behind a load
    // from device memory
    if (t + 1 < T) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (valid[j]) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* x1 = xp + (size_t)(t + 1) * x_step + row[j] * G4 + (size_t)q * G + u;
            xn[j][q] = *x1;
            if (t + 3 < T) prefetch_l2(x1 + 2 * x_step);
          }
        }
      }
    }

    if (t > 0) {
      // h_{t-1} of every unit of the chain: poll each word until it
      // carries this step's tag
      const volatile unsigned long long* src = hx_r + (size_t)(t & 1) * RES_ROWS * GH;
      const unsigned want = tag0 + (unsigned)t;
      const int nw = nb * GH;
      // Where a block has as many threads as G has unit pairs (K1 at
      // G = 512, 10 warps at 640), a thread's words of a batch are one unit
      // pair of RES_POLL rows, all written by one producer warp: it spins
      // on the first alone, so that waiting costs one load a thread (more
      // loads in flight while waiting slow every block's exchange down),
      // and asks for the others when that one is in.
      for (int i0 = tid; i0 < nw; i0 += RES_POLL * THREADS) {
        unsigned long long v[RES_POLL];
        unsigned polls = 0;
        v[0] = src[i0];
        while ((unsigned)(v[0] >> 32) != want) {
          if (++polls > RES_MAX_POLLS) __trap();
          v[0] = src[i0];
        }
#pragma unroll
        for (int e = 1; e < RES_POLL; ++e) {
          const int i = i0 + e * THREADS;
          v[e] = i < nw ? src[i] : 0ull;
        }
#pragma unroll
        for (int e = 0; e < RES_POLL; ++e) {
          const int i = i0 + e * THREADS;
          if (i < nw) {
            while ((unsigned)(v[e] >> 32) != want) {
              if (++polls > RES_MAX_POLLS) __trap();
              v[e] = src[i];
            }
            hb[(i / GH) * HSW + i % GH] = (uint32_t)v[e];
          }
        }
      }
    }
    __syncthreads();

    if (active) {
      float acc[NT][2][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][a][e] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < KREG; ++kt) {
        if (kt < KT) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint32_t* hp = hb + (j * 8 + g) * HSW + kt * 8 + tq;
            mma_m16n8k16(acc[j][kt & 1], wf[kt], hp[0], hp[4]);
          }
        }
      }
      // the k-tiles in shared memory, two at a time (KREG is even): the
      // even one into the first accumulator, the odd one into the second,
      // as the register tiles
      for (int kt = KREG; kt < KT; kt += 2) {
        const uint4 a4 = w_s[((kt - KREG) * WARPS + warp) * 32 + lane];
        const uint32_t fa[4] = {a4.x, a4.y, a4.z, a4.w};
        const bool odd = kt + 1 < KT;
        uint4 b4 = make_uint4(0u, 0u, 0u, 0u);
        if (odd) b4 = w_s[((kt + 1 - KREG) * WARPS + warp) * 32 + lane];
        const uint32_t fb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t* hp = hb + (j * 8 + g) * HSW + kt * 8 + tq;
          mma_m16n8k16(acc[j][0], fa, hp[0], hp[4]);
          if (odd) mma_m16n8k16(acc[j][1], fb, hp[8], hp[12]);
        }
      }

#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[j][0][e] + acc[j][1][e];
        // lanes g < 4 hold gates i, g of column pair (2tq, 2tq+1), lanes
        // g >= 4 gates f, o of the same unit: the lower keeps column 2tq,
        // the upper 2tq + 1, and they swap the other column's values
        const bool low = g < 4;
        const float s0 = low ? v[1] : v[0];
        const float s1 = low ? v[3] : v[2];
        const float q0 = __shfl_xor_sync(0xffffffffu, s0, 16);
        const float q1 = __shfl_xor_sync(0xffffffffu, s1, 16);
        const float pi = low ? v[0] : q0;
        const float pg = low ? v[2] : q1;
        const float pf = low ? q0 : v[1];
        const float po = low ? q1 : v[3];
        const float ig = sigmoidf_(__fadd_rn(xg[j][0], pi));
        const float fg = sigmoidf_(__fadd_rn(xg[j][1], pf));
        const float gg = tanhf(__fadd_rn(xg[j][2], pg));
        const float og = sigmoidf_(__fadd_rn(xg[j][3], po));
        // explicit roundings: the same bits whatever the compiler makes of
        // the code around them (a row must not depend on NT)
        cc[j] = __fmaf_rn(fg, cc[j], __fmul_rn(ig, gg));
        hl[j] = __fmul_rn(og, tanhf(cc[j]));
        const uint32_t mine = bf16_bits(hl[j]);
        const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 4);  // unit u ^ 1
        if (valid[j]) {
          if (t + 1 < T && (g & 1) == 0) {
            volatile unsigned long long* dst =
                hx_r + ((size_t)((t + 1) & 1) * RES_ROWS + j * 8 + n) * GH + (u >> 1);
            *dst = ((unsigned long long)(tag0 + (unsigned)t + 1u) << 32) |
                   (unsigned long long)(mine | (other << 16));
          }
          hs[(size_t)t * h_step + row[j] * G + u] = hl[j];
          if (RESID) {
            // after the exchange store: four neighbouring units a gate
            float* gr = gates + (size_t)t * x_step + row[j] * G4 + u;
            gr[0] = ig;
            gr[(size_t)G] = fg;
            gr[2 * (size_t)G] = gg;
            gr[3 * (size_t)G] = og;
            cs[(size_t)t * h_step + row[j] * G + u] = cc[j];
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) xg[j][q] = xn[j][q];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (valid[j]) {
      hT[row[j] * G + u] = hl[j];
      c[row[j] * G + u] = cc[j];
    }
  }
}

using resident_fn = void (*)(const float*, const __nv_bfloat16*, const float*, float*, float*,
                             float*, float*, float*, unsigned long long*, int, int, int, int,
                             int, int, int, unsigned);

template <bool RESID, int WARPS>
resident_fn resident_kernel_nt(int nb) {
  return nb > 8 ? lstm_resident_kernel<2, RESID, WARPS> : lstm_resident_kernel<1, RESID, WARPS>;
}

// The instantiation for a block of `warps` warps, nb rows per chain, with
// or without residuals; nullptr for a block form the table has not.
resident_fn resident_kernel(bool resid, int warps, int nb) {
  switch (warps) {
    case 4: return resid ? resident_kernel_nt<true, 4>(nb) : resident_kernel_nt<false, 4>(nb);
    case 6: return resid ? resident_kernel_nt<true, 6>(nb) : resident_kernel_nt<false, 6>(nb);
    case 8: return resid ? resident_kernel_nt<true, 8>(nb) : resident_kernel_nt<false, 8>(nb);
    case 10: return resid ? resident_kernel_nt<true, 10>(nb) : resident_kernel_nt<false, 10>(nb);
    default: return nullptr;
  }
}

// The kernel for (resid, warps, nb) with the dynamic shared memory it asks
// for at width G allowed; cudaErrorInvalidValue for a form it has not, and
// the error of the attribute where the device has not that much.
cudaError_t resident_setup(bool resid, int warps, int nb, int G, resident_fn* fn, size_t* smem) {
  *fn = resident_kernel(resid, warps, nb);
  if (*fn == nullptr) return cudaErrorInvalidValue;
  *smem = resident_smem(G, warps, nb > 8 ? 16 : 8);
  return cudaFuncSetAttribute((const void*)*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

cudaError_t resident_launch(bool resid, const float* xp, const void* whh, const float* h0, float* c,
                            float* hs, float* hT, float* gates, float* cs, void* hx, int T, int R,
                            int B, int G, int warps, int r0, int nr, int b0, int nb, unsigned tag0,
                            void* stream) {
  if (G < 8 || G % 8 != 0 || T < 1 || B < 1 || nb < 1 || nb > RES_ROWS || b0 < 0 ||
      b0 + nb > B || nr < 1 || r0 < 0 || r0 + nr > R)
    return cudaErrorInvalidValue;
  resident_fn fn = nullptr;
  size_t smem = 0;
  cudaError_t e = resident_setup(resid, warps, nb, G, &fn, &smem);
  if (e != cudaSuccess) return e;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(whh);
  unsigned long long* hxp = static_cast<unsigned long long*>(hx);
  void* args[] = {&xp, &w,  &h0, &c, &hs, &hT, &gates, &cs,  &hxp,
                  &T,  &R,  &B,  &b0, &nb, &G, &r0,    &tag0};
  const int units = 4 * warps;
  const dim3 grid((G + units - 1) / units, nr);
  e = cudaLaunchCooperativeKernel((const void*)fn, grid, dim3(32 * warps), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* umx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The device's figures the wide forms are planned from
// (ops/lstm_cuda.py:merged_wide_plan): SMs, the shared memory a block may
// ask for (opt-in), 32-bit registers an SM.
extern "C" int umx_device_limits(int* sms, int* smem_per_block, int* regs_per_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(regs_per_sm, cudaDevAttrMaxRegistersPerMultiprocessor, dev);
}

// A block form's layout on the current device: for K1 (resid = 0) or K4,
// blocks of `warps` warps (4, 6, 8 or 10) at width G and a row tile of
// `rows` (8 or 16): `smem`, the dynamic shared memory a block asks for,
// and `blocks`, how many such blocks the device holds at once (what a
// cooperative launch may ask for; 0 where a block's shared memory is more
// than the device allows).  Returns the first CUDA error;
// cudaErrorInvalidConfiguration where the device has no cooperative launch.
extern "C" int umx_lstm_merged_layout(int G, int resid, int warps, int rows, int* blocks,
                                      int* smem) {
  int dev = 0, sms = 0, coop = 0, smem_max = 0, per_sm = 0;
  *blocks = 0;
  *smem = 0;
  if (G < 8 || G % 8 != 0 || (rows != 8 && rows != RES_ROWS) ||
      resident_kernel(resid != 0, warps, rows) == nullptr)
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
  *smem = (int)resident_smem(G, warps, rows);
  if (*smem > smem_max) return (int)cudaSuccess;
  resident_fn fn = nullptr;
  size_t bytes = 0;
  e = resident_setup(resid != 0, warps, rows, G, &fn, &bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)fn, 32 * warps, bytes);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  return (int)cudaSuccess;
}

// K1 and K4: one launch, all T steps of chains [r0, r0 + nr) and rows
// [b0, b0 + nb) of each, nb <= 16, in the block form of `warps` warps (8:
// K1's form; 10, 6, 4: the wide forms).  `c` holds c0 on entry and cT on
// return for those rows.  With gates (T, RB, 4G) and cs (T, RB, G) both
// given, K4: also the residuals of those rows.  `hx` is the exchange
// buffer, R * 2 * 16 * (G/2) 64-bit words, zeroed before the layer's first
// launch; `tag0` is the number of steps earlier launches ran on the same
// buffer.  Returns the first CUDA error.
extern "C" int umx_lstm_merged(const float* xp, const void* whh, const float* h0, float* c,
                               float* hs, float* hT, float* gates, float* cs, void* hx, int T,
                               int R, int B, int G, int warps, int r0, int nr, int b0, int nb,
                               unsigned tag0, void* stream) {
  if ((gates == nullptr) != (cs == nullptr)) return (int)cudaErrorInvalidValue;
  return (int)resident_launch(gates != nullptr, xp, whh, h0, c, hs, hT, gates, cs, hx, T, R, B, G,
                              warps, r0, nr, b0, nb, tag0, stream);
}
