// The float32 BLSTM recurrence of one layer, all chains at once (K10).
//
// Replaces no Pallas kernel: it ports the JAX package's portable
// recurrence, the lax.scan step of umx_tpu/models/umx.py:_bilstm_layer
// (lstm_impl="scan", what the JAX package runs on every backend but the
// TPU).  A plain torch.bmm loop would put T launches a layer on the card's
// main path; this is one launch a layer.
//
// Contract (K1's layouts, lstm_merged.cu): R = T#*D independent chains,
// each with B batch rows; rows are chain-major, row = r*B + b.
//   xp  (T, R*B, 4G) f32   input projections + both biases, gate order i|f|g|o
//   whh (R, G, 4G)   f32 or bf16 (its stored dtype, upcast in registers;
//                    a bf16 value is exact in f32), contracted over G
//   h0, c0 (R*B, G)  f32
// Per step:  gates = xp_t + h_{t-1} . whh[r]   (h unrounded f32, f32 FMA on
//            the CUDA cores: no TF32, no bf16 operand)
//            c = sigmoid(f) c + sigmoid(i) tanh(g);  h = sigmoid(o) tanh(c)
// with precise expf / tanhf.  Outputs hs (T, R*B, G), hT (R*B, G) f32; c is
// updated in place and ends as cT.  Any G >= 1 and any B.
//
// With the compile-time flag RESID (umx_lstm_scan_train, the forward of
// training, as K4 is K1 with a flag in lstm_merged.cu) the thread that owns
// a (unit, row) also stores that step's activated gates i|f|g|o into
// gates (T, R*B, 4G) f32 and c into cs (T, R*B, G) f32: the residuals of
// the reverse sweep (lstm_scan_train.cu).  The arithmetic is the same, so
// hs, hT and cT are the bits of the form without the flag.
//
// What bounds it on the H100: the T steps depend on each other, and a step
// needs the whole of W_hh against a few rows of h.  At UMX-L in float32
// W_hh is 8 x 512 x 2048 x 4 B = 33.5 MB: under the 50 MB L2, but not under
// the register file alone (K1's answer, for bf16 W_hh at G <= 512).  Read
// from L2 every step it costs ~4 us a step; the bytes of the layer (xp, hs
// and W_hh once) would take ~0.07 ms.  So the resident form keeps W_hh on
// the chip, split between registers and shared memory, and a step costs
// its FMAs (2 x 4G x G per row, 4 us at 16 rows on the CUDA cores) plus one
// exchange of h.
//
// Two forms, K1's launch (lstm_merged.cu): ONE cooperative launch runs all T
// steps of all chains and up to 16 rows per chain; a chain is split over
// ceil(G/32) blocks, and a block owns 32 hidden units, that is 128 gate
// columns (i|f|g|o x 32 units).  The wrapper picks the form from G alone
// (ops/lstm_cuda.py:scan_form), before the launch.
//
// The resident form (G <= 512, W_hh f32 or bf16).  A block's share of W_hh,
// 128 columns x G rows, is loaded once, upcast to f32, and stays on the chip
// for all T steps: 256 KiB at G 512, split between registers and shared
// memory, 88 + 168 KiB up to 4 rows and 72 + 184 KiB at 8 and 16, where
// the accumulators need more registers (an SM has 256 KiB of registers and
// 227 KiB of shared memory; 8 x 16 blocks fill 128 of the H100's 132 SMs).
// A block has 256
// threads; lane l of warp w owns units 4 w + 2 (l / 16) and the next (all
// eight of their gate columns) and k part p = l % 16, the k = p, p + 16,
// ... of the product, with W of its first rs_kreg iterations in registers
// and of the rest in shared memory.  Each iteration reads up to 8 rows of
// h at one k (a quarter-warp reads eight neighbouring k at padded row
// strides, conflict-free) and does 8 x rows FMAs: each W value feeds a
// row's FMA per row and each h value eight, so shared memory carries half
// the bytes the FMAs would need with one unit a lane.  16 rows go in two
// passes of 8 (the accumulators of 2 units x 4 gates x 8 rows fill what
// W leaves of the registers).  The parts' sums meet by warp shuffles in
// one tree over the half-warp, scattering the units and then the rows over
// the sixteen lanes as they go, so each lane ends with all four gates of
// one (unit, row) a pass and applies the cell in registers: no round trip
// through shared memory.  Two barriers a step: h is in, h has been read
// (one buffer of h leaves shared memory for W, and the registers W leaves
// hold the accumulators without spilling).  The step reads no W_hh from
// memory.
//
// The streaming form (G > 512, where a chain group's W_hh would not fit
// the chip, e.g. 52.4 MB at G 640, R 8; and by name).  512 threads; each
// step a thread owns one column and a quarter of the k range: it streams
// its column of W_hh from L2 or device memory (a warp reads 32 neighbouring
// columns of one k, one 128-byte line in float32) and keeps one f32
// accumulator per row, fed from h in shared memory (one broadcast a k);
// the four quarters are summed in a fixed order through shared memory.
// Then a thread per (unit, row) applies the cell.
//
// The wide merged form (umx_lstm_merged_wide; K1 and K4 above G 512, where a
// warp's slice of bf16 W_hh no longer fits lstm_merged.cu's registers) is
// the streaming form with the compile-time flag ROUND_H and W_hh in bf16:
// h is rounded to bf16 (round to nearest even) where it enters the product
// (h0 and each polled word, into shared memory), so every product is
// bf16(h) x bf16(W_hh), exact in f32, summed in f32: K1's function
// (lstm_merged.cu).  hs, hT, cT and the exchange carry the unrounded f32 h,
// as K1 publishes it; only the product's operand is rounded.
//
// In either form a (unit, row) sum has one order, set by G and the form
// alone, never by B, by the rows or chains beside it, or by the row group
// it falls in: a row is bit-equal to itself run alone.  The thread that
// applies the cell keeps c and h in registers and publishes h_t.
//
// The exchange of h between a chain's blocks goes through L2, as K1's:
// each 64-bit word carries one f32 value of h_t and, in its upper half, the
// step's tag; a consumer polls the words it needs until their tags match,
// so data and flag arrive in one store, with no fence.  The buffer is
// double-buffered by step parity (a block writes h_{t+1} only after it has
// read all of h_t, which every block wrote after reading all of h_{t-1}).
// The launch is cooperative (all blocks co-resident, or it is refused);
// chains never wait for each other.  A poll that lasts seconds traps
// instead of hanging the card.  Rows beyond one launch's group and chains
// beyond what the card holds at once are further launches of the same
// kernel, planned by the wrapper; tag0 keeps the tags of a launch unique
// among the launches that share the buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SCAN_THREADS = 512;
constexpr int SCAN_UNITS = 32;                         // hidden units a block owns
constexpr int SCAN_COLS = 4 * SCAN_UNITS;              // its gate columns
constexpr int SCAN_PARTS = SCAN_THREADS / SCAN_COLS;   // k quarters
constexpr int SCAN_ROWS = 16;                          // rows per chain in one launch, at most
constexpr int SCAN_POLL = 4;                           // exchange words a thread has in flight
constexpr int SCAN_UNROLL = 8;                         // W_hh loads a thread has in flight
constexpr unsigned SCAN_MAX_POLLS = 1u << 24;

// the resident form
constexpr int RS_THREADS = 256;
constexpr int RS_PARTS = 16;                   // k parts, one a lane of 16
constexpr int RS_KMAX = 32;                    // k iterations of a part at most
constexpr int RS_G_MAX = RS_PARTS * RS_KMAX;   // 512
constexpr int RS_PASS = 8;                     // rows of one pass over W

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// h as the product takes it: rounded to bf16 and back (round to nearest
// even, as torch's .to(torch.bfloat16)) in the wide merged form, else as it is
template <bool ROUND_H>
__device__ __forceinline__ float operand(float x) {
  if constexpr (ROUND_H) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" : : "l"(p));
}

__device__ __forceinline__ float load_w(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_w(const __nv_bfloat16* p) {
  // a bf16 value is the upper half of its f32 value: exact
  return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// acc[b] += w * h[b] for the RT rows of one k, h k-major in shared memory
template <int RT>
__device__ __forceinline__ void fma_rows(float (&acc)[RT], float w, const float* hk) {
  if constexpr (RT % 4 == 0) {
#pragma unroll
    for (int b = 0; b < RT; b += 4) {
      const float4 h4 = *reinterpret_cast<const float4*>(hk + b);
      acc[b] = __fmaf_rn(w, h4.x, acc[b]);
      acc[b + 1] = __fmaf_rn(w, h4.y, acc[b + 1]);
      acc[b + 2] = __fmaf_rn(w, h4.z, acc[b + 2]);
      acc[b + 3] = __fmaf_rn(w, h4.w, acc[b + 3]);
    }
  } else {
#pragma unroll
    for (int b = 0; b < RT; ++b) acc[b] = __fmaf_rn(w, hk[b], acc[b]);
  }
}

// grid = (ceil(G/32), chains of this launch), SCAN_THREADS threads.  RT:
// the row tile, a power of two >= nb.  Dynamic shared memory:
// h (G x RT f32, k-major) and the quarters' sums (SCAN_PARTS x RT x 128 f32).
// hx: exchange words (R, 2, SCAN_ROWS, G), zeroed before the layer's first
// launch.  ROUND_H: the wide merged form (h rounded to bf16 for the product).
template <typename W, int RT, bool RESID, bool ROUND_H = false>
__global__ void __launch_bounds__(SCAN_THREADS, 2)
lstm_scan_kernel(const float* __restrict__ xp,   // (T, RB, 4G)
                 const W* __restrict__ whh,      // (R, G, 4G)
                 const float* __restrict__ h0,   // (RB, G)
                 float* __restrict__ c,          // (RB, G), in place
                 float* __restrict__ hs,         // (T, RB, G)
                 float* __restrict__ hT,         // (RB, G)
                 float* __restrict__ gates,      // (T, RB, 4G), RESID only
                 float* __restrict__ cs,         // (T, RB, G), RESID only
                 unsigned long long* hx, int T, int R, int B, int b0, int nb, int G, int r0,
                 unsigned tag0) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                      // h_s[k * RT + b]
  float* part_s = smem + (size_t)G * RT;  // part_s[(p * RT + b) * SCAN_COLS + col]

  const int tid = threadIdx.x;
  const int r = r0 + blockIdx.y;
  const int u0 = blockIdx.x * SCAN_UNITS;
  const int G4 = 4 * G;
  const size_t RB = (size_t)R * B;

  // the dot product's role: column (gate q, unit u0 + j), k quarter `part`
  const int col = tid % SCAN_COLS;
  const int part = tid / SCAN_COLS;
  const int j = col % SCAN_UNITS;
  const bool col_ok = u0 + j < G;
  const W* wcol = whh + (size_t)r * G * G4 + (size_t)(col / SCAN_UNITS) * G + u0 + j;
  const int chunk = (G + SCAN_PARTS - 1) / SCAN_PARTS;
  const int k_lo = min(G, part * chunk);
  const int k_hi = min(G, k_lo + chunk);

  // the cell's role: unit u0 + cj of row cb
  const int cj = tid % SCAN_UNITS;
  const int cb = tid / SCAN_UNITS;
  const int u = u0 + cj;
  const bool cell_ok = cb < nb && u < G;
  const size_t row = (size_t)r * B + b0 + cb;
  float cc = 0.0f, hl = 0.0f;
  if (cell_ok) {
    cc = c[row * G + u];
    hl = h0[row * G + u];
  }

  // rows beyond nb stay zero
  for (int i = tid; i < G * RT; i += SCAN_THREADS) h_s[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < nb * G; i += SCAN_THREADS) {
    const int b = i / G;
    const int k = i - b * G;
    h_s[k * RT + b] = operand<ROUND_H>(h0[((size_t)r * B + b0 + b) * G + k]);
  }

  unsigned long long* hx_r = hx + (size_t)r * 2 * SCAN_ROWS * G;

  for (int t = 0; t < T; ++t) {
    // this step's xp does not depend on h: load it before the wait
    float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (cell_ok) {
      const float* x = xp + ((size_t)t * RB + row) * G4 + u;
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = x[(size_t)q * G];
    }

    if (t > 0) {
      // h_{t-1} of every unit of the chain's rows: poll each word until it
      // carries this step's tag
      const volatile unsigned long long* src = hx_r + (size_t)(t & 1) * SCAN_ROWS * G;
      const unsigned want = tag0 + (unsigned)t;
      const int nw = nb * G;
      for (int i0 = tid; i0 < nw; i0 += SCAN_POLL * SCAN_THREADS) {
        unsigned long long v[SCAN_POLL];
#pragma unroll
        for (int e = 0; e < SCAN_POLL; ++e) {
          const int i = i0 + e * SCAN_THREADS;
          v[e] = i < nw ? src[i] : 0ull;
        }
        unsigned polls = 0;
#pragma unroll
        for (int e = 0; e < SCAN_POLL; ++e) {
          const int i = i0 + e * SCAN_THREADS;
          if (i < nw) {
            while ((unsigned)(v[e] >> 32) != want) {
              if (++polls > SCAN_MAX_POLLS) __trap();
              v[e] = src[i];
            }
            const int b = i / G;
            h_s[(i - b * G) * RT + b] = operand<ROUND_H>(__uint_as_float((uint32_t)v[e]));
          }
        }
      }
    }
    __syncthreads();

    // this thread's column against its quarter of h, in ascending k
    float acc[RT];
#pragma unroll
    for (int b = 0; b < RT; ++b) acc[b] = 0.0f;
    if (col_ok) {
      int k = k_lo;
      for (; k + SCAN_UNROLL <= k_hi; k += SCAN_UNROLL) {
        float w[SCAN_UNROLL];
#pragma unroll
        for (int e = 0; e < SCAN_UNROLL; ++e) w[e] = load_w(wcol + (size_t)(k + e) * G4);
#pragma unroll
        for (int e = 0; e < SCAN_UNROLL; ++e) fma_rows<RT>(acc, w[e], h_s + (k + e) * RT);
      }
      for (; k < k_hi; ++k) fma_rows<RT>(acc, load_w(wcol + (size_t)k * G4), h_s + k * RT);
    }
#pragma unroll
    for (int b = 0; b < RT; ++b) part_s[(part * RT + b) * SCAN_COLS + col] = acc[b];
    __syncthreads();

    if (cell_ok) {
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* p = part_s + cb * SCAN_COLS + q * SCAN_UNITS + cj;
        float s = p[0];
#pragma unroll
        for (int pp = 1; pp < SCAN_PARTS; ++pp) s = __fadd_rn(s, p[(size_t)pp * RT * SCAN_COLS]);
        pre[q] = __fadd_rn(xv[q], s);
      }
      const float ig = sigmoidf_(pre[0]);
      const float fg = sigmoidf_(pre[1]);
      const float gg = tanhf(pre[2]);
      const float og = sigmoidf_(pre[3]);
      // explicit roundings: f*c + i*g as the plain version computes it
      cc = __fadd_rn(__fmul_rn(fg, cc), __fmul_rn(ig, gg));
      hl = __fmul_rn(og, tanhf(cc));
      if constexpr (RESID) {
        float* gp = gates + ((size_t)t * RB + row) * G4 + u;
        gp[0] = ig;
        gp[G] = fg;
        gp[2 * G] = gg;
        gp[3 * G] = og;
        cs[((size_t)t * RB + row) * G + u] = cc;
      }
      if (t + 1 < T) {
        volatile unsigned long long* dst =
            hx_r + ((size_t)((t + 1) & 1) * SCAN_ROWS + cb) * G + u;
        *dst = ((unsigned long long)(tag0 + (unsigned)t + 1u) << 32) |
               (unsigned long long)__float_as_uint(hl);
      }
      hs[((size_t)t * RB + row) * G + u] = hl;
    }
  }

  if (cell_ok) {
    hT[row * G + u] = hl;
    c[row * G + u] = cc;
  }
}

// ---- the resident form -------------------------------------------------

// Row stride of h in shared memory at row tile rt: padded beyond 4 rows so
// that the reads of eight neighbouring k (a float4 of rows each, a quarter
// of a warp) fall on distinct banks.
__host__ __device__ constexpr int rs_hs(int rt) { return rt <= 4 ? rt : rt + 4; }

// k iterations of a part at width G (part p runs k = p, p + 16, ...)
__host__ __device__ constexpr int rs_iters(int G) { return (G + RS_PARTS - 1) / RS_PARTS; }

// Iterations of a part whose W stays in registers at row tile rt, the rest
// in shared memory: at 8 and 16 rows the accumulators (2 units x 4 gates x
// 8 rows) need what more W would take (on the H100 13 iterations spill and
// take 11.8 us a step at 16 rows, 9 take 9.6 and spill nothing); at one row
// 13 take 2.24 us a step and 9 2.40 (chip_forms.py scan_phases), and 11
// keep narrow layers' zero-padded iterations few.
__host__ __device__ constexpr int rs_kreg(int rt) { return rt >= 8 ? 9 : 11; }

// k rows of an h buffer: G rounded up to whole iterations of the parts, and
// at least the rs_kreg(rt) iterations in registers (the rows beyond G stay
// zero, as does W there, so every part runs the same iterations and the
// register part needs no bound: a sum starts at +0, is never -0, and adding
// +0 leaves its bits as they are)
__host__ __device__ constexpr int rs_krows(int G, int rt) {
  return RS_PARTS * (rs_iters(G) > rs_kreg(rt) ? rs_iters(G) : rs_kreg(rt));
}

// Dynamic shared memory of the resident form: W of the iterations beyond
// rs_kreg(rt) (two float4 of gates, one a unit, a thread and iteration) and
// h (rs_krows(G, rt) x rs_hs(rt) f32).
size_t rs_smem(int G, int rt) {
  const int ksm = rs_iters(G) > rs_kreg(rt) ? rs_iters(G) - rs_kreg(rt) : 0;
  return sizeof(float4) * 2 * (size_t)ksm * RS_THREADS +
         sizeof(float) * (size_t)rs_krows(G, rt) * rs_hs(rt);
}

__device__ __forceinline__ float4 load_w4(const float* p, int G) {
  return make_float4(__ldg(p), __ldg(p + G), __ldg(p + 2 * G), __ldg(p + 3 * G));
}

__device__ __forceinline__ float4 load_w4(const __nv_bfloat16* p, int G) {
  return make_float4(load_w(p), load_w(p + G), load_w(p + 2 * G), load_w(p + 3 * G));
}

// acc[e][q][b] += w[e].q * h[b]: the four gates of two units against the
// RP rows of one k (h at hk, RP f32)
template <int RP>
__device__ __forceinline__ void fma_pass(float (&acc)[2][4][RP], float4 w0, float4 w1,
                                         const float* hk) {
  float h[RP];
  if constexpr (RP % 4 == 0) {
#pragma unroll
    for (int b = 0; b < RP; b += 4) {
      const float4 h4 = *reinterpret_cast<const float4*>(hk + b);
      h[b] = h4.x;
      h[b + 1] = h4.y;
      h[b + 2] = h4.z;
      h[b + 3] = h4.w;
    }
  } else if constexpr (RP == 2) {
    const float2 h2 = *reinterpret_cast<const float2*>(hk);
    h[0] = h2.x;
    h[1] = h2.y;
  } else {
    h[0] = hk[0];
  }
#pragma unroll
  for (int b = 0; b < RP; ++b) {
    acc[0][0][b] = __fmaf_rn(w0.x, h[b], acc[0][0][b]);
    acc[0][1][b] = __fmaf_rn(w0.y, h[b], acc[0][1][b]);
    acc[0][2][b] = __fmaf_rn(w0.z, h[b], acc[0][2][b]);
    acc[0][3][b] = __fmaf_rn(w0.w, h[b], acc[0][3][b]);
    acc[1][0][b] = __fmaf_rn(w1.x, h[b], acc[1][0][b]);
    acc[1][1][b] = __fmaf_rn(w1.y, h[b], acc[1][1][b]);
    acc[1][2][b] = __fmaf_rn(w1.z, h[b], acc[1][2][b]);
    acc[1][3][b] = __fmaf_rn(w1.w, h[b], acc[1][3][b]);
  }
}

// Scatter rounds over the rows of a pass of rp rows: log2(rp) (rp <= 8).
__host__ __device__ constexpr int rs_scatter(int rp) {
  return rp >= 8 ? 3 : rp == 4 ? 2 : rp == 2 ? 1 : 0;
}

// The sixteen parts' sums of two units meet in one tree over the lanes p of
// a half-warp, masks 8, 4, 2, 1 in this order: pairs {p, p ^ 8}, then of
// those {p, p ^ 4}, and so on, for every (unit, gate, row), whatever the
// row tile (a float sum is the same either way round).  The mask-8 round
// keeps one unit on each side of the mask (the one of the mask bit), the
// next rs_scatter(RP) rounds half the rows held, the rest sum the one row
// left in place on both sides.  Leaves this lane's unit and rows in
// acc[0][q][0 .. RP >> rs_scatter(RP)).
template <int RP>
__device__ __forceinline__ void rs_reduce(float (&acc)[2][4][RP], int p) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int SCAT = rs_scatter(RP);
  {
    const bool hi = (p & 8) != 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < RP; ++b) {
        const float keep = hi ? acc[1][q][b] : acc[0][q][b];
        const float send = hi ? acc[0][q][b] : acc[1][q][b];
        acc[0][q][b] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, 8));
      }
    }
  }
#pragma unroll
  for (int round = 0; round < 3; ++round) {
    const int mask = 4 >> round;
    if (round < SCAT) {
      const int half = (RP >> round) / 2;
      const bool hi = (p & mask) != 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int i = 0; i < RP / 2; ++i) {
          if (i < half) {
            const float keep = hi ? acc[0][q][i + half] : acc[0][q][i];
            const float send = hi ? acc[0][q][i] : acc[0][q][i + half];
            acc[0][q][i] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, mask));
          }
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[0][q][0] = __fadd_rn(acc[0][q][0], __shfl_xor_sync(FULL, acc[0][q][0], mask));
    }
  }
}

// grid = (ceil(G/32), chains of this launch), RS_THREADS threads.  RT: the
// row tile, a power of two >= nb, taken in passes of up to RS_PASS rows.
// Dynamic shared memory rs_smem(G, RT).  hx: exchange words (R, 2,
// SCAN_ROWS, G), zeroed before the layer's first launch; the contract of
// lstm_scan_kernel.
template <typename W, int RT, bool RESID>
__global__ void __launch_bounds__(RS_THREADS, 1)
lstm_scan_resident_kernel(const float* __restrict__ xp, const W* __restrict__ whh,
                          const float* __restrict__ h0, float* __restrict__ c,
                          float* __restrict__ hs, float* __restrict__ hT,
                          float* __restrict__ gates, float* __restrict__ cs,
                          unsigned long long* hx, int T, int R, int B, int b0, int nb, int G,
                          int r0, unsigned tag0) {
  constexpr int HS = rs_hs(RT);
  constexpr int RP = RT < RS_PASS ? RT : RS_PASS;  // rows of a pass
  constexpr int NP = RT / RP;                       // passes
  constexpr int SCAT = rs_scatter(RP);
  constexpr int UPT = RS_G_MAX / RS_THREADS;        // units a thread polls for (2)
  constexpr int KREG = rs_kreg(RT);
  extern __shared__ __align__(16) float smem[];
  const int iters = rs_iters(G);
  const int ksm = iters > KREG ? iters - KREG : 0;
  const int KR = rs_krows(G, RT);
  float4* w_s = reinterpret_cast<float4*>(smem);                // [(i - KREG) 2 + e][tid]
  float* h_s = smem + (size_t)8 * ksm * RS_THREADS;             // [k * HS + b]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int p = lane % RS_PARTS;
  // the product's role: units j0 and j0 + 1 of the block, k = p + 16 i
  const int j0 = (tid / 32) * 4 + (lane / RS_PARTS) * 2;
  const int u0 = blockIdx.x * SCAN_UNITS;
  const int r = r0 + blockIdx.y;
  const int G4 = 4 * G;
  const size_t RB = (size_t)R * B;

  // this lane's share of W_hh, upcast to f32, for all T steps (zero for k
  // beyond G: those terms add +0 and leave every sum as it is)
  const W* wr_base = whh + (size_t)r * G * G4 + u0 + j0;
  auto w_at = [&](int i, int e) {
    const int k = p + RS_PARTS * i;
    return u0 + j0 + e < G && k < G ? load_w4(wr_base + (size_t)k * G4 + e, G)
                                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  float4 wr[KREG][2];
#pragma unroll
  for (int i = 0; i < KREG; ++i) {
    wr[i][0] = w_at(i, 0);
    wr[i][1] = w_at(i, 1);
  }
  for (int i = KREG; i < iters; ++i) {
    w_s[(size_t)((i - KREG) * 2) * RS_THREADS + tid] = w_at(i, 0);
    w_s[(size_t)((i - KREG) * 2 + 1) * RS_THREADS + tid] = w_at(i, 1);
  }

  // rows beyond nb and k beyond G stay zero; h0 in
  for (int i = tid; i < KR * HS; i += RS_THREADS) h_s[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < nb * G; i += RS_THREADS) {
    const int b = i / G;
    const int k = i - b * G;
    h_s[k * HS + b] = h0[((size_t)r * B + b0 + b) * G + k];
  }

  // the cells this lane applies after rs_reduce: unit j0 + (p >> 3) and, in
  // pass n, row n RP + rb; a lane leads its row where the in-place rounds'
  // mask bits of p are 0 (those rounds leave the same sums on both sides)
  const int u = u0 + j0 + (p >> 3);
  int rb = 0;
#pragma unroll
  for (int round = 0; round < SCAT; ++round)
    if (p & (4 >> round)) rb += RP >> (round + 1);
  const bool leader = (p & ((1 << (3 - SCAT)) - 1)) == 0;
  float cc[NP], hl[NP];
  bool cell_ok[NP];
  size_t row[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    cell_ok[n] = leader && u < G && n * RP + rb < nb;
    row[n] = (size_t)r * B + b0 + n * RP + rb;
    cc[n] = cell_ok[n] ? c[row[n] * G + u] : 0.0f;
    hl[n] = cell_ok[n] ? h0[row[n] * G + u] : 0.0f;
  }

  unsigned long long* hx_r = hx + (size_t)r * 2 * SCAN_ROWS * G;

  // xp of step t, for the cells' rows: loaded a step ahead, from L2, where a
  // prefetch two steps earlier has put it, so that no poll queues behind a
  // load from device memory
  const size_t x_step = RB * G4;
  const float* xr[NP];
  float xv[NP][4];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    xr[n] = xp + row[n] * G4 + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      xv[n][q] = cell_ok[n] ? xr[n][(size_t)q * G] : 0.0f;
      if (cell_ok[n] && T > 1) prefetch_l2(xr[n] + x_step + (size_t)q * G);
      if (cell_ok[n] && T > 2) prefetch_l2(xr[n] + 2 * x_step + (size_t)q * G);
    }
  }

  for (int t = 0; t < T; ++t) {
    float* hb = h_s;
    float xn[NP][4];
#pragma unroll
    for (int n = 0; n < NP; ++n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* x1 = xr[n] + (size_t)(t + 1) * x_step + (size_t)q * G;
        xn[n][q] = cell_ok[n] && t + 1 < T ? *x1 : 0.0f;
        if (cell_ok[n] && t + 3 < T) prefetch_l2(x1 + 2 * x_step);
      }
    }

    if (t > 0) {
      // h_{t-1}: a thread takes every row of units tid and tid + 256, whose
      // words one producer warp each writes.  It spins on the first word
      // alone (one load a thread while waiting: more loads in flight then
      // slow every block's exchange down), then asks for all the others at
      // once, and again for those without this step's tag, until none is
      // left (one L2 round trip a round).
      const volatile unsigned long long* src = hx_r + (size_t)(t & 1) * SCAN_ROWS * G;
      const unsigned want = tag0 + (unsigned)t;
      const unsigned long long ready = (unsigned long long)want << 32;
      unsigned long long v[UPT][RT];
      unsigned polls = 0;
      if (tid < G) {
        v[0][0] = src[tid];
        while ((unsigned)(v[0][0] >> 32) != want) {
          if (++polls > SCAN_MAX_POLLS) __trap();
          v[0][0] = src[tid];
        }
      }
#pragma unroll
      for (int m = 0; m < UPT; ++m) {
        const int k = tid + m * RS_THREADS;
#pragma unroll
        for (int b = 0; b < RT; ++b)
          if (m > 0 || b > 0) v[m][b] = k < G && b < nb ? src[(size_t)b * G + k] : ready;
      }
      if (tid >= G) v[0][0] = ready;
      for (;;) {
        bool stale = false;
#pragma unroll
        for (int m = 0; m < UPT; ++m) {
#pragma unroll
          for (int b = 0; b < RT; ++b) stale |= (unsigned)(v[m][b] >> 32) != want;
        }
        if (!stale) break;
        if (++polls > SCAN_MAX_POLLS) __trap();
#pragma unroll
        for (int m = 0; m < UPT; ++m) {
#pragma unroll
          for (int b = 0; b < RT; ++b)
            if ((unsigned)(v[m][b] >> 32) != want)
              v[m][b] = src[(size_t)b * G + tid + m * RS_THREADS];
        }
      }
      // rows beyond nb carry 0, as the buffer does there
#pragma unroll
      for (int m = 0; m < UPT; ++m) {
        const int k = tid + m * RS_THREADS;
        if (k < G) {
          float* hk = hb + k * HS;
          if constexpr (RT % 4 == 0) {
#pragma unroll
            for (int b = 0; b < RT; b += 4)
              *reinterpret_cast<float4*>(hk + b) =
                  make_float4(__uint_as_float((uint32_t)v[m][b]),
                              __uint_as_float((uint32_t)v[m][b + 1]),
                              __uint_as_float((uint32_t)v[m][b + 2]),
                              __uint_as_float((uint32_t)v[m][b + 3]));
          } else {
#pragma unroll
            for (int b = 0; b < RT; ++b) hk[b] = __uint_as_float((uint32_t)v[m][b]);
          }
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int n = 0; n < NP; ++n) {
      // this lane's part of the product for the pass's rows, ascending
      // k = p + 16 i
      float acc[2][4][RP];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int b = 0; b < RP; ++b) acc[e][q][b] = 0.0f;
        }
      }
      const float* hp = hb + p * HS + n * RP;
#pragma unroll
      for (int i = 0; i < KREG; ++i)
        fma_pass<RP>(acc, wr[i][0], wr[i][1], hp + i * RS_PARTS * HS);
#pragma unroll 4
      for (int i = KREG; i < iters; ++i)
        fma_pass<RP>(acc, w_s[(size_t)((i - KREG) * 2) * RS_THREADS + tid],
                     w_s[(size_t)((i - KREG) * 2 + 1) * RS_THREADS + tid],
                     hp + i * RS_PARTS * HS);
      // the step's last read of h: the next step's poll may overwrite it
      if (n == NP - 1) __syncthreads();
      rs_reduce<RP>(acc, p);

      if (cell_ok[n]) {
        const float ig = sigmoidf_(__fadd_rn(xv[n][0], acc[0][0][0]));
        const float fg = sigmoidf_(__fadd_rn(xv[n][1], acc[0][1][0]));
        const float gg = tanhf(__fadd_rn(xv[n][2], acc[0][2][0]));
        const float og = sigmoidf_(__fadd_rn(xv[n][3], acc[0][3][0]));
        // explicit roundings: f*c + i*g as the plain version computes it
        cc[n] = __fadd_rn(__fmul_rn(fg, cc[n]), __fmul_rn(ig, gg));
        hl[n] = __fmul_rn(og, tanhf(cc[n]));
        // h_t to the exchange first, so that no consumer waits behind the
        // stores of the outputs
        if (t + 1 < T) {
          volatile unsigned long long* dst =
              hx_r + ((size_t)((t + 1) & 1) * SCAN_ROWS + n * RP + rb) * G + u;
          *dst = ((unsigned long long)(tag0 + (unsigned)t + 1u) << 32) |
                 (unsigned long long)__float_as_uint(hl[n]);
        }
        const size_t o = (size_t)t * RB + row[n];
        hs[o * G + u] = hl[n];
        if constexpr (RESID) {
          float* gp = gates + o * G4 + u;
          gp[0] = ig;
          gp[G] = fg;
          gp[2 * G] = gg;
          gp[3 * G] = og;
          cs[o * G + u] = cc[n];
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NP; ++n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[n][q] = xn[n][q];
    }
  }

#pragma unroll
  for (int n = 0; n < NP; ++n) {
    if (cell_ok[n]) {
      hT[row[n] * G + u] = hl[n];
      c[row[n] * G + u] = cc[n];
    }
  }
}

template <typename W, bool RESID>
const void* resident_kernel_rt(int rt) {
  switch (rt) {
    case 1: return (const void*)lstm_scan_resident_kernel<W, 1, RESID>;
    case 2: return (const void*)lstm_scan_resident_kernel<W, 2, RESID>;
    case 4: return (const void*)lstm_scan_resident_kernel<W, 4, RESID>;
    case 8: return (const void*)lstm_scan_resident_kernel<W, 8, RESID>;
    case 16: return (const void*)lstm_scan_resident_kernel<W, 16, RESID>;
    default: return nullptr;
  }
}

// ---- the streaming form's instantiations, and both forms' setup --------

template <typename W, bool RESID, bool ROUND_H = false>
const void* scan_kernel_rt(int rt) {
  switch (rt) {
    case 1: return (const void*)lstm_scan_kernel<W, 1, RESID, ROUND_H>;
    case 2: return (const void*)lstm_scan_kernel<W, 2, RESID, ROUND_H>;
    case 4: return (const void*)lstm_scan_kernel<W, 4, RESID, ROUND_H>;
    case 8: return (const void*)lstm_scan_kernel<W, 8, RESID, ROUND_H>;
    case 16: return (const void*)lstm_scan_kernel<W, 16, RESID, ROUND_H>;
    default: return nullptr;
  }
}

// Dynamic shared memory at row tile rt: h (G x rt f32, k-major) and the
// quarters' sums (SCAN_PARTS x rt x 128 f32).
size_t scan_smem(int G, int rt) {
  return sizeof(float) * ((size_t)G * rt + (size_t)SCAN_PARTS * rt * SCAN_COLS);
}

// The instantiation of the form (resident = 1 or streaming) for row tile
// rt, W_hh storage and the residual flag (round_h: the wide merged form,
// streaming with bf16 W_hh only), with the dynamic shared memory it needs
// allowed, and its block size; cudaErrorInvalidValue for a tile it does not
// have or a width the resident form does not take (G > 512).
cudaError_t scan_kernel(int resident, int rt, int whh_bf16, int resid, int round_h, int G,
                        const void** fn, size_t* smem, int* threads) {
  if (G < 1 || (resident && G > RS_G_MAX)) return cudaErrorInvalidValue;
  if (round_h) {
    if (resident || !whh_bf16) return cudaErrorInvalidValue;
    *fn = resid ? scan_kernel_rt<__nv_bfloat16, true, true>(rt)
                : scan_kernel_rt<__nv_bfloat16, false, true>(rt);
    *smem = scan_smem(G, rt);
    *threads = SCAN_THREADS;
  } else if (resident) {
    if (resid)
      *fn = whh_bf16 ? resident_kernel_rt<__nv_bfloat16, true>(rt)
                     : resident_kernel_rt<float, true>(rt);
    else
      *fn = whh_bf16 ? resident_kernel_rt<__nv_bfloat16, false>(rt)
                     : resident_kernel_rt<float, false>(rt);
    *smem = rs_smem(G, rt);
    *threads = RS_THREADS;
  } else {
    if (resid)
      *fn = whh_bf16 ? scan_kernel_rt<__nv_bfloat16, true>(rt) : scan_kernel_rt<float, true>(rt);
    else
      *fn = whh_bf16 ? scan_kernel_rt<__nv_bfloat16, false>(rt) : scan_kernel_rt<float, false>(rt);
    *smem = scan_smem(G, rt);
    *threads = SCAN_THREADS;
  }
  if (*fn == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// K10's launch geometry on the current device in the form asked for
// (resident = 1: W_hh on the chip, G <= 512; 0: streaming) at width G,
// W_hh in bf16 (whh_bf16 = 1) or f32, with the residual stores (resid = 1)
// or not: `rows`, the largest row tile (16, 8, 4, 2 or 1) whose shared
// memory a block may have, and `blocks`, how many blocks of that tile the
// device holds at once (what a cooperative launch may ask for; a smaller
// tile needs less and fits as many).  rows = 0 where not even one row of h
// fits.  At that tile, `smem`: the dynamic shared memory a block asks for,
// and `w_regs`: the bytes of a full block's share of W_hh (its 128 columns
// x G, f32) that stay in registers (the rest is in shared memory; 0 in the
// streaming form).  Returns the first CUDA error;
// cudaErrorInvalidConfiguration where the device has no cooperative launch.
// round_h: the wide merged form's instantiation (umx_lstm_merged_wide).
int scan_capacity(int resident, int G, int whh_bf16, int resid, int round_h, int* rows,
                  int* blocks, int* smem, int* w_regs) {
  int dev = 0, sms = 0, coop = 0, smem_max = 0;
  *rows = 0;
  *blocks = 0;
  *smem = 0;
  *w_regs = 0;
  if (G < 1 || (resident && G > RS_G_MAX)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorInvalidConfiguration;
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  for (int rt = SCAN_ROWS; rt >= 1; rt /= 2) {
    if ((resident ? rs_smem(G, rt) : scan_smem(G, rt)) > (size_t)smem_max) continue;
    const void* fn = nullptr;
    size_t bytes = 0;
    int per_sm = 0, threads = 0;
    e = scan_kernel(resident, rt, whh_bf16, resid, round_h, G, &fn, &bytes, &threads);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, bytes);
    if (e != cudaSuccess) return (int)e;
    *rows = rt;
    *blocks = per_sm * sms;
    *smem = (int)bytes;
    // the k rows of the iterations held in registers (k = p + 16 i, i <
    // rs_kreg), of the G real ones
    const int kreg_rows = RS_PARTS * rs_kreg(rt);
    *w_regs = resident ? (int)sizeof(float) * SCAN_COLS * (G < kreg_rows ? G : kreg_rows) : 0;
    return (int)cudaSuccess;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" int umx_lstm_scan_capacity(int resident, int G, int whh_bf16, int resid, int* rows,
                                      int* blocks, int* smem, int* w_regs) {
  return scan_capacity(resident, G, whh_bf16, resid, 0, rows, blocks, smem, w_regs);
}

// The wide merged form's launch geometry (umx_lstm_scan_capacity of the
// streaming form with bf16 W_hh and rounded h): K1 (resid = 0) or K4.
extern "C" int umx_lstm_merged_wide_capacity(int G, int resid, int* rows, int* blocks, int* smem,
                                             int* w_regs) {
  return scan_capacity(0, G, 1, resid, 1, rows, blocks, smem, w_regs);
}

namespace {

int scan_launch(int resident, int round_h, const float* xp, const void* whh, int whh_bf16,
                const float* h0, float* c, float* hs, float* hT, float* gates, float* cs,
                void* hx, int T, int R, int B, int G, int r0, int nr, int b0, int nb, int rt,
                unsigned tag0, void* stream) {
  if (G < 1 || T < 1 || B < 1 || nb < 1 || nb > rt || rt > SCAN_ROWS || b0 < 0 ||
      b0 + nb > B || nr < 1 || r0 < 0 || r0 + nr > R)
    return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  size_t smem = 0;
  int threads = 0;
  cudaError_t e =
      scan_kernel(resident, rt, whh_bf16, gates != nullptr, round_h, G, &fn, &smem, &threads);
  if (e != cudaSuccess) return (int)e;
  unsigned long long* hxp = static_cast<unsigned long long*>(hx);
  void* args[] = {&xp, &whh, &h0, &c, &hs, &hT, &gates, &cs, &hxp, &T, &R, &B,
                  &b0, &nb, &G, &r0, &tag0};
  const dim3 grid((G + SCAN_UNITS - 1) / SCAN_UNITS, nr);
  e = cudaLaunchCooperativeKernel(fn, grid, dim3(threads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// K10: one launch in the form asked for (resident = 1 or streaming), all T
// steps of chains [r0, r0 + nr) and rows [b0, b0 + nb) of each,
// nb <= rt <= 16, rt a power of two.  `c` holds c0 on entry and cT on
// return for those rows.  `hx` is the exchange buffer, R * 2 * 16 * G
// 64-bit words, zeroed before the layer's first launch; `tag0` is the
// number of steps earlier launches ran on the same buffer.
// Returns the first CUDA error.
extern "C" int umx_lstm_scan(int resident, const float* xp, const void* whh, int whh_bf16,
                             const float* h0, float* c, float* hs, float* hT, void* hx, int T,
                             int R, int B, int G, int r0, int nr, int b0, int nb, int rt,
                             unsigned tag0, void* stream) {
  return scan_launch(resident, 0, xp, whh, whh_bf16, h0, c, hs, hT, nullptr, nullptr, hx, T, R,
                     B, G, r0, nr, b0, nb, rt, tag0, stream);
}

// K10 with the residual stores: umx_lstm_scan plus the activated gates
// (T, R*B, 4G) and c (T, R*B, G) of every step of those chains and rows.
extern "C" int umx_lstm_scan_train(int resident, const float* xp, const void* whh,
                                   int whh_bf16, const float* h0, float* c, float* hs,
                                   float* hT, float* gates, float* cs, void* hx, int T, int R,
                                   int B, int G, int r0, int nr, int b0, int nb, int rt,
                                   unsigned tag0, void* stream) {
  if (gates == nullptr || cs == nullptr) return (int)cudaErrorInvalidValue;
  return scan_launch(resident, 0, xp, whh, whh_bf16, h0, c, hs, hT, gates, cs, hx, T, R, B, G,
                     r0, nr, b0, nb, rt, tag0, stream);
}

// K1 and K4 above G 512, the wide merged form: umx_lstm_scan's streaming
// launch with bf16 W_hh (R, G, 4G) and h rounded to bf16 for the product,
// K1's function; with gates and cs (both given) also K4's residuals.
// The arguments and the exchange buffer are umx_lstm_scan's.
extern "C" int umx_lstm_merged_wide(const float* xp, const void* whh, const float* h0, float* c,
                                    float* hs, float* hT, float* gates, float* cs, void* hx, int T,
                                    int R, int B, int G, int r0, int nr, int b0, int nb, int rt,
                                    unsigned tag0, void* stream) {
  if ((gates == nullptr) != (cs == nullptr)) return (int)cudaErrorInvalidValue;
  return scan_launch(0, 1, xp, whh, 1, h0, c, hs, hT, gates, cs, hx, T, R, B, G, r0, nr, b0, nb,
                     rt, tag0, stream);
}
