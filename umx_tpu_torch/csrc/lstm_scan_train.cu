// The reverse-time float32 sweep of one BLSTM layer, all chains at once
// (K11): the backward of K10 (lstm_scan.cu).
//
// Replaces no Pallas kernel: it ports what JAX's autodiff makes of the
// lax.scan step of umx_tpu/models/umx.py:_bilstm_layer (lstm_impl="scan",
// which the JAX trainer differentiates).  A plain loop of torch.bmm would
// put T launches a layer on the card's training path; this is one launch a
// layer.
//
// Contract (K10's layouts; rows chain-major, row = r*B + b).  From the
// residuals of K10's forward with its flag: gates (T, RB, 4G) activated
// i|f|g|o, cs (T, RB, G), and c0 (RB, G); W_hh as stored, (R, G, 4G), in
// the resident form, or transposed, wt (R, 4G, G), in the streaming form,
// in its stored dtype (f32, or bf16 upcast exactly); the cotangents
// dhs (T, RB, G), dhT (RB, G) and dcT (in `dc`).  Per step, t = T-1 ... 0,
// cprev = cs[t-1] (c0 at t = 0), in the plain version's order
// (ops/lstm_cuda.py:lstm_scan_bwd_step_plain), every product rounded on
// its own (no contraction into an FMA):
//   dh  = dh_carry + dhs[t];  tc = tanh(cs[t]);  do = dh tc
//   dct = dc + (dh o)(1 - tc tc)
//   dg  = [((dct g) i)(1-i), ((dct cprev) f)(1-f), (dct i)(1-g g), (do o)(1-o)]
//   dxp[t] = dg;  dc = dct f;  dh_carry = dg . W_hh[r]^T   (f32 FMA, all 4G)
// Outputs dxp (T, RB, 4G), dh0 (RB, G) (the product after step 0) and dc0
// (in `dc`), all f32; nothing is rounded to bf16 (this is the scan's VJP,
// not K5's).  The weight gradient, sum over t, b of h_{t-1}^T dxp_t, is a
// plain f32 matrix product outside the sweep (torch.bmm in the wrapper's
// caller), as JAX leaves it to XLA.  Any G >= 1 and any B.
//
// What bounds it on the H100: what bounds K10.  The T steps depend on each
// other, and a step needs all of W_hh (4 MiB a chain in f32 at G 512,
// 33.5 MB for UMX-L's 8 chains: in the 50 MB L2, not in the register file
// alone) against a few rows of dg.  The product contracts over the 4G gate
// columns and yields G units, so where K10's exchange carries h (G a row),
// a step here needs every gate cotangent of the row (4G) before it can
// form dh.
//
// The forms, K10's launch: ONE cooperative launch runs all T steps of all
// chains and up to 16 rows per chain; a chain is split over ceil(G/32)
// blocks, a block owns 32 hidden units and their 128 gate columns, and
// each block multiplies its own 128 columns of dg against W_hh for every
// unit of the chain and publishes those G partial sums; a block then reads
// the partials of its 32 units from every block of the chain and adds
// them in block order (the "partial" exchange: G words written and G read
// a block and row each step; publishing dg itself instead, 4G words read a
// block and row, measured slower on the H100: PERF.md, K11).  The block's
// share of W_hh is K10's, W_hh[all units][its 128 columns].  The wrapper
// picks the form from G alone (ops/lstm_cuda.py:scan_form), before the
// launch:
//
// The resident form (G <= 512).  The share (256 KiB at G 512) is loaded
// once and stays on the chip: a thread of the block's 256 owns units
// tid and tid + 256 of the chain, with W of the block's first RB_CREG
// columns in registers and of the rest in shared memory.  Each column
// feeds 2 x rows FMAs from one broadcast of its dg rows; the step reads no
// W_hh from memory.  A thread owns whole sums, so its partials go to the
// exchange without a reduction, and (unit, row) pairs of the block's
// units are spread two a thread for the cell and the partials' sum.  One
// barrier a step (dg in shared memory, double-buffered by step parity).
//
// The streaming form (G > 640; by name, the yardstick of the wide form),
// the form from before the resident one.
// 512 threads; a thread owns one unit at a time (the chain's units spread
// over the 16 warps) and streams the share from L2 or device memory each
// step, from W_hh transposed, wt (R, 4G, G), which the wrapper makes for
// this form alone: the 32 units of a warp are 32 neighbouring words of one
// row of wt, so a warp reads one 128-byte line a column (as stored, a
// lane's unit is a row of its own: 16 bytes from 32 rows a load, measured
// 1.12 x slower at G 640 with the copy's 0.12 ms counted; PERF.md, K11),
// and dg from shared memory as K10 reads h.
//
// The resident and streaming forms sum a (unit, row) partial over the
// block's columns in ascending order (gate-major, then unit) from 0 by f32
// FMA, and the partials in block order: the same order, so the two forms
// give the same bits, and a row's bits do not depend on B, the row group
// or what runs beside it: a row is bit-equal to itself run alone.
//
// The wide form (512 < G <= 640, where the card's figures give it a plan,
// ops/lstm_cuda.py:scan_wide_plan): W_hh on the chip in shares of 20 units
// over more blocks, R 8 in two chain groups; see "the wide form" below.
// Its partials are over blocks of 20 units: its own order, fixed by G.
// The streaming form then runs above G 640.
//
// The streaming merged backward (umx_lstm_bwd_wide) is the streaming form
// with the compile-time flag ROUND_DG and wt in bf16: the gate cotangents
// are rounded to bf16 (round to nearest even) where they enter the
// product, so every product is bf16(dg) x bf16(W_hh), exact in f32, summed
// in f32: K5's function (ops/lstm_cuda.py:lstm_merged_bwd_step_plain).
// dxp and the carries stay unrounded f32.  It is the yardstick of K5's
// block form (lstm_train.cu, W_hh on the chip above G 512; by name,
// _form="wide_streaming"), and K5's form above the widest G a block form
// holds (ops/lstm_cuda.py:BWD_WIDE_G_MAX, 1024 on an H100), where it reads
// W_hh from L2 every step.
//
// Rows beyond a launch's 16 and chains beyond what the card holds at once
// are further launches of the same kernel, planned by the wrapper; tag0
// keeps the tags of a launch unique among the launches that share the
// exchange buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SB_THREADS = 512;
constexpr int SB_UNITS = 32;                        // hidden units a block owns
constexpr int SB_COLS = 4 * SB_UNITS;               // its gate columns
constexpr int SB_WARPS = SB_THREADS / 32;           // 16
constexpr int SB_ROWS = 16;                         // rows per chain in one launch, at most
constexpr int SB_POLL = 4;                          // exchange words a thread has in flight
constexpr int SB_UNROLL = 8;                        // W_hh loads a thread has in flight
constexpr unsigned SB_MAX_POLLS = 1u << 24;

// the resident form
constexpr int RB_THREADS = 256;
constexpr int RB_UPT = 2;                            // units a thread owns in the product
constexpr int RB_CREG = 64;                          // block columns with W in registers
constexpr int RB_G_MAX = RB_THREADS * RB_UPT;        // 512
constexpr int RB_PAIRS = SB_ROWS * SB_UNITS / RB_THREADS;  // (unit, row) pairs a thread, at most

__device__ __forceinline__ float load_w(const float* p) { return __ldg(p); }

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" : : "l"(p));
}

__device__ __forceinline__ float load_w(const __nv_bfloat16* p) {
  // a bf16 value is the upper half of its f32 value: exact
  return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// acc[b] += w * d[b] for the RT rows of one column, d column-major in
// shared memory (the same order of operations at every RT)
template <int RT>
__device__ __forceinline__ void fma_rows(float (&acc)[RT], float w, const float* d) {
  if constexpr (RT % 4 == 0) {
#pragma unroll
    for (int b = 0; b < RT; b += 4) {
      const float4 d4 = *reinterpret_cast<const float4*>(d + b);
      acc[b] = __fmaf_rn(w, d4.x, acc[b]);
      acc[b + 1] = __fmaf_rn(w, d4.y, acc[b + 1]);
      acc[b + 2] = __fmaf_rn(w, d4.z, acc[b + 2]);
      acc[b + 3] = __fmaf_rn(w, d4.w, acc[b + 3]);
    }
  } else {
#pragma unroll
    for (int b = 0; b < RT; ++b) acc[b] = __fmaf_rn(w, d[b], acc[b]);
  }
}

// acc[b] += sum over columns c in [c_lo, c_hi) of wt[c * G] * d[c * RT + b],
// in ascending c; wt points at one unit's entry of the first column
template <typename W, int RT>
__device__ __forceinline__ void dot_cols(float (&acc)[RT], const W* wt, int G, int c_lo,
                                         int c_hi, const float* d) {
  int c = c_lo;
  for (; c + SB_UNROLL <= c_hi; c += SB_UNROLL) {
    float w[SB_UNROLL];
#pragma unroll
    for (int e = 0; e < SB_UNROLL; ++e) w[e] = load_w(wt + (size_t)(c + e) * G);
#pragma unroll
    for (int e = 0; e < SB_UNROLL; ++e) fma_rows<RT>(acc, w[e], d + (c + e) * RT);
  }
  for (; c < c_hi; ++c) fma_rows<RT>(acc, load_w(wt + (size_t)c * G), d + c * RT);
}

// Poll `n` exchange words at src[idx(i)] until each carries tag `want`,
// and hand each value to put(i, value).  Every thread takes words
// i = tid, tid + 512, ...; SB_POLL words in flight a thread.
template <typename Idx, typename Put>
__device__ __forceinline__ void poll_words(const volatile unsigned long long* src, int n,
                                           unsigned want, Idx idx, Put put) {
  for (int i0 = threadIdx.x; i0 < n; i0 += SB_POLL * SB_THREADS) {
    unsigned long long v[SB_POLL];
#pragma unroll
    for (int e = 0; e < SB_POLL; ++e) {
      const int i = i0 + e * SB_THREADS;
      v[e] = i < n ? src[idx(i)] : 0ull;
    }
    unsigned polls = 0;
#pragma unroll
    for (int e = 0; e < SB_POLL; ++e) {
      const int i = i0 + e * SB_THREADS;
      if (i < n) {
        while ((unsigned)(v[e] >> 32) != want) {
          if (++polls > SB_MAX_POLLS) __trap();
          v[e] = src[idx(i)];
        }
        put(i, __uint_as_float((uint32_t)v[e]));
      }
    }
  }
}

// dg as the product takes it: rounded to bf16 and back in the streaming merged
// backward, else as it is
template <bool ROUND_DG>
__device__ __forceinline__ float operand(float x) {
  if constexpr (ROUND_DG) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ unsigned long long tagged(unsigned tag, float v) {
  return ((unsigned long long)tag << 32) | (unsigned long long)__float_as_uint(v);
}

// grid = (ceil(G/32), chains of this launch), SB_THREADS threads.  RT: the
// row tile, a power of two >= nb.  Dynamic shared memory (floats): dg of
// the block's 128 columns (128 x RT, column-major) and the chain's
// partials of the block's 32 units (nblk x RT x 32).  hx: exchange words
// (R, 2, nblk, SB_ROWS, G), zeroed before the layer's first launch.
// ROUND_DG: the streaming merged backward (dg rounded to bf16 for the product).
template <typename W, int RT, bool ROUND_DG = false>
__global__ void __launch_bounds__(SB_THREADS, 1)
lstm_scan_bwd_kernel(const float* __restrict__ gates,  // (T, RB, 4G)
                     const float* __restrict__ cs,     // (T, RB, G)
                     const float* __restrict__ c0,     // (RB, G)
                     const W* __restrict__ wt,         // (R, 4G, G)
                     const float* __restrict__ dhs,    // (T, RB, G)
                     const float* __restrict__ dhT,    // (RB, G)
                     float* __restrict__ dc,           // (RB, G): dcT in, dc0 out
                     float* __restrict__ dxp,          // (T, RB, 4G)
                     float* __restrict__ dh0,          // (RB, G)
                     unsigned long long* hx, int T, int R, int B, int b0, int nb, int G, int r0,
                     unsigned tag0) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int r = r0 + blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int u0 = blk * SB_UNITS;
  const int G4 = 4 * G;
  const size_t RB = (size_t)R * B;
  const W* wt_r = wt + (size_t)r * G4 * G;

  // dg_s[(q * 32 + j) * RT + b] over the block's own columns, then
  // sum_s[(blk' * RT + b) * 32 + j]
  float* dg_s = smem;
  float* sum_s = smem + (size_t)SB_COLS * RT;

  // the cell's role: unit u0 + cj of row cb
  const int cj = lane;
  const int cb = warp;
  const int u = u0 + cj;
  const bool cell_ok = cb < nb && u < G;
  const size_t row = (size_t)r * B + b0 + cb;

  // columns (and rows) that are never written stay zero
  for (int i = tid; i < SB_COLS * RT; i += SB_THREADS) dg_s[i] = 0.0f;

  float dcl = 0.0f, carry = 0.0f;
  float gi = 0.0f, gf = 0.0f, gg = 0.0f, go = 0.0f, cst = 0.0f, cprev = 0.0f, dhst = 0.0f;
  // this step's residuals and cotangent: they do not depend on the carry
  auto load_step = [&](int t) {
    if (cell_ok) {
      const float* g4 = gates + ((size_t)t * RB + row) * G4 + u;
      gi = g4[0];
      gf = g4[G];
      gg = g4[2 * G];
      go = g4[3 * G];
      cst = cs[((size_t)t * RB + row) * G + u];
      cprev = t > 0 ? cs[((size_t)(t - 1) * RB + row) * G + u] : c0[row * G + u];
      dhst = dhs[((size_t)t * RB + row) * G + u];
    }
  };
  if (cell_ok) {
    dcl = dc[row * G + u];
    carry = dhT[row * G + u];
  }
  load_step(T - 1);
  __syncthreads();

  unsigned long long* hx_r = hx + (size_t)r * 2 * SB_ROWS * nblk * G;

  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    const int par = i & 1;
    const unsigned tag = tag0 + (unsigned)i + 1u;

    // the cell: dg of this unit's four columns, dxp, the dc carry
    float dg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (cell_ok) {
      const float tc = tanhf(cst);
      const float dh = __fadd_rn(carry, dhst);
      const float dov = __fmul_rn(dh, tc);
      const float dct =
          __fadd_rn(dcl, __fmul_rn(__fmul_rn(dh, go), __fsub_rn(1.0f, __fmul_rn(tc, tc))));
      dg[0] = __fmul_rn(__fmul_rn(__fmul_rn(dct, gg), gi), __fsub_rn(1.0f, gi));
      dg[1] = __fmul_rn(__fmul_rn(__fmul_rn(dct, cprev), gf), __fsub_rn(1.0f, gf));
      dg[2] = __fmul_rn(__fmul_rn(dct, gi), __fsub_rn(1.0f, __fmul_rn(gg, gg)));
      dg[3] = __fmul_rn(__fmul_rn(dov, go), __fsub_rn(1.0f, go));
      dcl = __fmul_rn(dct, gf);
      float* dx = dxp + ((size_t)t * RB + row) * G4 + u;
#pragma unroll
      for (int q = 0; q < 4; ++q) dx[(size_t)q * G] = dg[q];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dg_s[(q * SB_UNITS + cj) * RT + cb] = operand<ROUND_DG>(dg[q]);
    }
    if (t > 0) load_step(t - 1);  // in flight while the exchange runs

    __syncthreads();  // the block's dg is in
    // every unit of the chain against this block's columns: warp w takes
    // the units [32 kt, 32 kt + 32) for kt = w, w + 16, ...
    const int nj = min(SB_UNITS, G - u0);
    for (int kt = warp; kt < nblk; kt += SB_WARPS) {
      const int k = kt * SB_UNITS + lane;
      float acc[RT];
#pragma unroll
      for (int b = 0; b < RT; ++b) acc[b] = 0.0f;
      if (k < G) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dot_cols<W, RT>(acc, wt_r + (size_t)(q * G + u0) * G + k, G, 0, nj,
                          dg_s + q * SB_UNITS * RT);
        volatile unsigned long long* dst =
            hx_r + (((size_t)par * nblk + blk) * SB_ROWS) * G + k;
#pragma unroll
        for (int b = 0; b < RT; ++b)
          if (b < nb) dst[(size_t)b * G] = tagged(tag, acc[b]);
      }
    }
    // the partials of this block's units from every block of the chain
    const volatile unsigned long long* src = hx_r + (size_t)par * nblk * SB_ROWS * G;
    const int per = nb * SB_UNITS;
    poll_words(src, nblk * per, tag,
               [&](int w) {
                 const int p = w / per;
                 const int rem = w - p * per;
                 const int b = rem / SB_UNITS;
                 const int j = rem - b * SB_UNITS;
                 return ((size_t)p * SB_ROWS + b) * G + min(u0 + j, G - 1);
               },
               [&](int w, float v) {
                 const int p = w / per;
                 const int rem = w - p * per;
                 sum_s[(p * RT) * SB_UNITS + rem] = v;
               });
    __syncthreads();
    if (cell_ok) {
      float s = sum_s[cb * SB_UNITS + cj];
      for (int p = 1; p < nblk; ++p) s = __fadd_rn(s, sum_s[(p * RT + cb) * SB_UNITS + cj]);
      carry = s;
    }
  }

  if (cell_ok) {
    dh0[row * G + u] = carry;
    dc[row * G + u] = dcl;
  }
}

// ---- the resident form -------------------------------------------------

// Dynamic shared memory of the resident form: W of the columns beyond
// RB_CREG (a float2 of the thread's two units a column) and two buffers of
// dg (128 x rt f32, column-major), by step parity.
size_t rb_smem(int rt) {
  return sizeof(float2) * (size_t)(SB_COLS - RB_CREG) * RB_THREADS +
         sizeof(float) * 2 * (size_t)SB_COLS * rt;
}

// grid = (ceil(G/32), chains of this launch), RB_THREADS threads, G <= 512.
// RT: the row tile, a power of two >= nb.  Dynamic shared memory
// rb_smem(RT).  The contract of lstm_scan_bwd_kernel.
template <typename W, int RT>
__global__ void __launch_bounds__(RB_THREADS, 1)
lstm_scan_bwd_resident_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                              const float* __restrict__ c0, const W* __restrict__ whh,
                              const float* __restrict__ dhs, const float* __restrict__ dhT,
                              float* __restrict__ dc, float* __restrict__ dxp,
                              float* __restrict__ dh0, unsigned long long* hx, int T, int R,
                              int B, int b0, int nb, int G, int r0, unsigned tag0) {
  extern __shared__ __align__(16) float smem[];
  float2* w_s = reinterpret_cast<float2*>(smem);                          // [c - RB_CREG][tid]
  float* dg_s = smem + (size_t)2 * (SB_COLS - RB_CREG) * RB_THREADS;     // [parity][c * RT + b]
  const int tid = threadIdx.x;
  const int r = r0 + blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int u0 = blk * SB_UNITS;
  const int nj = min(SB_UNITS, G - u0);  // the block's units: its columns of each gate
  const int G4 = 4 * G;
  const size_t RB = (size_t)R * B;

  // the product's role: units tid and tid + 256 of the chain against the
  // block's columns c = 32 q + j (W_hh[unit][q G + u0 + j]), upcast to f32,
  // for all T steps
  const W* w_r = whh + (size_t)r * G * G4 + u0;
  auto w_at = [&](int unit, int c) {
    return unit < G && (c % SB_UNITS) < nj
               ? load_w(w_r + (size_t)unit * G4 + (size_t)(c / SB_UNITS) * G + c % SB_UNITS)
               : 0.0f;
  };
  float2 wr[RB_CREG];
#pragma unroll
  for (int c = 0; c < RB_CREG; ++c) wr[c] = make_float2(w_at(tid, c), w_at(tid + RB_THREADS, c));
  for (int c = RB_CREG; c < SB_COLS; ++c)
    w_s[(size_t)(c - RB_CREG) * RB_THREADS + tid] =
        make_float2(w_at(tid, c), w_at(tid + RB_THREADS, c));
  for (int i = tid; i < 2 * SB_COLS * RT; i += RB_THREADS) dg_s[i] = 0.0f;

  // the cell's role: (unit u0 + j, row b) pairs e = tid + 256 m
  int cj[RB_PAIRS], cb[RB_PAIRS];
  bool ok[RB_PAIRS];
  size_t row[RB_PAIRS];
  float dcl[RB_PAIRS], carry[RB_PAIRS];
  float gi[RB_PAIRS], gf[RB_PAIRS], gg[RB_PAIRS], go[RB_PAIRS], cst[RB_PAIRS], cprev[RB_PAIRS],
      dhst[RB_PAIRS];
#pragma unroll
  for (int m = 0; m < RB_PAIRS; ++m) {
    const int e = tid + m * RB_THREADS;
    cj[m] = e % SB_UNITS;
    cb[m] = e / SB_UNITS;
    ok[m] = cb[m] < nb && cj[m] < nj;
    row[m] = (size_t)r * B + b0 + cb[m];
    const size_t o = row[m] * G + u0 + cj[m];
    dcl[m] = ok[m] ? dc[o] : 0.0f;
    carry[m] = ok[m] ? dhT[o] : 0.0f;
  }
  // this step's residuals and cotangent: they do not depend on the carry
  auto load_step = [&](int t) {
#pragma unroll
    for (int m = 0; m < RB_PAIRS; ++m) {
      if (ok[m]) {
        const int u = u0 + cj[m];
        const float* g4 = gates + ((size_t)t * RB + row[m]) * G4 + u;
        gi[m] = g4[0];
        gf[m] = g4[G];
        gg[m] = g4[2 * G];
        go[m] = g4[3 * G];
        cst[m] = cs[((size_t)t * RB + row[m]) * G + u];
        cprev[m] = t > 0 ? cs[((size_t)(t - 1) * RB + row[m]) * G + u] : c0[row[m] * G + u];
        dhst[m] = dhs[((size_t)t * RB + row[m]) * G + u];
        if (t >= 2) {
          // two steps ahead into L2, so that no poll queues behind a load
          // from device memory
          const size_t o2 = (size_t)(t - 2) * RB + row[m];
#pragma unroll
          for (int q = 0; q < 4; ++q) prefetch_l2(gates + o2 * G4 + (size_t)q * G + u);
          prefetch_l2(cs + o2 * G + u);
          if (t >= 3) prefetch_l2(cs + (o2 - RB) * G + u);
          prefetch_l2(dhs + o2 * G + u);
        }
      }
    }
  };
  load_step(T - 1);
  __syncthreads();

  unsigned long long* hx_r = hx + (size_t)r * 2 * SB_ROWS * nblk * G;

  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    const int par = i & 1;
    const unsigned tag = tag0 + (unsigned)i + 1u;
    float* dgb = dg_s + (size_t)par * SB_COLS * RT;

    // the cell: dg of the pair's four columns, dxp, the dc carry
#pragma unroll
    for (int m = 0; m < RB_PAIRS; ++m) {
      if (ok[m]) {
        const float tc = tanhf(cst[m]);
        const float dh = __fadd_rn(carry[m], dhst[m]);
        const float dov = __fmul_rn(dh, tc);
        const float dct = __fadd_rn(
            dcl[m], __fmul_rn(__fmul_rn(dh, go[m]), __fsub_rn(1.0f, __fmul_rn(tc, tc))));
        float dg[4];
        dg[0] = __fmul_rn(__fmul_rn(__fmul_rn(dct, gg[m]), gi[m]), __fsub_rn(1.0f, gi[m]));
        dg[1] = __fmul_rn(__fmul_rn(__fmul_rn(dct, cprev[m]), gf[m]), __fsub_rn(1.0f, gf[m]));
        dg[2] = __fmul_rn(__fmul_rn(dct, gi[m]), __fsub_rn(1.0f, __fmul_rn(gg[m], gg[m])));
        dg[3] = __fmul_rn(__fmul_rn(dov, go[m]), __fsub_rn(1.0f, go[m]));
        dcl[m] = __fmul_rn(dct, gf[m]);
        float* dx = dxp + ((size_t)t * RB + row[m]) * G4 + u0 + cj[m];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dx[(size_t)q * G] = dg[q];
          dgb[(q * SB_UNITS + cj[m]) * RT + cb[m]] = dg[q];
        }
      }
    }
    if (t > 0) load_step(t - 1);  // in flight while the product and the exchange run
    __syncthreads();  // the block's dg is in

    // units tid and tid + 256 against the block's columns, ascending c
    float acc[RB_UPT][RT];
#pragma unroll
    for (int b = 0; b < RT; ++b) acc[0][b] = acc[1][b] = 0.0f;
    // (columns of units beyond G hold zero W and zero dg: a sum starts at
    // +0, is never -0, and adding +0 leaves its bits as they are, so the
    // order is the streaming form's, which skips them)
#pragma unroll
    for (int c = 0; c < RB_CREG; ++c) {
      fma_rows<RT>(acc[0], wr[c].x, dgb + c * RT);
      fma_rows<RT>(acc[1], wr[c].y, dgb + c * RT);
    }
#pragma unroll 8
    for (int c = RB_CREG; c < SB_COLS; ++c) {
      const float2 w = w_s[(size_t)(c - RB_CREG) * RB_THREADS + tid];
      fma_rows<RT>(acc[0], w.x, dgb + c * RT);
      fma_rows<RT>(acc[1], w.y, dgb + c * RT);
    }
#pragma unroll
    for (int mm = 0; mm < RB_UPT; ++mm) {
      const int unit = tid + mm * RB_THREADS;
      if (unit < G) {
        volatile unsigned long long* dst =
            hx_r + (((size_t)par * nblk + blk) * SB_ROWS) * G + unit;
#pragma unroll
        for (int b = 0; b < RT; ++b)
          if (b < nb) dst[(size_t)b * G] = tagged(tag, acc[mm][b]);
      }
    }

    // the pairs' partials from every block of the chain, added in block
    // order: a pair's words are read at once, then every word without this
    // step's tag again, all at once, until none is left
    const volatile unsigned long long* src = hx_r + (size_t)par * nblk * SB_ROWS * G;
    const unsigned long long ready = (unsigned long long)tag << 32;
#pragma unroll
    for (int m = 0; m < RB_PAIRS; ++m) {
      if (ok[m]) {
        const volatile unsigned long long* w = src + (size_t)cb[m] * G + u0 + cj[m];
        unsigned long long v[SB_ROWS];
        // the first word alone while waiting (one load a thread in flight),
        // then all the others at once
        unsigned polls = 0;
        v[0] = w[0];
        while ((unsigned)(v[0] >> 32) != tag) {
          if (++polls > SB_MAX_POLLS) __trap();
          v[0] = w[0];
        }
#pragma unroll
        for (int p = 1; p < SB_ROWS; ++p) v[p] = p < nblk ? w[(size_t)p * SB_ROWS * G] : ready;
        for (;;) {
          bool stale = false;
#pragma unroll
          for (int p = 1; p < SB_ROWS; ++p) stale |= (unsigned)(v[p] >> 32) != tag;
          if (!stale) break;
          if (++polls > SB_MAX_POLLS) __trap();
#pragma unroll
          for (int p = 1; p < SB_ROWS; ++p)
            if ((unsigned)(v[p] >> 32) != tag) v[p] = w[(size_t)p * SB_ROWS * G];
        }
        float s = __uint_as_float((uint32_t)v[0]);
#pragma unroll
        for (int p = 1; p < SB_ROWS; ++p)
          if (p < nblk) s = __fadd_rn(s, __uint_as_float((uint32_t)v[p]));
        carry[m] = s;
      }
    }
  }

#pragma unroll
  for (int m = 0; m < RB_PAIRS; ++m) {
    if (ok[m]) {
      dh0[row[m] * G + u0 + cj[m]] = carry[m];
      dc[row[m] * G + u0 + cj[m]] = dcl[m];
    }
  }
}

template <typename W>
const void* bwd_resident_kernel_rt(int rt) {
  switch (rt) {
    case 1: return (const void*)lstm_scan_bwd_resident_kernel<W, 1>;
    case 2: return (const void*)lstm_scan_bwd_resident_kernel<W, 2>;
    case 4: return (const void*)lstm_scan_bwd_resident_kernel<W, 4>;
    case 8: return (const void*)lstm_scan_bwd_resident_kernel<W, 8>;
    case 16: return (const void*)lstm_scan_bwd_resident_kernel<W, 16>;
    default: return nullptr;
  }
}

// ---- the wide form -----------------------------------------------------
//
// Above G 512 a chain's f32 W_hh (16 G^2 bytes: 6.55 MB at G 640, 52.4 MB
// for 8 chains) no longer fits the resident form's 16 blocks.  The wide
// form keeps it on the chip in smaller shares: a block owns SBW_UNITS = 20
// units and their 80 gate columns c = 20 q + j (gate q of unit u0 + j)
// against every unit of the chain, W_hh[unit][q G + u0 + j] as stored, so
// a chain is ceil(G/20) blocks (32 at G 640) and the card holds 4 chains at
// once: R 8 runs as two chain groups (planned by the wrapper,
// ops/lstm_cuda.py:scan_wide_plan).  A thread of the block's 320 owns
// units tid and tid + 320 of the chain (so G <= 640), with W of the
// block's first SBW_CREG columns in registers (96 of its 168) and of the
// rest in shared memory (80 KiB).  Each column feeds 2 x rows FMAs from one
// broadcast of its dg rows, in passes of 8 rows.  The cells: (unit u0 +
// tid % 20, row tid / 20), one a thread.  The exchange is the partial one:
// a block publishes its columns' share of dh for every unit and row (G
// tagged words a row), and a cell adds the shares of its unit from every
// block of the chain in block order, 8 words in flight.  The step follows
// the exchange (80 KiB written and 80 read a block and step at 16 rows): a
// form with four units a thread against half the columns, which halved the
// dg reads of shared memory, took the same time (5.32 against 5.30-5.39 ms
// at T 256, R 8, B 16, G 640), and 11 % more with its exchange stores half
// coalesced (PERF.md, PR 21).
//
// Its order of summation: a (unit, row) partial over the block's 80
// columns in ascending c from 0 by f32 FMA, the partials in block order.
// That is the other forms' order with blocks of 20 units in place of 32:
// its own bits, fixed by G alone (never by B, the row group, the chain
// group or what runs beside it, so a row is bit-equal to itself run
// alone), within the f32 rounding of the other forms' (the streaming form
// stays its yardstick by name, _form="streaming").  A block is declared
// with launch bounds of 384 threads so that ptxas keeps a thread within the
// 168 registers a thread of a 10-warp block may have on an H100.
constexpr int SBW_UNITS = 20;                       // hidden units a block owns
constexpr int SBW_COLS = 4 * SBW_UNITS;             // its gate columns
constexpr int SBW_THREADS = 320;
constexpr int SBW_BOUND_THREADS = 384;              // launch bounds: 168 registers a thread
constexpr int SBW_UPT = 2;                          // units a thread owns in the product
constexpr int SBW_CREG = 48;                        // block columns with W in registers
constexpr int SBW_PASS = 8;                         // rows of one pass
constexpr int SBW_POLL = 8;                         // exchange words in flight a cell
constexpr int SBW_G_MAX = SBW_THREADS * SBW_UPT;    // 640

// Dynamic shared memory of the wide form: W of the columns beyond SBW_CREG
// (a float2 of the thread's two units a column) and two buffers of dg
// (80 x rt f32, column-major), by step parity.
size_t sbw_smem(int rt) {
  return sizeof(float2) * (size_t)(SBW_COLS - SBW_CREG) * SBW_THREADS +
         sizeof(float) * 2 * (size_t)SBW_COLS * rt;
}

// grid = (ceil(G/20), chains of this launch), SBW_THREADS threads, 512 < G
// <= 640.  RT: the row tile, a power of two >= nb.  Dynamic shared memory
// sbw_smem(RT).  hx: exchange words (R, 2, ceil(G/20), SB_ROWS, G); the
// contract of lstm_scan_bwd_kernel, W_hh as stored (R, G, 4G).
template <typename W, int RT>
__global__ void __launch_bounds__(SBW_BOUND_THREADS, 1)
lstm_scan_bwd_wide_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                          const float* __restrict__ c0, const W* __restrict__ whh,
                          const float* __restrict__ dhs, const float* __restrict__ dhT,
                          float* __restrict__ dc, float* __restrict__ dxp,
                          float* __restrict__ dh0, unsigned long long* hx, int T, int R, int B,
                          int b0, int nb, int G, int r0, unsigned tag0) {
  constexpr int RP = RT < SBW_PASS ? RT : SBW_PASS;  // rows of a pass
  constexpr int NP = RT / RP;                         // passes
  extern __shared__ __align__(16) float smem[];
  float2* w_s = reinterpret_cast<float2*>(smem);                        // [c - CREG][tid]
  float* dg_s = smem + (size_t)2 * (SBW_COLS - SBW_CREG) * SBW_THREADS;  // [par][c * RT + b]
  const int tid = threadIdx.x;
  const int r = r0 + blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int u0 = blk * SBW_UNITS;
  const int nj = min(SBW_UNITS, G - u0);  // the block's units: its columns of each gate
  const int G4 = 4 * G;
  const size_t RB = (size_t)R * B;

  // the product's role: units tid and tid + 320 of the chain against the
  // block's columns c = 20 q + j, upcast to f32, for all T steps
  const W* w_r = whh + (size_t)r * G * G4 + u0;
  auto w_at = [&](int unit, int c) {
    return unit < G && (c % SBW_UNITS) < nj
               ? load_w(w_r + (size_t)unit * G4 + (size_t)(c / SBW_UNITS) * G + c % SBW_UNITS)
               : 0.0f;
  };
  float2 wr[SBW_CREG];
#pragma unroll
  for (int c = 0; c < SBW_CREG; ++c)
    wr[c] = make_float2(w_at(tid, c), w_at(tid + SBW_THREADS, c));
  for (int c = SBW_CREG; c < SBW_COLS; ++c)
    w_s[(size_t)(c - SBW_CREG) * SBW_THREADS + tid] =
        make_float2(w_at(tid, c), w_at(tid + SBW_THREADS, c));
  for (int i = tid; i < 2 * SBW_COLS * RT; i += SBW_THREADS) dg_s[i] = 0.0f;

  // the cell's role: unit u0 + cj of row cb
  const int cj = tid % SBW_UNITS;
  const int cb = tid / SBW_UNITS;
  const bool ok = cb < nb && cj < nj;
  const size_t row = (size_t)r * B + b0 + cb;
  const int u = u0 + cj;
  float dcl = 0.0f, carry = 0.0f;
  float gi = 0.0f, gf = 0.0f, gg = 0.0f, go = 0.0f, cst = 0.0f, cprev = 0.0f, dhst = 0.0f;
  if (ok) {
    dcl = dc[row * G + u];
    carry = dhT[row * G + u];
  }
  // this step's residuals and cotangent: they do not depend on the carry
  auto load_step = [&](int t) {
    if (ok) {
      const float* g4 = gates + ((size_t)t * RB + row) * G4 + u;
      gi = g4[0];
      gf = g4[G];
      gg = g4[2 * G];
      go = g4[3 * G];
      cst = cs[((size_t)t * RB + row) * G + u];
      cprev = t > 0 ? cs[((size_t)(t - 1) * RB + row) * G + u] : c0[row * G + u];
      dhst = dhs[((size_t)t * RB + row) * G + u];
      if (t >= 2) {
        // two steps ahead into L2, so that no poll queues behind a load
        // from device memory
        const size_t o2 = (size_t)(t - 2) * RB + row;
#pragma unroll
        for (int q = 0; q < 4; ++q) prefetch_l2(gates + o2 * G4 + (size_t)q * G + u);
        prefetch_l2(cs + o2 * G + u);
        if (t >= 3) prefetch_l2(cs + (o2 - RB) * G + u);
        prefetch_l2(dhs + o2 * G + u);
      }
    }
  };
  load_step(T - 1);
  __syncthreads();

  unsigned long long* hx_r = hx + (size_t)r * 2 * SB_ROWS * nblk * G;

  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    const int par = i & 1;
    const unsigned tag = tag0 + (unsigned)i + 1u;
    float* dgb = dg_s + (size_t)par * SBW_COLS * RT;

    // the cell: dg of the pair's four columns, dxp, the dc carry
    if (ok) {
      const float tc = tanhf(cst);
      const float dh = __fadd_rn(carry, dhst);
      const float dov = __fmul_rn(dh, tc);
      const float dct =
          __fadd_rn(dcl, __fmul_rn(__fmul_rn(dh, go), __fsub_rn(1.0f, __fmul_rn(tc, tc))));
      float dg[4];
      dg[0] = __fmul_rn(__fmul_rn(__fmul_rn(dct, gg), gi), __fsub_rn(1.0f, gi));
      dg[1] = __fmul_rn(__fmul_rn(__fmul_rn(dct, cprev), gf), __fsub_rn(1.0f, gf));
      dg[2] = __fmul_rn(__fmul_rn(dct, gi), __fsub_rn(1.0f, __fmul_rn(gg, gg)));
      dg[3] = __fmul_rn(__fmul_rn(dov, go), __fsub_rn(1.0f, go));
      dcl = __fmul_rn(dct, gf);
      float* dx = dxp + ((size_t)t * RB + row) * G4 + u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dx[(size_t)q * G] = dg[q];
        dgb[(q * SBW_UNITS + cj) * RT + cb] = dg[q];
      }
    }
    if (t > 0) load_step(t - 1);  // in flight while the product and the exchange run
    __syncthreads();  // the block's dg is in

    // units tid and tid + 320 against the block's columns, ascending c
    // (columns of units beyond G hold zero W and zero dg: a sum starts at
    // +0, is never -0, and adding +0 leaves its bits as they are)
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      float acc[SBW_UPT][RP];
#pragma unroll
      for (int b = 0; b < RP; ++b) acc[0][b] = acc[1][b] = 0.0f;
      const float* dp = dgb + n * RP;
#pragma unroll
      for (int c = 0; c < SBW_CREG; ++c) {
        fma_rows<RP>(acc[0], wr[c].x, dp + c * RT);
        fma_rows<RP>(acc[1], wr[c].y, dp + c * RT);
      }
#pragma unroll 8
      for (int c = SBW_CREG; c < SBW_COLS; ++c) {
        const float2 w = w_s[(size_t)(c - SBW_CREG) * SBW_THREADS + tid];
        fma_rows<RP>(acc[0], w.x, dp + c * RT);
        fma_rows<RP>(acc[1], w.y, dp + c * RT);
      }
#pragma unroll
      for (int m = 0; m < SBW_UPT; ++m) {
        const int unit = tid + m * SBW_THREADS;
        if (unit < G) {
          volatile unsigned long long* dst =
              hx_r + (((size_t)par * nblk + blk) * SB_ROWS + n * RP) * G + unit;
#pragma unroll
          for (int b = 0; b < RP; ++b)
            if (n * RP + b < nb) dst[(size_t)b * G] = tagged(tag, acc[m][b]);
        }
      }
    }

    // the cell's partials from every block of the chain, added in block
    // order: the first word alone while waiting (one load a thread in
    // flight), then SBW_POLL at once, again for those without this step's
    // tag, until none is left
    if (ok) {
      const volatile unsigned long long* w =
          hx_r + (size_t)par * nblk * SB_ROWS * G + (size_t)cb * G + u;
      const size_t stride = (size_t)SB_ROWS * G;  // from one block's slice to the next
      const unsigned long long ready = (unsigned long long)tag << 32;
      unsigned polls = 0;
      unsigned long long v0 = w[0];
      while ((unsigned)(v0 >> 32) != tag) {
        if (++polls > SB_MAX_POLLS) __trap();
        v0 = w[0];
      }
      float s = __uint_as_float((uint32_t)v0);
      for (int p0 = 1; p0 < nblk; p0 += SBW_POLL) {
        unsigned long long v[SBW_POLL];
#pragma unroll
        for (int e = 0; e < SBW_POLL; ++e) v[e] = p0 + e < nblk ? w[(p0 + e) * stride] : ready;
        for (;;) {
          bool stale = false;
#pragma unroll
          for (int e = 0; e < SBW_POLL; ++e) stale |= (unsigned)(v[e] >> 32) != tag;
          if (!stale) break;
          if (++polls > SB_MAX_POLLS) __trap();
#pragma unroll
          for (int e = 0; e < SBW_POLL; ++e)
            if ((unsigned)(v[e] >> 32) != tag) v[e] = w[(p0 + e) * stride];
        }
#pragma unroll
        for (int e = 0; e < SBW_POLL; ++e)
          if (p0 + e < nblk) s = __fadd_rn(s, __uint_as_float((uint32_t)v[e]));
      }
      carry = s;
    }
  }

  if (ok) {
    dh0[row * G + u] = carry;
    dc[row * G + u] = dcl;
  }
}

template <typename W>
const void* bwd_wide_kernel_rt(int rt) {
  switch (rt) {
    case 1: return (const void*)lstm_scan_bwd_wide_kernel<W, 1>;
    case 2: return (const void*)lstm_scan_bwd_wide_kernel<W, 2>;
    case 4: return (const void*)lstm_scan_bwd_wide_kernel<W, 4>;
    case 8: return (const void*)lstm_scan_bwd_wide_kernel<W, 8>;
    case 16: return (const void*)lstm_scan_bwd_wide_kernel<W, 16>;
    default: return nullptr;
  }
}

// ---- the streaming form's instantiations, and the forms' setup ---------

template <typename W, bool ROUND_DG = false>
const void* bwd_kernel_rt(int rt) {
  switch (rt) {
    case 1: return (const void*)lstm_scan_bwd_kernel<W, 1, ROUND_DG>;
    case 2: return (const void*)lstm_scan_bwd_kernel<W, 2, ROUND_DG>;
    case 4: return (const void*)lstm_scan_bwd_kernel<W, 4, ROUND_DG>;
    case 8: return (const void*)lstm_scan_bwd_kernel<W, 8, ROUND_DG>;
    case 16: return (const void*)lstm_scan_bwd_kernel<W, 16, ROUND_DG>;
    default: return nullptr;
  }
}

// Dynamic shared memory of the streaming form at row tile rt (see the kernel)
size_t bwd_smem(int G, int rt) {
  const size_t nblk = (G + SB_UNITS - 1) / SB_UNITS;
  return sizeof(float) * ((size_t)SB_COLS * rt + nblk * rt * SB_UNITS);
}

// The forms' codes in the entry points: 0 streaming, 1 resident, 2 wide.
constexpr int FORM_STREAMING = 0;
constexpr int FORM_RESIDENT = 1;
constexpr int FORM_WIDE = 2;

// Whether `form` takes width G: the resident form up to 512, the wide form
// above 512 up to SBW_G_MAX, the streaming form any G.
bool form_takes(int form, int G) {
  if (G < 1) return false;
  if (form == FORM_RESIDENT) return G <= RB_G_MAX;
  if (form == FORM_WIDE) return G > RB_G_MAX && G <= SBW_G_MAX;
  return form == FORM_STREAMING;
}

// Hidden units a block of `form` owns.
int form_units(int form) { return form == FORM_WIDE ? SBW_UNITS : SB_UNITS; }

// The instantiation of `form` for row tile rt and W_hh storage (round_dg:
// the streaming merged backward, streaming with bf16 W_hh only), with the
// dynamic shared memory it needs allowed, and its block size;
// cudaErrorInvalidValue for a tile it does not have or a width the form
// does not take.
cudaError_t bwd_kernel(int form, int rt, int whh_bf16, int round_dg, int G, const void** fn,
                       size_t* smem, int* threads) {
  if (!form_takes(form, G)) return cudaErrorInvalidValue;
  if (round_dg) {
    if (form != FORM_STREAMING || !whh_bf16) return cudaErrorInvalidValue;
    *fn = bwd_kernel_rt<__nv_bfloat16, true>(rt);
    *smem = bwd_smem(G, rt);
    *threads = SB_THREADS;
  } else if (form == FORM_RESIDENT) {
    *fn = whh_bf16 ? bwd_resident_kernel_rt<__nv_bfloat16>(rt) : bwd_resident_kernel_rt<float>(rt);
    *smem = rb_smem(rt);
    *threads = RB_THREADS;
  } else if (form == FORM_WIDE) {
    *fn = whh_bf16 ? bwd_wide_kernel_rt<__nv_bfloat16>(rt) : bwd_wide_kernel_rt<float>(rt);
    *smem = sbw_smem(rt);
    *threads = SBW_THREADS;
  } else {
    *fn = whh_bf16 ? bwd_kernel_rt<__nv_bfloat16>(rt) : bwd_kernel_rt<float>(rt);
    *smem = bwd_smem(G, rt);
    *threads = SB_THREADS;
  }
  if (*fn == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// K11's launch geometry on the current device in `form` (FORM_*) at width
// G, W_hh in bf16 (whh_bf16 = 1) or f32: `rows`, the largest row tile (16,
// 8, 4, 2 or 1) whose shared memory a block may have, and `blocks`, how
// many blocks of that tile the device holds at once.  rows = 0 where not
// even one row fits.  At that tile, `smem`: the dynamic shared memory a
// block asks for, and `w_regs`: the bytes of a full block's share of W_hh
// (its gate columns x G, f32) that stay in registers (the rest is in
// shared memory; 0 in the streaming form).  Returns the first CUDA error;
// cudaErrorInvalidConfiguration where the device has no cooperative launch.
// round_dg: the streaming merged backward's instantiation (umx_lstm_bwd_wide).
int bwd_capacity(int form, int G, int whh_bf16, int round_dg, int* rows, int* blocks,
                 int* smem, int* w_regs) {
  int dev = 0, sms = 0, coop = 0, smem_max = 0;
  *rows = 0;
  *blocks = 0;
  *smem = 0;
  *w_regs = 0;
  if (!form_takes(form, G)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorInvalidConfiguration;
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  for (int rt = SB_ROWS; rt >= 1; rt /= 2) {
    const size_t need = form == FORM_RESIDENT ? rb_smem(rt)
                        : form == FORM_WIDE   ? sbw_smem(rt)
                                              : bwd_smem(G, rt);
    if (need > (size_t)smem_max) continue;
    const void* fn = nullptr;
    size_t bytes = 0;
    int per_sm = 0, threads = 0;
    e = bwd_kernel(form, rt, whh_bf16, round_dg, G, &fn, &bytes, &threads);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, bytes);
    if (e != cudaSuccess) return (int)e;
    *rows = rt;
    *blocks = per_sm * sms;
    *smem = (int)bytes;
    // every unit's first columns
    *w_regs = form == FORM_RESIDENT ? (int)sizeof(float) * RB_CREG * G
              : form == FORM_WIDE   ? (int)sizeof(float) * SBW_CREG * G
                                    : 0;
    return (int)cudaSuccess;
  }
  return (int)cudaSuccess;
}

int bwd_launch(int form, int round_dg, const float* gates, const float* cs, const float* c0,
               const void* whh, int whh_bf16, const float* dhs, const float* dhT, float* dc,
               float* dxp, float* dh0, void* hx, int T, int R, int B, int G, int r0, int nr,
               int b0, int nb, int rt, unsigned tag0, void* stream) {
  if (G < 1 || T < 1 || B < 1 || nb < 1 || nb > rt || rt > SB_ROWS || b0 < 0 ||
      b0 + nb > B || nr < 1 || r0 < 0 || r0 + nr > R)
    return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  size_t smem = 0;
  int threads = 0;
  cudaError_t e = bwd_kernel(form, rt, whh_bf16, round_dg, G, &fn, &smem, &threads);
  if (e != cudaSuccess) return (int)e;
  unsigned long long* hxp = static_cast<unsigned long long*>(hx);
  void* args[] = {&gates, &cs, &c0, &whh, &dhs, &dhT, &dc, &dxp, &dh0, &hxp, &T, &R, &B,
                  &b0, &nb, &G, &r0, &tag0};
  const int units = form_units(form);
  const dim3 grid((G + units - 1) / units, nr);
  e = cudaLaunchCooperativeKernel(fn, grid, dim3(threads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// form: 0 streaming, 1 resident, 2 wide (bwd_capacity)
extern "C" int umx_lstm_scan_bwd_capacity(int form, int G, int whh_bf16, int* rows,
                                          int* blocks, int* smem, int* w_regs) {
  return bwd_capacity(form, G, whh_bf16, 0, rows, blocks, smem, w_regs);
}

// The streaming merged backward's launch geometry (umx_lstm_scan_bwd_capacity
// of the streaming form with bf16 W_hh and rounded dg).
extern "C" int umx_lstm_bwd_wide_capacity(int G, int* rows, int* blocks, int* smem,
                                          int* w_regs) {
  return bwd_capacity(FORM_STREAMING, G, 1, 1, rows, blocks, smem, w_regs);
}

// K11: one launch in the form asked for (0 streaming, 1 resident, 2 wide),
// the whole reverse sweep of chains [r0, r0 + nr) and rows [b0, b0 + nb)
// of each, nb <= rt <= 16, rt a power of two.  `whh` is W_hh as stored,
// (R, G, 4G), in the resident and wide forms, and transposed, (R, 4G, G),
// in the streaming form.  `dc` holds dcT on entry and dc0 on return for
// those rows.  `hx` is the exchange buffer (R * 2 * ceil(G/U) * 16 * G
// words, U = 20 units a block in the wide form, 32 else), zeroed
// before the layer's first launch; `tag0` is the number of steps earlier
// launches ran on it.  Returns the first CUDA error.
extern "C" int umx_lstm_scan_bwd(int form, const float* gates, const float* cs,
                                 const float* c0, const void* whh, int whh_bf16,
                                 const float* dhs, const float* dhT, float* dc, float* dxp,
                                 float* dh0, void* hx, int T, int R, int B, int G, int r0, int nr,
                                 int b0, int nb, int rt, unsigned tag0, void* stream) {
  return bwd_launch(form, 0, gates, cs, c0, whh, whh_bf16, dhs, dhT, dc, dxp, dh0, hx, T, R,
                    B, G, r0, nr, b0, nb, rt, tag0, stream);
}

// The streaming merged backward (K5 above the widest G of its block form in
// lstm_train.cu, and that form's yardstick): umx_lstm_scan_bwd's streaming
// launch with wt = W_hh transposed, (R, 4G, G) bf16, and dg rounded to bf16
// for the product.  The arguments and the exchange buffer are
// umx_lstm_scan_bwd's.
extern "C" int umx_lstm_bwd_wide(const float* gates, const float* cs, const float* c0,
                                 const void* wt, const float* dhs, const float* dhT, float* dc,
                                 float* dxp, float* dh0, void* hx, int T, int R, int B, int G,
                                 int r0, int nr, int b0, int nb, int rt, unsigned tag0,
                                 void* stream) {
  return bwd_launch(FORM_STREAMING, 1, gates, cs, c0, wt, 1, dhs, dhT, dc, dxp, dh0, hx, T, R, B,
                    G, r0, nr, b0, nb, rt, tag0, stream);
}
