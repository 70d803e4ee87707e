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
// the register file (K1's answer, for bf16 W_hh at G <= 512).  So W_hh is
// read from L2 (from device memory where it does not fit, as at G = 640,
// 52.4 MB) every step, and a step costs that read plus one exchange of h.
// The bytes of the layer (xp, hs and W_hh once) would take ~0.07 ms; the
// steps' reads of W_hh take microseconds each.
//
// The form (K1's, lstm_merged.cu): ONE cooperative launch runs all T steps
// of all chains and up to 16 rows per chain.  A chain is split over
// ceil(G/32) blocks of 512 threads; a block owns 32 hidden units, that is
// 128 gate columns (i|f|g|o x 32 units).  Each step a thread owns one
// column and a quarter of the k range: it streams its column of W_hh
// (a warp reads 32 neighbouring columns of one k, one 128-byte line in
// float32) and keeps one f32 accumulator per row, fed from h in shared
// memory (one broadcast a k); the four quarters are summed in a fixed
// order.  So a row's sums have the same order whatever B is, whatever rows
// or chains run beside it, and whatever row group it falls in: a row is
// bit-equal to itself run alone.  Then a thread per (unit, row) applies
// the cell, keeps c and h in registers, and publishes h_t.
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

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

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
// launch.
template <typename W, int RT, bool RESID>
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
    h_s[k * RT + b] = h0[((size_t)r * B + b0 + b) * G + k];
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
            h_s[(i - b * G) * RT + b] = __uint_as_float((uint32_t)v[e]);
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

template <typename W, bool RESID>
const void* scan_kernel_rt(int rt) {
  switch (rt) {
    case 1: return (const void*)lstm_scan_kernel<W, 1, RESID>;
    case 2: return (const void*)lstm_scan_kernel<W, 2, RESID>;
    case 4: return (const void*)lstm_scan_kernel<W, 4, RESID>;
    case 8: return (const void*)lstm_scan_kernel<W, 8, RESID>;
    case 16: return (const void*)lstm_scan_kernel<W, 16, RESID>;
    default: return nullptr;
  }
}

// Dynamic shared memory at row tile rt: h (G x rt f32, k-major) and the
// quarters' sums (SCAN_PARTS x rt x 128 f32).
size_t scan_smem(int G, int rt) {
  return sizeof(float) * ((size_t)G * rt + (size_t)SCAN_PARTS * rt * SCAN_COLS);
}

// The instantiation for row tile rt, W_hh storage and the residual flag,
// with the dynamic shared memory it needs allowed; nullptr for a tile it
// does not have.
cudaError_t scan_kernel(int rt, int whh_bf16, int resid, int G, const void** fn, size_t* smem) {
  if (resid)
    *fn = whh_bf16 ? scan_kernel_rt<__nv_bfloat16, true>(rt) : scan_kernel_rt<float, true>(rt);
  else
    *fn = whh_bf16 ? scan_kernel_rt<__nv_bfloat16, false>(rt) : scan_kernel_rt<float, false>(rt);
  if (*fn == nullptr || G < 1) return cudaErrorInvalidValue;
  *smem = scan_smem(G, rt);
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace

// K10's launch geometry on the current device at width G, W_hh in bf16
// (whh_bf16 = 1) or f32, with the residual stores (resid = 1) or not: `rows`, the largest row tile (16, 8, 4, 2 or 1)
// whose shared memory a block may have, and `blocks`, how many blocks of
// that tile the device holds at once (what a cooperative launch may ask
// for; a smaller tile needs less and fits as many).  rows = 0 where not even
// one row of h fits.  Returns the first CUDA error;
// cudaErrorInvalidConfiguration where the device has no cooperative launch.
extern "C" int umx_lstm_scan_capacity(int G, int whh_bf16, int resid, int* rows, int* blocks) {
  int dev = 0, sms = 0, coop = 0, smem_max = 0;
  *rows = 0;
  *blocks = 0;
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
    if (scan_smem(G, rt) > (size_t)smem_max) continue;
    const void* fn = nullptr;
    size_t smem = 0;
    int per_sm = 0;
    e = scan_kernel(rt, whh_bf16, resid, G, &fn, &smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, SCAN_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    *rows = rt;
    *blocks = per_sm * sms;
    return (int)cudaSuccess;
  }
  return (int)cudaSuccess;
}

namespace {

int scan_launch(const float* xp, const void* whh, int whh_bf16, const float* h0, float* c,
                float* hs, float* hT, float* gates, float* cs, void* hx, int T, int R, int B,
                int G, int r0, int nr, int b0, int nb, int rt, unsigned tag0, void* stream) {
  if (G < 1 || T < 1 || B < 1 || nb < 1 || nb > rt || rt > SCAN_ROWS || b0 < 0 ||
      b0 + nb > B || nr < 1 || r0 < 0 || r0 + nr > R)
    return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  size_t smem = 0;
  cudaError_t e = scan_kernel(rt, whh_bf16, gates != nullptr, G, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  unsigned long long* hxp = static_cast<unsigned long long*>(hx);
  void* args[] = {&xp, &whh, &h0, &c, &hs, &hT, &gates, &cs, &hxp, &T, &R, &B,
                  &b0, &nb, &G, &r0, &tag0};
  const dim3 grid((G + SCAN_UNITS - 1) / SCAN_UNITS, nr);
  e = cudaLaunchCooperativeKernel(fn, grid, dim3(SCAN_THREADS), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// K10: one launch, all T steps of chains [r0, r0 + nr) and rows
// [b0, b0 + nb) of each, nb <= rt <= 16, rt a power of two.  `c` holds c0 on
// entry and cT on return for those rows.  `hx` is the exchange buffer,
// R * 2 * 16 * G 64-bit words, zeroed before the layer's first launch;
// `tag0` is the number of steps earlier launches ran on the same buffer.
// Returns the first CUDA error.
extern "C" int umx_lstm_scan(const float* xp, const void* whh, int whh_bf16, const float* h0,
                             float* c, float* hs, float* hT, void* hx, int T, int R, int B, int G,
                             int r0, int nr, int b0, int nb, int rt, unsigned tag0,
                             void* stream) {
  return scan_launch(xp, whh, whh_bf16, h0, c, hs, hT, nullptr, nullptr, hx, T, R, B, G, r0, nr,
                     b0, nb, rt, tag0, stream);
}

// K10 with the residual stores: umx_lstm_scan plus the activated gates
// (T, R*B, 4G) and c (T, R*B, G) of every step of those chains and rows.
extern "C" int umx_lstm_scan_train(const float* xp, const void* whh, int whh_bf16,
                                   const float* h0, float* c, float* hs, float* hT, float* gates,
                                   float* cs, void* hx, int T, int R, int B, int G, int r0,
                                   int nr, int b0, int nb, int rt, unsigned tag0, void* stream) {
  if (gates == nullptr || cs == nullptr) return (int)cudaErrorInvalidValue;
  return scan_launch(xp, whh, whh_bf16, h0, c, hs, hT, gates, cs, hx, T, R, B, G, r0, nr, b0, nb,
                     rt, tag0, stream);
}
