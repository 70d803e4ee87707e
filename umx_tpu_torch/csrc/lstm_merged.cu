// Merged BLSTM recurrence for one LSTM layer, all chains at once.
//
// Replaces: umx_tpu/ops/lstm_pallas.py:_make_merged_kernel (reached via
// lstm_layer_pallas_merged), the TPU kernel that runs the recurrence of
// all targets x directions of one layer with every chain's W_hh resident
// in VMEM.
//
// Contract (same as the TPU kernel): R = T#*D independent chains, each
// with B batch rows; rows are chain-major, row = r*B + b.
//   xp  (T, R*B, 4G) f32   input projections + both biases, gate order i|f|g|o
//   whh (R, G, 4G)   bf16  hidden-hidden weights, contracted over G
//   h0, c0 (R*B, G)  f32
// Per step:  gates = xp_t + bf16(h_{t-1}) . whh[r]   (f32 accumulation)
//            c = sigmoid(f) c + sigmoid(i) tanh(g);  h = sigmoid(o) tanh(c)
// Outputs hs (T, R*B, G), hT (R*B, G) f32; c is updated in place and
// ends as cT.
//
// What bounds it on the H100: the recurrence is serial in time, and each
// step needs the whole of W_hh (UMX-L: 8 x 512 x 2048 bf16 = 16.8 MB, far
// beyond one block's 227 KB of shared memory) against a tiny h (B rows).
// A step is therefore an L2-bandwidth- and latency-bound matrix-vector
// product; the 16.8 MB weight stays resident in the 50 MB L2 across steps.
//
// Design (simple first): one grid per timestep, launched T times from the
// loop in umx_lstm_merged on the caller's stream; the kernel boundary is
// the grid-wide barrier between steps.  grid = (R, ceil(G/UNITS)): a block
// owns UNITS hidden units of one chain and computes their 4 gate columns
// for all B rows.  Each thread reads VEC = 8 neighbouring bf16 columns of
// a W_hh row with one 16-byte load, and KSPLIT threads split the G-long
// dot product; the partial sums are reduced in shared memory, then one
// thread per (row, unit) applies the gates, updates its unit's c in place
// (each unit has exactly one owner) and writes h_t into hs[t].  No time
// blocking, so a ragged last block needs no special case.  Requires
// G % 8 == 0 and a 16-byte aligned W_hh (the wrapper checks both).  A
// persistent, weight-stationary variant (W_hh slices held in shared
// memory across ~128 resident blocks, one grid-wide sync per step) is the
// natural later speed-up.
//
// Block shape: 16 x 32 = 512 threads, 128 blocks at UMX-L.  A step is
// bound by the loads in flight per SM (latency, not L2 bandwidth): on an
// H100 SXM at 700 W a sweep of (UNITS, KSPLIT) gave 8.0 us/step at
// (32, 32) against 11.2 at (32, 16) and 8.7 at (16, 32); one grid launch
// per step costs ~3 us on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int UNITS = 32;                 // hidden units owned by one block
constexpr int COLS = 4 * UNITS;           // gate columns per block (i|f|g|o)
constexpr int VEC = 8;                    // bf16 columns per 16-byte load
constexpr int NVEC = COLS / VEC;          // column vectors per block
constexpr int KSPLIT = 32;                // threads sharing one vector's dot product
constexpr int ROWS = 4;                   // batch rows accumulated per pass over W

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void lstm_step_kernel(const float* __restrict__ xp_t,          // (RB, 4G)
                                 const __nv_bfloat16* __restrict__ whh,   // (R, G, 4G)
                                 const float* __restrict__ h_prev,        // (RB, G)
                                 float* __restrict__ c,                   // (RB, G), in place
                                 float* __restrict__ h_out,               // (RB, G)
                                 int B, int G) {
  extern __shared__ float smem[];
  float* h_s = smem;              // (B, G): bf16-rounded h_{t-1} of this chain
  float* red = smem + B * G;      // (KSPLIT, B, COLS) partial dot products

  const int r = blockIdx.x;
  const int u0 = blockIdx.y * UNITS;
  const int G4 = 4 * G;
  const int nthreads = NVEC * KSPLIT;
  const int tid = threadIdx.y * NVEC + threadIdx.x;

  const float* hp = h_prev + (size_t)r * B * G;
  for (int i = tid; i < B * G; i += nthreads) {
    h_s[i] = __bfloat162float(__float2bfloat16(hp[i]));
  }
  __syncthreads();

  // this thread's 8 columns: gate q, units [ub, ub + 8) (all in or all out
  // of range, since G % 8 == 0)
  const int q = threadIdx.x / (UNITS / VEC);
  const int col = q * UNITS + (threadIdx.x % (UNITS / VEC)) * VEC;  // within the block
  const int ub = u0 + (threadIdx.x % (UNITS / VEC)) * VEC;
  const int kper = (G + KSPLIT - 1) / KSPLIT;
  const int k0 = threadIdx.y * kper;
  const int k1 = min(G, k0 + kper);
  const size_t row_stride = (size_t)G4 / VEC;  // uint4 per W_hh row
  const uint4* w = reinterpret_cast<const uint4*>(whh + (size_t)r * G * G4 + (size_t)q * G + ub);

  for (int b0 = 0; b0 < B; b0 += ROWS) {
    float acc[ROWS][VEC];
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[j][e] = 0.0f;
    if (ub < G) {
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const uint4 raw = __ldg(w + (size_t)k * row_stride);
        const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float wv[VEC];
#pragma unroll
        for (int e = 0; e < VEC / 2; ++e) {
          const float2 f = __bfloat1622float2(pair[e]);
          wv[2 * e] = f.x;
          wv[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          if (b0 + j < B) {
            const float hv = h_s[(b0 + j) * G + k];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[j][e] += hv * wv[e];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (b0 + j < B) {
        float* dst = red + (threadIdx.y * B + b0 + j) * COLS + col;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] = acc[j][e];
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < B * UNITS; i += nthreads) {
    const int b = i / UNITS;
    const int uu = i % UNITS;
    const int u = u0 + uu;
    if (u >= G) continue;
    const size_t row = (size_t)r * B + b;
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float s = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KSPLIT; ++ks) s += red[(ks * B + b) * COLS + g * UNITS + uu];
      gate[g] = xp_t[row * G4 + (size_t)g * G + u] + s;
    }
    const float ig = sigmoidf_(gate[0]);
    const float fg = sigmoidf_(gate[1]);
    const float gg = tanhf(gate[2]);
    const float og = sigmoidf_(gate[3]);
    const size_t ci = row * G + u;
    const float cn = fg * c[ci] + ig * gg;
    c[ci] = cn;
    h_out[ci] = og * tanhf(cn);
  }
}

}  // namespace

extern "C" const char* umx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Runs the whole layer: T step launches on `stream`, then hT <- hs[T-1].
// `c` holds c0 on entry and cT on return.  Returns the first CUDA error.
extern "C" int umx_lstm_merged(const float* xp, const void* whh, const float* h0, float* c,
                               float* hs, float* hT, int T, int R, int B, int G,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(R, (G + UNITS - 1) / UNITS);
  if (G % VEC != 0) return (int)cudaErrorInvalidValue;
  const dim3 block(NVEC, KSPLIT);
  const size_t smem = (size_t)(B * G + KSPLIT * B * COLS) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t rbg = (size_t)R * B * G;
  const size_t step_in = (size_t)R * B * 4 * G;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(whh);
  for (int t = 0; t < T; ++t) {
    const float* hp = t == 0 ? h0 : hs + (size_t)(t - 1) * rbg;
    lstm_step_kernel<<<grid, block, smem, st>>>(xp + (size_t)t * step_in, w, hp, c,
                                                hs + (size_t)t * rbg, B, G);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  cudaMemcpyAsync(hT, hs + (size_t)(T - 1) * rbg, rbg * sizeof(float),
                  cudaMemcpyDeviceToDevice, st);
  return (int)cudaGetLastError();
}
