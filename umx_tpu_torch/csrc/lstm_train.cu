// Backward of the merged BLSTM layer: the reverse-time step (K5) and the
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
// K5, the reverse step.  What bounds it: like the forward, each step needs
// all of W_hh (16.8 MB at UMX-L) against B rows, serially in time; at the
// training batch (B = 16) a step is 134 M multiply-adds on the CUDA cores.
// Design: one grid per step, launched T + 1 times from the loop in
// umx_lstm_bwd.  grid = (R, ceil(G/UNITS)), a block owns UNITS hidden
// units of one chain; each warp owns UPW of them.  The gate cotangent of a
// unit needs only that unit's values, so the launch that forms
// dh_carry for its units goes straight on to their gate cotangents of the
// next (earlier) step: it writes dxp there in f32, bf16(dg) into a global
// (RB, 4G) buffer, and the dc carry in place (each unit has one owner).
// The next launch forms dh_carry = bf16(dg) . W^T: a unit's W_hh row is
// 4G contiguous bf16, read with 16-byte loads by the 32 lanes of its warp
// against the chain's bf16(dg) rows (L1-resident, shared by the block's
// warps), and reduced with warp shuffles.  Every block reads the whole of
// its chain's dg while other blocks write the next one, so the dg buffer
// is a ping-pong pair.  Nothing in shared memory grows with G; B*UNITS
// floats hold the block's dh_carry between the two phases.
//
// K6, the weight gradient.  What bounds it: 2 * R*G*4G*T*B flops (69 GFLOP
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
// K5 measured on an H100 SXM at 700 W at the UMX-L training shape (T = 256,
// R = 8, B = 16, G = 512): 11.6 ms per layer (45 us per step).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int VEC = 8;        // bf16 per 16-byte load
constexpr int WARPS = 8;      // warps per K5 block
constexpr int UPW = 4;        // hidden units per warp
constexpr int UNITS = WARPS * UPW;
constexpr int ROWS = 8;       // batch rows per pass over a W_hh row

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < VEC / 2; ++e) {
    const float2 f = __bfloat1622float2(pair[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

// One launch: [dh_carry of the block's units from dg_in] then [gate
// cotangents of step tp for those units].  dg_in == null: the carry is
// dh_in (dhT, first launch).  dh_out != null: the carry is written there
// (dh0, last launch) and no step follows.
__global__ void lstm_bwd_step_kernel(const __nv_bfloat16* __restrict__ dg_in,  // (RB, 4G)
                                     const float* __restrict__ dh_in,          // (RB, G)
                                     const __nv_bfloat16* __restrict__ whh,    // (R, G, 4G)
                                     const float* __restrict__ dhs_p,          // (RB, G)
                                     const float* __restrict__ gates_p,        // (RB, 4G)
                                     const float* __restrict__ cs_p,           // (RB, G)
                                     const float* __restrict__ cprev_p,        // (RB, G)
                                     float* __restrict__ dc,                   // (RB, G)
                                     float* __restrict__ dxp_p,                // (RB, 4G)
                                     __nv_bfloat16* __restrict__ dg_out,       // (RB, 4G)
                                     float* __restrict__ dh_out,               // (RB, G)
                                     int B, int G) {
  extern __shared__ float dh_s[];  // (B, UNITS)
  const int r = blockIdx.x;
  const int u0 = blockIdx.y * UNITS;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int nthreads = 32 * WARPS;
  const int G4 = 4 * G;
  const size_t rb0 = (size_t)r * B;

  if (dg_in != nullptr) {
    const int wu0 = u0 + warp * UPW;  // this warp's first unit
    const uint4* wrow[UPW];
#pragma unroll
    for (int p = 0; p < UPW; ++p) {
      const int u = min(wu0 + p, G - 1);  // clamped rows are computed and dropped
      wrow[p] = reinterpret_cast<const uint4*>(whh + ((size_t)r * G + u) * G4);
    }
    if (wu0 < G) {
      for (int b0 = 0; b0 < B; b0 += ROWS) {
        const int nb = min(ROWS, B - b0);
        float acc[UPW][ROWS];
#pragma unroll
        for (int p = 0; p < UPW; ++p)
#pragma unroll
          for (int j = 0; j < ROWS; ++j) acc[p][j] = 0.0f;
        for (int c = lane * VEC; c < G4; c += 32 * VEC) {
          float wv[UPW][VEC];
#pragma unroll
          for (int p = 0; p < UPW; ++p) unpack8(__ldg(wrow[p] + c / VEC), wv[p]);
#pragma unroll
          for (int j = 0; j < ROWS; ++j) {
            if (j < nb) {
              float dv[VEC];
              unpack8(__ldg(reinterpret_cast<const uint4*>(dg_in + (rb0 + b0 + j) * G4 + c)), dv);
#pragma unroll
              for (int p = 0; p < UPW; ++p)
#pragma unroll
                for (int e = 0; e < VEC; ++e) acc[p][j] += dv[e] * wv[p][e];
            }
          }
        }
#pragma unroll
        for (int p = 0; p < UPW; ++p)
#pragma unroll
          for (int j = 0; j < ROWS; ++j)
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              acc[p][j] += __shfl_xor_sync(0xffffffffu, acc[p][j], off);
        if (lane == 0) {
#pragma unroll
          for (int p = 0; p < UPW; ++p)
#pragma unroll
            for (int j = 0; j < ROWS; ++j)
              if (j < nb) dh_s[(b0 + j) * UNITS + warp * UPW + p] = acc[p][j];
        }
      }
    }
  } else {
    for (int i = tid; i < B * UNITS; i += nthreads) {
      const int u = u0 + i % UNITS;
      if (u < G) dh_s[i] = dh_in[(rb0 + i / UNITS) * G + u];
    }
  }
  __syncthreads();

  for (int i = tid; i < B * UNITS; i += nthreads) {
    const int u = u0 + i % UNITS;
    if (u >= G) continue;
    const size_t row = rb0 + i / UNITS;
    const size_t ci = row * G + u;
    if (dh_out != nullptr) {
      dh_out[ci] = dh_s[i];
      continue;
    }
    const float dh = dh_s[i] + dhs_p[ci];
    const float* g4 = gates_p + row * G4 + u;
    const float ig = g4[0];
    const float fg = g4[(size_t)G];
    const float gg = g4[2 * (size_t)G];
    const float og = g4[3 * (size_t)G];
    const float tc = tanhf(cs_p[ci]);
    const float do_ = dh * tc;
    const float dct = dc[ci] + dh * og * (1.0f - tc * tc);
    float dg[4];
    dg[0] = dct * gg * ig * (1.0f - ig);
    dg[1] = dct * cprev_p[ci] * fg * (1.0f - fg);
    dg[2] = dct * ig * (1.0f - gg * gg);
    dg[3] = do_ * og * (1.0f - og);
    float* dx = dxp_p + row * G4 + u;
    __nv_bfloat16* db = dg_out + row * G4 + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dx[q * (size_t)G] = dg[q];
      db[q * (size_t)G] = __float2bfloat16(dg[q]);
    }
    dc[ci] = dct * fg;
  }
}

constexpr int DW_BM = 128;      // dW rows (hidden units) per K6 block
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

}  // namespace

// K5: the reverse sweep, T + 1 launches on `stream`.  `dc` holds dcT on
// entry and dc0 on return; `dgbuf` is bf16 scratch of 2 * RB * 4G.
// Returns the first CUDA error.
extern "C" int umx_lstm_bwd(const float* gates, const float* cs, const float* c0,
                            const void* whh, const float* dhs, const float* dhT, float* dc,
                            float* dxp, float* dh0, void* dgbuf, int T, int R, int B, int G,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G % VEC != 0 || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(R, (G + UNITS - 1) / UNITS);
  const dim3 block(32, WARPS);
  const size_t smem = (size_t)B * UNITS * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_bwd_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t rbg = (size_t)R * B * G;
  const size_t rbg4 = 4 * rbg;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(whh);
  __nv_bfloat16* dgb = static_cast<__nv_bfloat16*>(dgbuf);
  // launch tp computes the gate cotangents of step tp into dgb[tp & 1]
  // (from the carry of step tp + 1), then launch tp - 1 reads them
  for (int tp = T - 1; tp >= -1; --tp) {
    const __nv_bfloat16* dg_in = tp == T - 1 ? nullptr : dgb + (size_t)((tp + 1) & 1) * rbg4;
    const bool last = tp < 0;
    lstm_bwd_step_kernel<<<grid, block, smem, st>>>(
        dg_in, dhT, w,
        last ? nullptr : dhs + (size_t)tp * rbg,
        last ? nullptr : gates + (size_t)tp * rbg4,
        last ? nullptr : cs + (size_t)tp * rbg,
        last ? nullptr : (tp == 0 ? c0 : cs + (size_t)(tp - 1) * rbg),
        dc,
        last ? nullptr : dxp + (size_t)tp * rbg4,
        last ? nullptr : dgb + (size_t)(tp & 1) * rbg4,
        last ? dh0 : nullptr, B, G);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
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
