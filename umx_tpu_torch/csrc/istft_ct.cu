// K8: the fused Cooley-Tukey inverse STFT (window folded, overlap-added).
//
// Replaces umx_tpu/ops/istft_ct.py::istft_ct2_fused (its Pallas kernel).
// For each frame of each row it computes the windowed inverse real DFT
//
//   x[n] = w[n] * Re sum_{k<=N/2} v[k] e^{2 pi i n k / N},  v = c_k X[k] / N,
//
// (c_k = 1 at DC and Nyquist, else 2: the one-sided fold), with the same
// two-stage Cooley-Tukey split as the TPU kernel: k = 128 c + e,
// n = N2 b + a (N2 = N / 128), so nk/N = bc + be/128 + ac/N2 + ae/N and
//
//   stage 1:  U[e, a] = sum_c v[128 c + e] e^{2 pi i a c / N2}   (C = N/256 + 1 rows)
//   twiddle:  T[e, a] = U[e, a] e^{2 pi i a e / N}
//   stage 2:  x[N2 b + a] = Re sum_e T[e, a] e^{2 pi i e b / 128}.
//
// Every phase is a multiple of 2 pi / N, so one N-entry cos/sin table
// (built in float64 by the wrapper, rounded once to float32; 32 KB) serves
// all three steps exactly.
//
// The kernel is built for N = 4096, UMX's transform (N2 = 32), where both
// stages are warp FFTs: a warp takes one column, a 32-point DFT runs across
// its lanes by radix-2 decimation in frequency with __shfl_xor_sync (each
// lane's five stage twiddles live in registers), stage 1 over c for each e
// (lane = c), stage 2 over the 128 e of each a as a radix-4 step in
// registers (e = lane + 32 k) times four such DFTs.
//
// The overlap-add is a second, deterministic gather launch over the frames
// buffer: output sample s of a row sums the N/hop frame pieces that cover
// it, in piece order (as ops/stft.py::overlap_add), at most 4 addends.
//
// What bounds it on the H100: instruction throughput (arithmetic and
// shared-memory loads), not device memory (16 KB of spectrum read and
// 16 KB of frame written per frame).  One block per frame (grid-stride over
// frames, so each block loads the table once): the 2049 bins, the table
// and T live in shared memory (about 84 KB, two blocks per SM).  The bins
// are stored with one pad word per 128 and T with a pad column, so the
// strided lane accesses of both stages are conflict-free; stage 2 writes
// the frame to shared memory (padded likewise) and the block copies it out
// coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int N1 = 128;      // e and b extent
constexpr int THREADS = 256;

// the transform size, its padded bin plane and the frames kernel's shared memory
constexpr int NW = 4096;
constexpr int NW_PLANE = (NW / (2 * N1) + 1) * (N1 + 1);  // bin k at k + k / 128
constexpr size_t FRAMES_SMEM =
    sizeof(float) * (2 * NW + 2 * NW_PLANE + 2 * N1 * (NW / N1 + 1));

// 32-point DFT across a warp's lanes, X[k] = sum_j x[j] e^{2 pi i j k / 32},
// by radix-2 decimation in frequency: lane l holds x[l] on entry and
// X[bitrev5(l)] on return.  twr/twi[s] is this lane's twiddle at stage s
// (half-size h = 16 >> s): e^{2 pi i (l mod h) / (2 h)}; the last stage's is 1.
__device__ __forceinline__ void warp_dft32(float& re, float& im, const float (&twr)[4],
                                           const float (&twi)[4], int lane) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int h = 16 >> s;
    const float pre = __shfl_xor_sync(0xffffffffu, re, h);
    const float pim = __shfl_xor_sync(0xffffffffu, im, h);
    if (lane & h) {
      const float dr = pre - re, di = pim - im;
      if (s < 4) {
        re = dr * twr[s] - di * twi[s];
        im = dr * twi[s] + di * twr[s];
      } else {
        re = dr;
        im = di;
      }
    } else {
      re += pre;
      im += pim;
    }
  }
}

// Both CT stages as warp FFTs (see the header).  re/im (n_frames, F),
// table (2, N): cos, sin of 2 pi i / N, window (N,) or null, frames
// (n_frames, N).
__global__ void __launch_bounds__(THREADS)
istft_ct2_frames_kernel(const float* __restrict__ re, const float* __restrict__ im,
                        const float* __restrict__ table, const float* __restrict__ window,
                        float* __restrict__ frames, int n_frames) {
  constexpr int N = NW, n2 = NW / N1, c_rows = NW / (2 * N1) + 1, F = NW / 2 + 1, ldt = n2 + 1;
  constexpr int WARPS = THREADS / 32;
  extern __shared__ float sm[];
  float* tc = sm;
  float* ts = tc + N;
  float* vre = ts + N;
  float* vim = vre + NW_PLANE;
  float* tre = vim + NW_PLANE;
  float* tim = tre + N1 * ldt;
  float* xbuf = vre;  // the frame after stage 2: N + N/128 floats over vre and vim
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lane_rev = __brev(lane) >> 27;  // bitrev5(lane)
  const float inv_n = 1.0f / (float)N;

  for (int i = threadIdx.x; i < N; i += THREADS) {
    tc[i] = table[i];
    ts[i] = table[N + i];
  }
  float twr[4], twi[4];  // warp_dft32's stage twiddles for this lane
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int h = 16 >> s;
    const int p = (lane & (h - 1)) * (N / (2 * h));
    twr[s] = table[p];
    twi[s] = table[N + p];
  }
  float r4r[4], r4i[4];  // stage 2's e^{2 pi i lane b2 / 128}
#pragma unroll
  for (int b2 = 0; b2 < 4; ++b2) {
    r4r[b2] = table[lane * b2 * n2];
    r4i[b2] = table[N + lane * b2 * n2];
  }

  for (int fr = blockIdx.x; fr < n_frames; fr += gridDim.x) {
    __syncthreads();  // the table is in; the previous frame is copied out
    const float* xr = re + (size_t)fr * F;
    const float* xi = im + (size_t)fr * F;
    for (int k = threadIdx.x; k < c_rows * N1; k += THREADS) {
      float a = 0.0f, b = 0.0f;
      if (k < F) {
        const float w = (k == 0 || k == F - 1) ? inv_n : 2.0f * inv_n;
        a = xr[k] * w;
        b = xi[k] * w;
      }
      vre[k + (k >> 7)] = a;
      vim[k + (k >> 7)] = b;
    }
    __syncthreads();

    // stage 1 + twiddle: a warp per e, lane = c in, lane = bitrev(a) out
    for (int e = warp; e < N1; e += WARPS) {
      float ur = 0.0f, ui = 0.0f;
      if (lane < c_rows) {
        const int k = lane * N1 + e;  // padded: k + k / 128 = k + lane
        ur = vre[k + lane];
        ui = vim[k + lane];
      }
      warp_dft32(ur, ui, twr, twi, lane);
      const int q = lane_rev * e;  // e^{2 pi i a e / N}, a = bitrev5(lane)
      const float cr = tc[q], sr = ts[q];
      tre[e * ldt + lane_rev] = ur * cr - ui * sr;
      tim[e * ldt + lane_rev] = ur * sr + ui * cr;
    }
    __syncthreads();

    // stage 2: a warp per a; e = lane + 32 k, b = 4 bitrev5(lane) + b2
    for (int a = warp; a < n2; a += WARPS) {
      float tr[4], ti[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        tr[k] = tre[(lane + 32 * k) * ldt + a];
        ti[k] = tim[(lane + 32 * k) * ldt + a];
      }
      // radix 4 over k: U[b2] = sum_k t[k] i^(k b2)
      float ur[4], ui[4];
      ur[0] = (tr[0] + tr[2]) + (tr[1] + tr[3]);
      ui[0] = (ti[0] + ti[2]) + (ti[1] + ti[3]);
      ur[1] = (tr[0] - tr[2]) - (ti[1] - ti[3]);
      ui[1] = (ti[0] - ti[2]) + (tr[1] - tr[3]);
      ur[2] = (tr[0] + tr[2]) - (tr[1] + tr[3]);
      ui[2] = (ti[0] + ti[2]) - (ti[1] + ti[3]);
      ur[3] = (tr[0] - tr[2]) + (ti[1] - ti[3]);
      ui[3] = (ti[0] - ti[2]) - (tr[1] - tr[3]);
#pragma unroll
      for (int b2 = 0; b2 < 4; ++b2) {
        float vr = ur[b2] * r4r[b2] - ui[b2] * r4i[b2];
        float vi = ur[b2] * r4i[b2] + ui[b2] * r4r[b2];
        warp_dft32(vr, vi, twr, twi, lane);
        const int n = n2 * (4 * lane_rev + b2) + a;  // n / 128 = lane_rev
        xbuf[n + lane_rev] = vr;
      }
    }
    __syncthreads();

    float* out = frames + (size_t)fr * N;
    for (int n = threadIdx.x; n < N; n += THREADS) {
      float x = xbuf[n + (n >> 7)];
      if (window != nullptr) x *= window[n];
      out[n] = x;
    }
  }
}

// out[r, s] = sum over pieces p (in order) of frames[r, s / hop - p, p*hop + s % hop]
__global__ void istft_ola_kernel(const float* __restrict__ frames,  // (rows, T, N)
                                 float* __restrict__ out,           // (rows, L)
                                 int T, int N, int hop, int L) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= L) return;
  const int r = blockIdx.y;
  const int h = s / hop, j = s - h * hop, pieces = N / hop;
  const float* fr = frames + (size_t)r * T * N;
  float acc = 0.0f;
  for (int p = 0; p < pieces; ++p) {
    const int t = h - p;
    acc += (t >= 0 && t < T) ? fr[(size_t)t * N + p * hop + j] : 0.0f;
  }
  out[(size_t)r * L + s] = acc;
}

}  // namespace

// re/im (rows, T, F) f32 with F = N/2 + 1, table (2, N), window (N,) or null,
// frames (rows, T, N) scratch, out (rows, (T-1)*hop + N).  Needs N = 4096
// and hop = N/4 (checked by the wrapper; refused here as well).
extern "C" int umx_istft_ct2(const float* re, const float* im, const float* table,
                             const float* window, float* frames, float* out, int rows, int T,
                             int F, int N, int hop, int grid, void* stream) {
  if (N != NW || hop * 4 != N || F != N / 2 + 1 || rows < 1 || rows > 65535 || T < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(istft_ct2_frames_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)FRAMES_SMEM);
  if (e != cudaSuccess) return (int)e;
  istft_ct2_frames_kernel<<<grid, THREADS, FRAMES_SMEM, st>>>(re, im, table, window, frames,
                                                              rows * T);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int L = (T - 1) * hop + N;
  const dim3 ola_grid((L + THREADS - 1) / THREADS, rows);
  istft_ola_kernel<<<ola_grid, THREADS, 0, st>>>(frames, out, T, N, hop, L);
  return (int)cudaGetLastError();
}
