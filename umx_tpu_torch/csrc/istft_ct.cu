// K8: the fused Cooley-Tukey inverse STFT (window folded, overlap-added).
//
// Replaces umx_tpu/ops/istft_ct.py::istft_ct2_fused (its Pallas kernel).
// For each frame of each row it computes the windowed inverse real DFT
//
//   x[m] = w[m] / N * Re sum_{k<N} X[k] e^{2 pi i m k / N},  X[N - k] = conj X[k],
//
// from the one-sided bins X[0..N/2] (the imaginary parts of DC and Nyquist
// drop out), and overlap-adds the frames at hop N/4 into the row's signal.
// Built for N = 4096, UMX's transform.
//
// What bounds it on the H100: 16.4 KB of spectrum read and 4 KB of signal
// written per frame put the device-memory bound at 0.76 ms for 48 rows of
// 2584 frames; the arithmetic (about 140 kFLOP a frame) and the exchanges
// through shared memory cost more than that, so the design spends as few
// operations a frame as it can and keeps every intermediate on chip.
//
// Design: one launch, no scratch in device memory.
//   * The Hermitian form.  z[n] = x[2n] + i x[2n+1] is the N/2-point
//     complex inverse of Z[k] = (X[k] + conj X[N/2-k]) + i e^{2 pi i k/N}
//     (X[k] - conj X[N/2-k]): half the arithmetic of a complex transform of
//     N points.  The unpacking phases come from the N-entry cos/sin table
//     (built in float64 by the wrapper, rounded once to float32), as do all
//     twiddles between the passes: exact multiples of 2 pi / N.
//   * 2048 = 16 x 16 x 8, with k = 128 k1 + 8 k2 + k3 and
//     n = n1 + 16 n2 + 256 n3.  A block of 128 threads holds a frame as 16
//     complex points a thread.  Pass 1: thread j = 8 k2 + k3 reads its 16
//     bins (and their mirrors) straight from device memory, coalesced,
//     unpacks, takes the 16-point transform over k1 in registers, applies
//     e^{2 pi i n1 j / 2048} and writes A[n1][j].  Pass 2: thread (n1, k3)
//     transforms over k2, applies e^{2 pi i n2 k3 / 128}, writes
//     B[k3][n2][n1].  Pass 3: a thread transforms two columns (n1, n2) over
//     k3.  The radix-16 and radix-8 butterflies are radix-4 steps with
//     constant twiddles; the two exchanges go through 34 KB of shared
//     memory whose rows are padded (136 and 260 floats) so that every
//     access of a warp is conflict-free.
//   * Overlap-add inside the block.  A block takes a run of consecutive
//     output hops of one row and walks the frames that reach them
//     BACKWARDS: hop h then receives piece 0 of frame h, piece 1 of frame
//     h - 1, piece 2, piece 3: the order in which ops/stft.py::overlap_add
//     sums them, so the result has its bits.  The sums live in a ring of 4
//     hops in shared memory; pass 3 leaves element m of a frame always with
//     the same thread, so each thread owns its ring entries and its window
//     values (no barrier, no conflict), and stores a finished hop once, as
//     8-byte words, a warp 256 contiguous bytes.  A run recomputes the 3
//     frames below its first hop (its halo); no atomics, and the same bits
//     from run to run.
//   * 66.8 KB of shared memory and at most 170 registers a thread (168
//     used, no spills): three blocks an SM.  The wrapper plans the runs
//     (rows x runs per row is about the number of blocks the card holds at
//     once).
//
// Measured on an H100 80GB HBM3 at 700 W: 1.42 ms for 48 rows of 2584
// frames (bound 0.76 ms; torch.istft 9.10 ms; 7.32 ms in the earlier form,
// warp-shuffle transforms into a frames buffer and a second launch for the
// overlap-add), 0.26 ms for 8 rows (bound 0.13 ms; torch.istft 1.66 ms).

#include <cuda_runtime.h>

namespace {

constexpr int NW = 4096;       // the transform size
constexpr int NBINS = NW / 2 + 1;
constexpr int HOP = NW / 4;
constexpr int THREADS = 128;
constexpr int LDA = 136;  // floats per row n1 of pass 1's output (128 j + pad)
constexpr int LDB = 260;  // floats per row k3 of pass 2's output (256 (n2, n1) + pad)
constexpr int RING = 4;   // hops in the overlap-add ring = pieces of a frame
constexpr size_t SMEM_BYTES =
    sizeof(float) * (2 * 16 * LDA + 2 * 8 * LDB) + sizeof(float2) * (RING * 4 + 16) * THREADS;

__device__ __forceinline__ void cmul(float& r, float& i, float c, float s) {
  const float t = r * c - i * s;
  i = r * s + i * c;
  r = t;
}

// (r, i) *= e^{2 pi i M / 16}
template <int M>
__device__ __forceinline__ void rot16(float& r, float& i) {
  constexpr float C1 = 0.923879532511286756f;  // cos(pi / 8)
  constexpr float S1 = 0.382683432365089772f;  // sin(pi / 8)
  constexpr float H = 0.707106781186547524f;   // cos(pi / 4)
  if (M == 4) {
    const float t = r;
    r = -i;
    i = t;
  } else if (M != 0) {
    const float c = M == 1 ? C1 : M == 2 ? H : M == 3 ? S1 : M == 6 ? -H : -C1;
    const float s = M == 1 ? S1 : M == 2 ? H : M == 3 ? C1 : M == 6 ? H : -S1;
    cmul(r, i, c, s);
  }
}

// 4-point inverse transform in place: slot n receives sum_k x[k] i^{n k}
__device__ __forceinline__ void dft4(float& r0, float& i0, float& r1, float& i1, float& r2,
                                     float& i2, float& r3, float& i3) {
  const float sr02 = r0 + r2, si02 = i0 + i2, dr02 = r0 - r2, di02 = i0 - i2;
  const float sr13 = r1 + r3, si13 = i1 + i3, dr13 = r1 - r3, di13 = i1 - i3;
  r0 = sr02 + sr13;
  i0 = si02 + si13;
  r2 = sr02 - sr13;
  i2 = si02 - si13;
  r1 = dr02 - di13;
  i1 = di02 + dr13;
  r3 = dr02 + di13;
  i3 = di02 - dr13;
}

// 16-point inverse transform in place, k = 4 k1 + k2, n = n1 + 4 n2:
// output n is left in slot 4 (n % 4) + n / 4.
__device__ __forceinline__ void dft16(float (&r)[16], float (&i)[16]) {
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2)
    dft4(r[k2], i[k2], r[4 + k2], i[4 + k2], r[8 + k2], i[8 + k2], r[12 + k2], i[12 + k2]);
  // slot 4 n1 + k2 times e^{2 pi i n1 k2 / 16}
  rot16<1>(r[5], i[5]);
  rot16<2>(r[6], i[6]);
  rot16<3>(r[7], i[7]);
  rot16<2>(r[9], i[9]);
  rot16<4>(r[10], i[10]);
  rot16<6>(r[11], i[11]);
  rot16<3>(r[13], i[13]);
  rot16<6>(r[14], i[14]);
  rot16<9>(r[15], i[15]);
#pragma unroll
  for (int n1 = 0; n1 < 4; ++n1)
    dft4(r[4 * n1], i[4 * n1], r[4 * n1 + 1], i[4 * n1 + 1], r[4 * n1 + 2], i[4 * n1 + 2],
         r[4 * n1 + 3], i[4 * n1 + 3]);
}

// 8-point inverse transform in place, k = 2 k1 + k2, n = n1 + 4 n2:
// output n is left in slot 2 (n % 4) + n / 4.
__device__ __forceinline__ void dft8(float (&r)[8], float (&i)[8]) {
  dft4(r[0], i[0], r[2], i[2], r[4], i[4], r[6], i[6]);
  dft4(r[1], i[1], r[3], i[3], r[5], i[5], r[7], i[7]);
  // slot 2 n1 + 1 times e^{2 pi i n1 / 8}
  rot16<2>(r[3], i[3]);
  rot16<4>(r[5], i[5]);
  rot16<6>(r[7], i[7]);
#pragma unroll
  for (int n1 = 0; n1 < 4; ++n1) {
    const float ar = r[2 * n1], ai = i[2 * n1], br = r[2 * n1 + 1], bi = i[2 * n1 + 1];
    r[2 * n1] = ar + br;
    i[2 * n1] = ai + bi;
    r[2 * n1 + 1] = ar - br;
    i[2 * n1 + 1] = ai - bi;
  }
}

// re/im (rows, T, NBINS), table (2, NW): cos, sin of 2 pi i / NW, window
// (NW,) or null, out (rows, (T + 3) HOP).  Block b takes run b % runs_per_row
// of row b / runs_per_row: output hops [a, min(a + hops_per_run, T + 3)).
__global__ void __launch_bounds__(THREADS, 3)
istft_ct2_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 const float* __restrict__ table, const float* __restrict__ window,
                 float* __restrict__ out, int T, int runs_per_row, int hops_per_run) {
  extern __shared__ __align__(16) float sm[];
  float* sAr = sm;
  float* sAi = sAr + 16 * LDA;
  float* sBr = sAi + 16 * LDA;
  float* sBi = sBr + 8 * LDB;
  float2* ring = reinterpret_cast<float2*>(sBi + 8 * LDB);  // (RING, 4, THREADS)
  float2* win = ring + RING * 4 * THREADS;                  // (16, THREADS)

  const int tid = threadIdx.x;
  const int row = blockIdx.x / runs_per_row;
  const int hops = T + RING - 1;
  const int a = (blockIdx.x % runs_per_row) * hops_per_run;
  const int b = min(a + hops_per_run, hops);
  if (a >= b) return;
  const int t_hi = min(b - 1, T - 1);
  const int t_lo = max(a - (RING - 1), 0);
  float* out_r = out + (size_t)row * hops * HOP;

  // this thread's twiddles: pass 1 e^{2 pi i n1 tid / 2048}, pass 2
  // e^{2 pi i n2 (tid % 8) / 128}; entry 0 is 1 and is not applied
  float t1c[16], t1s[16], t2c[16], t2s[16];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int p1 = (2 * n * tid) & (NW - 1);
    const int p2 = (32 * n * (tid & 7)) & (NW - 1);
    t1c[n] = table[p1];
    t1s[n] = table[NW + p1];
    t2c[n] = table[p2];
    t2s[n] = table[NW + p2];
  }
  // this thread's window values, with the transform's 1 / N folded in (a
  // power of two: exact), and its ring entries.  Entry e = 2 i + c of a hop
  // is the sample pair 2 (tid + 128 i) + 512 c of that hop.
  const float inv_n = 1.0f / (float)NW;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int m = 2 * (tid + 128 * (e >> 3)) + 512 * (e & 7);
    win[e * THREADS + tid] = window != nullptr
                                 ? make_float2(window[m] * inv_n, window[m + 1] * inv_n)
                                 : make_float2(inv_n, inv_n);
  }
#pragma unroll
  for (int e = 0; e < RING * 4; ++e) ring[e * THREADS + tid] = make_float2(0.0f, 0.0f);

  for (int t = t_hi; t >= t_lo; --t) {
    const float* xr = re + ((size_t)row * T + t) * NBINS;
    const float* xi = im + ((size_t)row * T + t) * NBINS;
    float zr[16], zi[16];

    // pass 1: unpack Z[128 k1 + tid], transform over k1, twiddle, A[n1][tid]
#pragma unroll
    for (int k1 = 0; k1 < 16; ++k1) {
      const int k = 128 * k1 + tid;
      const float ar = xr[k], cr = xr[NW / 2 - k];
      float ai = xi[k], ci = xi[NW / 2 - k];
      if (k == 0) ai = ci = 0.0f;  // DC's and Nyquist's imaginary parts drop out
      const float cs = __ldg(table + k), sn = __ldg(table + NW + k);
      const float dr = ar - cr, di = ai + ci;
      zr[k1] = (ar + cr) - (dr * sn + di * cs);
      zi[k1] = (ai - ci) + (dr * cs - di * sn);
    }
    dft16(zr, zi);
#pragma unroll
    for (int n1 = 0; n1 < 16; ++n1) {
      const int s = 4 * (n1 & 3) + (n1 >> 2);
      float vr = zr[s], vi = zi[s];
      if (n1 > 0) cmul(vr, vi, t1c[n1], t1s[n1]);
      sAr[n1 * LDA + tid] = vr;
      sAi[n1 * LDA + tid] = vi;
    }
    __syncthreads();

    // pass 2: thread (n1, k3) transforms over k2, twiddle, B[k3][n2][n1]
    {
      const int n1 = tid >> 3, k3 = tid & 7;
#pragma unroll
      for (int k2 = 0; k2 < 16; ++k2) {
        zr[k2] = sAr[n1 * LDA + 8 * k2 + k3];
        zi[k2] = sAi[n1 * LDA + 8 * k2 + k3];
      }
      dft16(zr, zi);
#pragma unroll
      for (int n2 = 0; n2 < 16; ++n2) {
        const int s = 4 * (n2 & 3) + (n2 >> 2);
        float vr = zr[s], vi = zi[s];
        if (n2 > 0) cmul(vr, vi, t2c[n2], t2s[n2]);
        sBr[k3 * LDB + 16 * n2 + n1] = vr;
        sBi[k3 * LDB + 16 * n2 + n1] = vi;
      }
    }
    __syncthreads();

    // pass 3: columns tid and tid + 128 of (n2, n1) over k3; z[n] with
    // n = column + 256 n3 is the sample pair 2 n of the frame: piece n3 / 2.
    // Piece p goes to hop t + p: the frame's first touch of hop t assigns,
    // the later pieces add to what the frames above have left.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float yr[8], yi[8];
#pragma unroll
      for (int k3 = 0; k3 < 8; ++k3) {
        yr[k3] = sBr[k3 * LDB + tid + 128 * i];
        yi[k3] = sBi[k3 * LDB + tid + 128 * i];
      }
      dft8(yr, yi);
#pragma unroll
      for (int n3 = 0; n3 < 8; ++n3) {
        const int s = 2 * (n3 & 3) + (n3 >> 2);
        const int p = n3 >> 1;
        const float2 w = win[(8 * i + n3) * THREADS + tid];
        float2* acc = ring + ((((t + p) & (RING - 1)) * 4) + 2 * i + (n3 & 1)) * THREADS + tid;
        const float2 v = make_float2(yr[s] * w.x, yi[s] * w.y);
        if (p == 0) {
          *acc = v;
        } else {
          const float2 old = *acc;
          *acc = make_float2(old.x + v.x, old.y + v.y);
        }
      }
    }

    // hop t + 3 has its last piece; below frame 0 there is nothing to wait for
    const int h_first = t + RING - 1;
    const int h_last = t == 0 ? 0 : h_first;
    for (int h = h_first; h >= h_last; --h) {
      if (h >= a && h < b) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v = ring[((h & (RING - 1)) * 4 + e) * THREADS + tid];
          *reinterpret_cast<float2*>(out_r + (size_t)h * HOP + 2 * (tid + 128 * (e >> 1)) +
                                     512 * (e & 1)) = v;
        }
      }
    }
  }
}

}  // namespace

// Blocks of the kernel that the current device holds at once.
extern "C" int umx_istft_ct2_capacity(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(istft_ct2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, istft_ct2_kernel, THREADS,
                                                    SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  return (int)cudaSuccess;
}

// re/im (rows, T, F) f32 with F = N/2 + 1, table (2, N), window (N,) or null,
// out (rows, (T-1)*hop + N).  One launch of rows x runs_per_row blocks, each
// on hops_per_run output hops of its row.  Needs N = 4096 and hop = N/4
// (checked by the wrapper; refused here as well).
extern "C" int umx_istft_ct2(const float* re, const float* im, const float* table,
                             const float* window, float* out, int rows, int T, int F, int N,
                             int hop, int runs_per_row, int hops_per_run, void* stream) {
  if (N != NW || hop != HOP || F != NBINS || rows < 1 || T < 1 || runs_per_row < 1 ||
      hops_per_run < 1 || (long long)runs_per_row * hops_per_run < T + RING - 1 ||
      (long long)rows * runs_per_row > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(istft_ct2_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  istft_ct2_kernel<<<rows * runs_per_row, THREADS, SMEM_BYTES, st>>>(re, im, table, window, out,
                                                                     T, runs_per_row,
                                                                     hops_per_run);
  return (int)cudaGetLastError();
}
