// K8: the fused Cooley-Tukey inverse STFT (window folded, overlap-added).
//
// Replaces umx_tpu/ops/istft_ct.py::istft_ct2_fused (its Pallas kernel).
// For each frame of each row it computes the windowed inverse real DFT
//
//   x[m] = w[m] / N * Re sum_{k<N} X[k] e^{2 pi i m k / N},  X[N - k] = conj X[k],
//
// from the one-sided bins X[0..N/2] (the imaginary parts of DC and Nyquist
// drop out), and overlap-adds the frames at hop N/4 into the row's signal.
// Takes every N = 1024 K, as the JAX function takes every N with 1024 | N:
// N = 4096, UMX's transform, in the hand-scheduled form below; the other N
// up to 16384 in the register form, its scheme for three passes of other
// radices (K = 1, 2, 3, 5, 6, 7, 8, 10, 12, 14, 16), or in the mixed-radix
// form (odd K from 9, and by name as the register form's yardstick); N
// above 16384 up to 232448 (K 227) in the cluster form, a frame and its
// ring in the shared memory of a thread-block cluster; above, in the
// device-memory form.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

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

// ---- the mixed-radix form: every other n_fft = 1024 K, K = 1 .. 16 -------
//
// The same Hermitian form, run plan and overlap-add ring, but the N/2 =
// 512 K point complex inverse goes through shared memory in Stockham
// passes (natural order in, natural order out): one DFT of K points (a
// direct sum where K is not 2, 4, 8 or 16: 3072, 5120, ... need a factor
// that is no power of two, as JAX's split n_fft = 128 x n2 does), then
// three radix-8 passes.  A pass of radix R over the points done so far, Ns,
// takes butterfly j from the points j + r M/R, turns point r by
// e^{2 pi i r (j % Ns) / (Ns R)}, transforms, and writes point r to
// (j / Ns) Ns R + j % Ns + r Ns.  Every twiddle is a table entry (a multiple
// of 2 pi / N).  A thread stages its butterflies in registers between two
// barriers, so one buffer of M complex values serves every pass.  Then the
// frame is windowed and overlap-added into the 4-hop ring exactly as the
// 4096 form does (a thread owns the same sample pairs of every hop): the
// same sums in the same order.  Shared memory: the buffer (M complex) and
// the ring (N floats), 8 K KiB: 128 KiB at N = 16384, the largest N a
// block holds with room for both (N = 32768 would need 256 KiB).

constexpr int MR_THREADS = 256;
constexpr int MR_K_MAX = 16;  // n_fft <= 16384

__host__ __device__ constexpr size_t mr_smem(int k) { return (size_t)8192 * k; }

// y[n] = sum_r x[r] e^{2 pi i n r / R} for n < R, in place, natural order;
// a direct sum takes e^{2 pi i m / R} from the table at stride N / R
template <int R>
__device__ __forceinline__ void dft_small(float (&r)[R], float (&i)[R], const float* table,
                                          int N) {
  if constexpr (R == 1) {
    return;
  } else if constexpr (R == 2) {
    const float ar = r[0], ai = i[0];
    r[0] = ar + r[1];
    i[0] = ai + i[1];
    r[1] = ar - r[1];
    i[1] = ai - i[1];
  } else if constexpr (R == 4) {
    dft4(r[0], i[0], r[1], i[1], r[2], i[2], r[3], i[3]);
  } else if constexpr (R == 8 || R == 16) {
    float sr[R], si[R];
    if constexpr (R == 8) {
      dft8(r, i);
    } else {
      dft16(r, i);
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      sr[s] = r[s];
      si[s] = i[s];
    }
    // dft8 leaves output n in slot 2 (n % 4) + n / 4, dft16 in 4 (n % 4) + n / 4
#pragma unroll
    for (int n = 0; n < R; ++n) {
      const int s = (R / 4) * (n & 3) + (n >> 2);
      r[n] = sr[s];
      i[n] = si[s];
    }
  } else {
    float yr[R], yi[R];
    const int stride = N / R;
#pragma unroll
    for (int n = 0; n < R; ++n) {
      float ar = r[0], ai = i[0];
#pragma unroll
      for (int q = 1; q < R; ++q) {
        const int m = (n * q) % R * stride;
        const float wc = __ldg(table + m), ws = __ldg(table + N + m);
        ar += r[q] * wc - i[q] * ws;
        ai += r[q] * ws + i[q] * wc;
      }
      yr[n] = ar;
      yi[n] = ai;
    }
#pragma unroll
    for (int n = 0; n < R; ++n) {
      r[n] = yr[n];
      i[n] = yi[n];
    }
  }
}

// One Stockham pass of radix R over M points with NS points done so far,
// in place on (br, bi) through registers; ends with a barrier.
template <int M, int R, int NS>
__device__ __forceinline__ void stockham_pass(float* br, float* bi, const float* table, int N) {
  constexpr int NB = M / R;                                    // butterflies
  constexpr int BPT = (NB + MR_THREADS - 1) / MR_THREADS;      // per thread
  constexpr int TW = 2 * M / (NS * R);                         // N / (NS R)
  const int tid = threadIdx.x;
  float vr[BPT][R], vi[BPT][R];
#pragma unroll
  for (int e = 0; e < BPT; ++e) {
    const int j = tid + e * MR_THREADS;
    if (NB % MR_THREADS == 0 || j < NB) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        vr[e][q] = br[j + q * NB];
        vi[e][q] = bi[j + q * NB];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < BPT; ++e) {
    const int j = tid + e * MR_THREADS;
    if (NB % MR_THREADS == 0 || j < NB) {
      const int jm = j % NS;
      if (NS > 1) {
#pragma unroll
        for (int q = 1; q < R; ++q) {
          const int p = jm * q * TW;  // < N
          cmul(vr[e][q], vi[e][q], __ldg(table + p), __ldg(table + N + p));
        }
      }
      dft_small<R>(vr[e], vi[e], table, N);
      const int d = (j / NS) * NS * R + jm;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        br[d + q * NS] = vr[e][q];
        bi[d + q * NS] = vi[e][q];
      }
    }
  }
  __syncthreads();
}

// As istft_ct2_kernel, at n_fft = 1024 K.  Dynamic shared memory
// mr_smem(K): the buffer (re, im: 2 x 512 K floats), the ring (4 hops of
// 256 K floats).
template <int K>
__global__ void __launch_bounds__(MR_THREADS)
istft_ct2_mr_kernel(const float* __restrict__ re, const float* __restrict__ im,
                    const float* __restrict__ table, const float* __restrict__ window,
                    float* __restrict__ out, int T, int runs_per_row, int hops_per_run) {
  constexpr int N = 1024 * K, M = N / 2, HP = N / 4, F = M + 1;
  constexpr int PAIRS = HP / 2;                                   // sample pairs a hop
  constexpr int PPT = (PAIRS + MR_THREADS - 1) / MR_THREADS;      // a thread's pairs
  extern __shared__ __align__(16) float sm[];
  float* br = sm;
  float* bi = br + M;
  float2* ring = reinterpret_cast<float2*>(bi + M);  // (RING, PAIRS)

  const int tid = threadIdx.x;
  const int row = blockIdx.x / runs_per_row;
  const int hops = T + RING - 1;
  const int a = (blockIdx.x % runs_per_row) * hops_per_run;
  const int b = min(a + hops_per_run, hops);
  if (a >= b) return;
  const int t_hi = min(b - 1, T - 1);
  const int t_lo = max(a - (RING - 1), 0);
  float* out_r = out + (size_t)row * hops * HP;
  const float inv_n = 1.0f / (float)N;  // the transform's 1 / N, folded into the window
  // the hops below frame T's reach get no piece 0: they start from zero
#pragma unroll
  for (int e = 0; e < PPT; ++e) {
    const int q = tid + e * MR_THREADS;
    if (PAIRS % MR_THREADS == 0 || q < PAIRS) {
#pragma unroll
      for (int p = 0; p < RING; ++p) ring[p * PAIRS + q] = make_float2(0.0f, 0.0f);
    }
  }

  for (int t = t_hi; t >= t_lo; --t) {
    const float* xr = re + ((size_t)row * T + t) * F;
    const float* xi = im + ((size_t)row * T + t) * F;
    __syncthreads();  // the previous frame's reads of the buffer are done
    for (int k = tid; k < M; k += MR_THREADS) {
      const float ar = xr[k], cr = xr[M - k];
      float ai = xi[k], ci = xi[M - k];
      if (k == 0) ai = ci = 0.0f;  // DC's and Nyquist's imaginary parts drop out
      const float cs = __ldg(table + k), sn = __ldg(table + N + k);
      const float dr = ar - cr, di = ai + ci;
      br[k] = (ar + cr) - (dr * sn + di * cs);
      bi[k] = (ai - ci) + (dr * cs - di * sn);
    }
    __syncthreads();
    if constexpr (K > 1) stockham_pass<M, K, 1>(br, bi, table, N);
    stockham_pass<M, 8, K>(br, bi, table, N);
    stockham_pass<M, 8, 8 * K>(br, bi, table, N);
    stockham_pass<M, 8, 64 * K>(br, bi, table, N);

    // pair n = p PAIRS + q of the frame (samples 2 n, 2 n + 1) is piece p,
    // pair q of hop t + p: piece 0 assigns, the later pieces add
#pragma unroll
    for (int e = 0; e < PPT; ++e) {
      const int q = tid + e * MR_THREADS;
      if (PAIRS % MR_THREADS == 0 || q < PAIRS) {
#pragma unroll
        for (int p = 0; p < RING; ++p) {
          const int n = p * PAIRS + q;
          const float2 w = window != nullptr
                               ? make_float2(__ldg(window + 2 * n) * inv_n,
                                             __ldg(window + 2 * n + 1) * inv_n)
                               : make_float2(inv_n, inv_n);
          const float2 v = make_float2(br[n] * w.x, bi[n] * w.y);
          float2* acc = ring + ((t + p) & (RING - 1)) * PAIRS + q;
          if (p == 0) {
            *acc = v;
          } else {
            const float2 old = *acc;
            *acc = make_float2(old.x + v.x, old.y + v.y);
          }
        }
      }
    }
    const int h_first = t + RING - 1;
    const int h_last = t == 0 ? 0 : h_first;
    for (int h = h_first; h >= h_last; --h) {
      if (h >= a && h < b) {
#pragma unroll
        for (int e = 0; e < PPT; ++e) {
          const int q = tid + e * MR_THREADS;
          if (PAIRS % MR_THREADS == 0 || q < PAIRS)
            *reinterpret_cast<float2*>(out_r + (size_t)h * HP + 2 * q) =
                ring[(h & (RING - 1)) * PAIRS + q];
        }
      }
    }
  }
}

// ---- above 16384: the cluster form, and the device-memory form beyond it --
//
// Above 16384 a frame (N/2 complex) and its ring (N floats), 8 N bytes,
// no longer fit one block's shared memory (32768 would need 256 KiB).
// Both forms compute what the mixed-radix form computes, with the same
// unpacking, Stockham passes of the same indexing, the same window and
// the same ring, through the helpers below, which both call: so they give
// the same bits.  The passes (ops/istft_ct_cuda.py:istft_radix_plan): the
// odd part of K as a direct sum, the power-of-two part of K in radix 8
// (then 4 or 2), then three radix-8 passes; every pass reads each value
// once (a direct K-point pass read each input K times, one after another:
// 5.90 ms at N 32768, 8 rows of 60 s, on an H100 80GB HBM3 at 700 W).
//
// The cluster form (N up to 232448 = 227 x 1024): a thread-block cluster
// of C = 2, 4 or 8 blocks (the smallest whose slices fit, 8 N / C bytes a
// block: ops/istft_ct_cuda.py:istft_cluster_size) holds a frame and its
// ring in the blocks' shared memory, which Hopper's distributed shared
// memory lets every block of the cluster address.  Point k of the frame
// lives in block k % C, ring pair q in block q % C (cyclic, so that the
// slices are even and most accesses local): a radix pass's butterfly j
// runs in block j % C and reads its R points there (the distance between
// them, M / R, is a multiple of C); it writes to other blocks only while
// ns % C != 0 (the first pass, or the one after an odd pass).  Each pass
// stages its butterflies in registers between two barriers (8, 16 or 32
// complex values a thread, a template sized by M / C: at 32768, 16, with
// 168 bytes a thread spilled where 32 spilled 704), so one buffer serves
// every pass, as in the mixed-radix form; a barrier is the cluster's
// (cluster.sync()) where another block's data crosses it, else the block's
// own.  The direct odd
// pass is the first: a block sums the points of its own butterflies (the
// inputs of butterfly j are all in block j % C), stages the outputs and
// writes them to their blocks.  The next frame's bins are prefetched into
// L2 while a frame is transformed.  The ring pairs a thread owns read their frame points in
// the thread's own block, so the overlap-add needs no atomics and keeps
// overlap_add's order.  One cluster a run (istft_run_plan over the
// clusters the card holds at once).  On an H100 80GB HBM3 at 700 W, 8 rows
// of 60 s: 1.13 ms at N 32768 (clusters of 2; the device-memory form 2.45,
// torch.istft 1.85), 2.42 at 65536 (of 4; 3.24, 1.90), 4.63 at 131072 (of
// 8; 5.36, 2.24).  Laying out each pass's twiddles in the order its
// butterflies read them took 32768 from 1.69 to 1.15 ms: in the table's
// order a lane reads its own cache line at the middle passes.
//
// The device-memory form (N above 232448): each block owns a scratch slot
// of 3 N floats in device memory (two buffers of N/2 complex, ping-ponged
// between the passes, and the ring) and walks the runs of the plan
// grid-stride, so the scratch is the grid's (one block an SM: 132 slots,
// 50 MB at N = 32768), not one slot a run.  It took 2.46 ms at N 32768 (8
// rows of 60 s; torch.istft 1.78): the passes' round trips through L1 and
// L2, not the 16 B a bin read and 4 B a sample written, bound it.  No UMX
// model runs either form (UMX's n_fft is 4096).

constexpr int BG_THREADS = 512;
constexpr int CL_THREADS = 512;
constexpr int CL_MAX = 8;  // a portable cluster

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" : : "l"(p));
}

// Z[k] of the Hermitian form from the bins of a frame (xr, xi: F = M + 1)
__device__ __forceinline__ void unpack_point(const float* xr, const float* xi,
                                             const float* table, int N, int M, int k, float& zr,
                                             float& zi) {
  const float vr = xr[k], cr = xr[M - k];
  float vi = xi[k], ci = xi[M - k];
  if (k == 0) vi = ci = 0.0f;  // DC's and Nyquist's imaginary parts drop out
  const float cs = __ldg(table + k), sn = __ldg(table + N + k);
  const float dr = vr - cr, di = vi + ci;
  zr = (vr + cr) - (dr * sn + di * cs);
  zi = (vi - ci) + (dr * cs - di * sn);
}

// Output n of butterfly j of the first pass of an odd radix m (no points
// done: no twiddles), a direct sum as dft_small's with (n q) mod m stepped
// by n; at(k) gives point k of the frame as a float2.
template <typename At>
__device__ __forceinline__ float2 odd_point(At at, const float* table, int N, int nb, int m,
                                            int j, int n) {
  const int st = N / m;
  const float2 x0 = at(j);
  float sum_r = x0.x, sum_i = x0.y;
  int idx = 0;
  for (int q = 1; q < m; ++q) {
    idx += n;
    if (idx >= m) idx -= m;
    const float wc = __ldg(table + idx * st), ws = __ldg(table + N + idx * st);
    const float2 v = at(j + q * nb);
    sum_r += v.x * wc - v.y * ws;
    sum_i += v.x * ws + v.y * wc;
  }
  return make_float2(sum_r, sum_i);
}

// Butterfly j of a Stockham pass of radix R with ns points done, on its R
// points in registers: the twiddles (point q times tw(q) = (cos, sin) of 2 pi
// (j % ns) q / (ns R), a table entry), then the R-point transform; its
// outputs go to (j / ns) ns R + j % ns + q ns.
template <int R, typename Tw>
__device__ __forceinline__ void butterfly(float (&vr)[R], float (&vi)[R], const float* table,
                                          int N, int ns, Tw tw) {
  if (ns > 1) {
#pragma unroll
    for (int q = 1; q < R; ++q) {
      const float2 w = tw(q);
      cmul(vr[q], vi[q], w.x, w.y);
    }
  }
  dft_small<R>(vr, vi, table, N);
}

// Piece p, pair q of a frame (v = z[n] of its windowed sample pair n = p
// PAIRS + q, the window's n-th pair w with 1/N folded in) into the ring
// entry acc of hop t + p: piece 0 assigns, the later pieces add.
__device__ __forceinline__ void ring_piece(float2* acc, float2 z, float2 w, int p) {
  const float2 v = make_float2(z.x * w.x, z.y * w.y);
  if (p == 0) {
    *acc = v;
  } else {
    const float2 old = *acc;
    *acc = make_float2(old.x + v.x, old.y + v.y);
  }
}

__device__ __forceinline__ float2 window_pair(const float* window, int n, float inv_n) {
  return window != nullptr
             ? make_float2(__ldg(window + 2 * n) * inv_n, __ldg(window + 2 * n + 1) * inv_n)
             : make_float2(inv_n, inv_n);
}

// ---- the register form: the 4096 form's scheme at other N up to 16384 ----
//
// The N/2 = M point complex inverse in three passes of radices R1 x R2 x R3
// = M (ops/istft_ct_cuda.py:istft_register_plan), with k = R2 R3 k1 + R3 k2
// + k3 and n = n1 + R1 n2 + R1 R2 n3, as istft_ct2_kernel does at 16 x 16
// x 8: a block of TH = R2 R3 threads holds a frame.  Pass 1: thread j = R3
// k2 + k3 reads its R1 bins (and their mirrors) from device memory,
// coalesced, unpacks the Hermitian form, takes the R1-point transform in
// registers, turns output n1 by e^{2 pi i n1 j / M} and writes A[n1][j].
// Pass 2: butterfly (n1, k3) transforms A[n1][R3 k2 + k3] over k2, turns
// output n2 by e^{2 pi i n2 k3 / (R2 R3)} and writes B[k3][R1 n2 + n1].
// Pass 3: butterfly c = R1 n2 + n1 transforms B[k3][c] over k3: z[c + R1 R2
// n3], sample pair c + R1 R2 n3 of the frame, windowed into the ring as the
// other forms do (a thread owns its pairs of every hop: the same sums in
// the same order).  A and B are separate, so a frame takes two barriers.
// Radices 8 and 16 are the 4096 form's radix-4 steps; a factor 3, 5 or 7 of
// K is folded into pass 1 (12 = 3 x 4, 10 = 5 x 2, 28 = 7 x 4, ...) or, at
// 32 = 2 x 16, one more step, each a Cooley-Tukey split in registers whose
// twiddles are compile-time constants (a float64 series rounded once to
// float32, as the table's entries are).  The passes' twiddles are the
// table's entries: pass 2's depend on k3 = tid % R3 alone and stay in
// registers, pass 1's come from a copy of the table laid out [n1][j]
// (`tw1`, coalesced; in registers up to R1 16).  Rows of A and B are padded
// (LDA = R3, LDB = 32 / R3 mod 32) so that no warp's access conflicts.
// Shared memory ~24 M bytes: A and B (8 M each) and the ring (8 M).

constexpr double kPi = 3.14159265358979323846;

// sin x and cos x for |x| <= pi, by their series in float64
__host__ __device__ constexpr double cx_sin(double x) {
  double term = x, sum = x;
  for (int k = 1; k < 32; ++k) {
    term *= -x * x / ((2.0 * k) * (2.0 * k + 1.0));
    sum += term;
  }
  return sum;
}
__host__ __device__ constexpr double cx_cos(double x) {
  double term = 1.0, sum = 1.0;
  for (int k = 1; k < 32; ++k) {
    term *= -x * x / ((2.0 * k - 1.0) * (2.0 * k));
    sum += term;
  }
  return sum;
}

// e^{2 pi i m / R} for m < R, rounded once to float32
template <int R>
struct Roots {
  float c[R], s[R];
  __host__ __device__ constexpr Roots() : c(), s() {
    for (int m = 0; m < R; ++m) {
      double x = 2.0 * kPi * m / R;
      if (x > kPi) x -= 2.0 * kPi;
      c[m] = (float)cx_cos(x);
      s[m] = (float)cx_sin(x);
    }
  }
};

template <int R>
__device__ __forceinline__ void dft_nat(float (&r)[R], float (&i)[R]);

// y[n] = sum_m x[m] e^{2 pi i n m / P}, P = 3, 5, 7: the symmetric direct sum
template <int P>
__device__ __forceinline__ void dft_odd(float (&r)[P], float (&i)[P]) {
  constexpr Roots<P> w{};
  constexpr int H = (P - 1) / 2;
  float sr[H + 1], si[H + 1], dr[H + 1], di[H + 1];
  float y0r = r[0], y0i = i[0];
#pragma unroll
  for (int m = 1; m <= H; ++m) {
    sr[m] = r[m] + r[P - m];
    si[m] = i[m] + i[P - m];
    dr[m] = r[m] - r[P - m];
    di[m] = i[m] - i[P - m];
    y0r += sr[m];
    y0i += si[m];
  }
  float yr[P], yi[P];
  yr[0] = y0r;
  yi[0] = y0i;
#pragma unroll
  for (int n = 1; n <= H; ++n) {
    float ar = r[0], ai = i[0], br = 0.0f, bi = 0.0f;
#pragma unroll
    for (int m = 1; m <= H; ++m) {
      const int q = (n * m) % P;
      ar += w.c[q] * sr[m];
      ai += w.c[q] * si[m];
      br += w.s[q] * dr[m];
      bi += w.s[q] * di[m];
    }
    // y_n = a + i b, y_{P-n} = a - i b
    yr[n] = ar - bi;
    yi[n] = ai + br;
    yr[P - n] = ar + bi;
    yi[P - n] = ai - br;
  }
#pragma unroll
  for (int n = 0; n < P; ++n) {
    r[n] = yr[n];
    i[n] = yi[n];
  }
}

// R = A B (B = 16, 8, 4 or 2, the largest that divides R): input m = B m1 +
// m2, output n = n1 + A n2; A-point transforms over m1, the twiddles
// e^{2 pi i n1 m2 / R}, then B-point transforms over m2
template <int R>
__device__ __forceinline__ void dft_ct(float (&r)[R], float (&i)[R]) {
  constexpr int B = R % 16 == 0 ? 16 : R % 8 == 0 ? 8 : R % 4 == 0 ? 4 : 2;
  constexpr int A = R / B;
  static_assert(A == 2 || A == 3 || A == 5 || A == 7, "a radix of the register form");
  constexpr Roots<R> w{};
  float tr[R], ti[R];
#pragma unroll
  for (int m2 = 0; m2 < B; ++m2) {
    float ur[A], ui[A];
#pragma unroll
    for (int m1 = 0; m1 < A; ++m1) {
      ur[m1] = r[B * m1 + m2];
      ui[m1] = i[B * m1 + m2];
    }
    dft_nat<A>(ur, ui);
#pragma unroll
    for (int n1 = 0; n1 < A; ++n1) {
      float vr = ur[n1], vi = ui[n1];
      const int q = (n1 * m2) % R;
      if (q != 0) cmul(vr, vi, w.c[q], w.s[q]);
      tr[n1 * B + m2] = vr;
      ti[n1 * B + m2] = vi;
    }
  }
#pragma unroll
  for (int n1 = 0; n1 < A; ++n1) {
    float ur[B], ui[B];
#pragma unroll
    for (int m2 = 0; m2 < B; ++m2) {
      ur[m2] = tr[n1 * B + m2];
      ui[m2] = ti[n1 * B + m2];
    }
    dft_nat<B>(ur, ui);
#pragma unroll
    for (int n2 = 0; n2 < B; ++n2) {
      r[n1 + A * n2] = ur[n2];
      i[n1 + A * n2] = ui[n2];
    }
  }
}

// y[n] = sum_m x[m] e^{2 pi i n m / R} in registers, natural order in and out
template <int R>
__device__ __forceinline__ void dft_nat(float (&r)[R], float (&i)[R]) {
  if constexpr (R == 1) {
    return;
  } else if constexpr (R == 2) {
    const float ar = r[0], ai = i[0];
    r[0] = ar + r[1];
    i[0] = ai + i[1];
    r[1] = ar - r[1];
    i[1] = ai - i[1];
  } else if constexpr (R == 4) {
    dft4(r[0], i[0], r[1], i[1], r[2], i[2], r[3], i[3]);
  } else if constexpr (R == 8 || R == 16) {
    if constexpr (R == 8) {
      dft8(r, i);
    } else {
      dft16(r, i);
    }
    // dft8 leaves output n in slot 2 (n % 4) + n / 4, dft16 in 4 (n % 4) + n / 4
    float sr[R], si[R];
#pragma unroll
    for (int n = 0; n < R; ++n) {
      sr[n] = r[n];
      si[n] = i[n];
    }
#pragma unroll
    for (int n = 0; n < R; ++n) {
      r[n] = sr[(R / 4) * (n & 3) + (n >> 2)];
      i[n] = si[(R / 4) * (n & 3) + (n >> 2)];
    }
  } else if constexpr (R == 3 || R == 5 || R == 7) {
    dft_odd<R>(r, i);
  } else {
    dft_ct<R>(r, i);
  }
}

template <int R1, int R2, int R3>
struct RegPlan {
  static constexpr int M = R1 * R2 * R3, N = 2 * M, HP = N / 4, F = M + 1;
  static constexpr int TH = R2 * R3;  // threads: one pass-1 butterfly each
  static constexpr int PAIRS = M / 4;  // sample pairs a hop
  static constexpr int COLS = R1 * R2;  // pass-3 butterflies
  static constexpr int LDA = TH + (R3 - TH % 32 + 32) % 32;  // = R3 (mod 32)
  static constexpr int LDB = COLS + (32 / R3 - COLS % 32 + 32) % 32;  // = 32 / R3 (mod 32)
  static constexpr int BPT2 = (R1 * R3 + TH - 1) / TH;  // pass-2 butterflies a thread
  static constexpr int BPT3 = (COLS + TH - 1) / TH;  // pass-3 butterflies a thread
  static constexpr int Q3 = R3 / 4;  // outputs n3 of a piece
  static constexpr bool TW1_REGS = R1 <= 16;
  static constexpr size_t SMEM =
      sizeof(float) * (2 * R1 * LDA + 2 * R3 * LDB) + sizeof(float2) * RING * PAIRS;
  static_assert(R3 == 8 || R3 == 16, "pass 3 leaves whole pieces to a thread");
  static_assert(TH % 32 == 0 && TH % R3 == 0, "whole warps; k3 = tid % R3");
};

// As istft_ct2_kernel, at N = 2 R1 R2 R3.  tw1: (cos, sin) x (R1 - 1) x TH,
// entry (n1 - 1, j) the table's entry 2 n1 j mod N.
template <int R1, int R2, int R3>
__global__ void __launch_bounds__(R2 * R3)
istft_ct2_reg_kernel(const float* __restrict__ re, const float* __restrict__ im,
                     const float* __restrict__ table, const float* __restrict__ tw1,
                     const float* __restrict__ window, float* __restrict__ out, int T,
                     int runs_per_row, int hops_per_run) {
  using P = RegPlan<R1, R2, R3>;
  constexpr int M = P::M, N = P::N, HP = P::HP, F = P::F, TH = P::TH, PAIRS = P::PAIRS;
  constexpr int LDA = P::LDA, LDB = P::LDB, COLS = P::COLS;
  extern __shared__ __align__(16) float sm[];
  float* sAr = sm;
  float* sAi = sAr + R1 * LDA;
  float* sBr = sAi + R1 * LDA;
  float* sBi = sBr + R3 * LDB;
  float2* ring = reinterpret_cast<float2*>(sBi + R3 * LDB);  // (RING, PAIRS)

  const int tid = threadIdx.x;
  const int row = blockIdx.x / runs_per_row;
  const int hops = T + RING - 1;
  const int a = (blockIdx.x % runs_per_row) * hops_per_run;
  const int b = min(a + hops_per_run, hops);
  if (a >= b) return;
  const int t_hi = min(b - 1, T - 1);
  const int t_lo = max(a - (RING - 1), 0);
  float* out_r = out + (size_t)row * hops * HP;
  const float inv_n = 1.0f / (float)N;  // the transform's 1 / N, folded into the window

  // pass 2's twiddles (k3 = tid % R3 for every butterfly of the thread)
  float t2c[R2], t2s[R2];
#pragma unroll
  for (int n2 = 0; n2 < R2; ++n2) {
    const int p = 2 * R1 * n2 * (tid % R3);  // < N
    t2c[n2] = __ldg(table + p);
    t2s[n2] = __ldg(table + N + p);
  }
  float t1c[P::TW1_REGS ? R1 : 1], t1s[P::TW1_REGS ? R1 : 1];
  if constexpr (P::TW1_REGS) {
#pragma unroll
    for (int n1 = 1; n1 < R1; ++n1) {
      t1c[n1] = __ldg(tw1 + (n1 - 1) * TH + tid);
      t1s[n1] = __ldg(tw1 + (R1 - 1 + n1 - 1) * TH + tid);
    }
  }
  // ring pair q = c + (M / R3) m of every hop is this thread's, c = tid + TH e
#pragma unroll
  for (int e = 0; e < P::BPT3; ++e) {
    const int c = tid + TH * e;
    if (COLS % TH == 0 || c < COLS) {
#pragma unroll
      for (int m = 0; m < P::Q3; ++m)
#pragma unroll
        for (int p = 0; p < RING; ++p) ring[p * PAIRS + c + (M / R3) * m] = make_float2(0.0f, 0.0f);
    }
  }

  for (int t = t_hi; t >= t_lo; --t) {
    const float* xr = re + ((size_t)row * T + t) * F;
    const float* xi = im + ((size_t)row * T + t) * F;

    // pass 1: unpack Z[TH k1 + tid], transform over k1, twiddle, A[n1][tid]
    {
      float zr[R1], zi[R1];
#pragma unroll
      for (int k1 = 0; k1 < R1; ++k1) {
        const int k = TH * k1 + tid;
        const float ar = xr[k], cr = xr[M - k];
        float ai = xi[k], ci = xi[M - k];
        if (k == 0) ai = ci = 0.0f;  // DC's and Nyquist's imaginary parts drop out
        const float cs = __ldg(table + k), sn = __ldg(table + N + k);
        const float dr = ar - cr, di = ai + ci;
        zr[k1] = (ar + cr) - (dr * sn + di * cs);
        zi[k1] = (ai - ci) + (dr * cs - di * sn);
      }
      dft_nat<R1>(zr, zi);
#pragma unroll
      for (int n1 = 0; n1 < R1; ++n1) {
        float vr = zr[n1], vi = zi[n1];
        if (n1 > 0) {
          if constexpr (P::TW1_REGS) {
            cmul(vr, vi, t1c[n1], t1s[n1]);
          } else {
            cmul(vr, vi, __ldg(tw1 + (n1 - 1) * TH + tid),
                 __ldg(tw1 + (R1 - 1 + n1 - 1) * TH + tid));
          }
        }
        sAr[n1 * LDA + tid] = vr;
        sAi[n1 * LDA + tid] = vi;
      }
    }
    __syncthreads();

    // pass 2: butterfly (n1, k3) = (b2 / R3, b2 % R3) over k2, B[k3][R1 n2 + n1]
#pragma unroll
    for (int e = 0; e < P::BPT2; ++e) {
      const int b2 = tid + TH * e;
      if ((R1 * R3) % TH == 0 || b2 < R1 * R3) {
        const int n1 = b2 / R3, k3 = b2 % R3;
        float yr[R2], yi[R2];
#pragma unroll
        for (int k2 = 0; k2 < R2; ++k2) {
          yr[k2] = sAr[n1 * LDA + R3 * k2 + k3];
          yi[k2] = sAi[n1 * LDA + R3 * k2 + k3];
        }
        dft_nat<R2>(yr, yi);
#pragma unroll
        for (int n2 = 0; n2 < R2; ++n2) {
          float vr = yr[n2], vi = yi[n2];
          if (n2 > 0) cmul(vr, vi, t2c[n2], t2s[n2]);
          sBr[k3 * LDB + R1 * n2 + n1] = vr;
          sBi[k3 * LDB + R1 * n2 + n1] = vi;
        }
      }
    }
    __syncthreads();

    // pass 3: column c over k3; output n3 is sample pair c + (M / R3) n3:
    // piece n3 / Q3, pair q = c + (M / R3) (n3 % Q3) of hop t + piece
#pragma unroll
    for (int e = 0; e < P::BPT3; ++e) {
      const int c = tid + TH * e;
      if (COLS % TH == 0 || c < COLS) {
        float yr[R3], yi[R3];
#pragma unroll
        for (int k3 = 0; k3 < R3; ++k3) {
          yr[k3] = sBr[k3 * LDB + c];
          yi[k3] = sBi[k3 * LDB + c];
        }
        dft_nat<R3>(yr, yi);
#pragma unroll
        for (int n3 = 0; n3 < R3; ++n3) {
          const int p = n3 / P::Q3;
          const int q = c + (M / R3) * (n3 % P::Q3);
          ring_piece(ring + ((t + p) & (RING - 1)) * PAIRS + q, make_float2(yr[n3], yi[n3]),
                     window_pair(window, p * PAIRS + q, inv_n), p);
        }
      }
    }

    // hop t + 3 has its last piece; below frame 0 there is nothing to wait for
    const int h_first = t + RING - 1;
    const int h_last = t == 0 ? 0 : h_first;
    for (int h = h_first; h >= h_last; --h) {
      if (h >= a && h < b) {
#pragma unroll
        for (int e = 0; e < P::BPT3; ++e) {
          const int c = tid + TH * e;
          if (COLS % TH == 0 || c < COLS) {
#pragma unroll
            for (int m = 0; m < P::Q3; ++m) {
              const int q = c + (M / R3) * m;
              *reinterpret_cast<float2*>(out_r + (size_t)h * HP + 2 * q) =
                  ring[(h & (RING - 1)) * PAIRS + q];
            }
          }
        }
      }
    }
  }
}

// One Stockham pass of radix R (2, 4 or 8) over M points with ns points
// done, from (sr, si) to (dr, di), natural order in and out
// (stockham_pass's indices at run-time sizes).
template <int R>
__device__ __forceinline__ void big_pass(const float* sr, const float* si, float* dr, float* di,
                                         const float* table, int N, int M, int ns) {
  const int nb = M / R;
  for (int j = threadIdx.x; j < nb; j += BG_THREADS) {
    float vr[R], vi[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      vr[q] = sr[j + q * nb];
      vi[q] = si[j + q * nb];
    }
    const int jm = j % ns, tw = N / (ns * R);
    butterfly<R>(vr, vi, table, N, ns, [&](int q) {
      const int p = jm * q * tw;  // < N
      return make_float2(__ldg(table + p), __ldg(table + N + p));
    });
    const int d = (j / ns) * ns * R + jm;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      dr[d + q * ns] = vr[q];
      di[d + q * ns] = vi[q];
    }
  }
}

// The first pass of an odd radix m, from (sr, si) to (dr, di).
__device__ __forceinline__ void big_pass_odd(const float* sr, const float* si, float* dr,
                                             float* di, const float* table, int N, int M,
                                             int m) {
  const int nb = M / m;
  auto at = [&](int k) { return make_float2(sr[k], si[k]); };
  for (int j = threadIdx.x; j < nb; j += BG_THREADS) {
    for (int n = 0; n < m; ++n) {
      const float2 y = odd_point(at, table, N, nb, m, j, n);
      dr[j * m + n] = y.x;
      di[j * m + n] = y.y;
    }
  }
}

// As istft_ct2_mr_kernel at n_fft N = 1024 K, K > 16, run-time sized.
// scratch: gridDim.x slots of 3 N floats.  Block b takes runs b, b + grid,
// ... of the rows x runs_per_row runs.
__global__ void __launch_bounds__(BG_THREADS)
istft_ct2_big_kernel(const float* __restrict__ re, const float* __restrict__ im,
                     const float* __restrict__ table, const float* __restrict__ window,
                     float* __restrict__ out, float* scratch, int rows, int T, int N,
                     int runs_per_row, int hops_per_run) {
  const int K = N / 1024, M = N / 2, HP = N / 4, F = M + 1, PAIRS = HP / 2;
  float* ar = scratch + (size_t)blockIdx.x * 3 * N;  // buffer A (re, im), buffer B, the ring
  float* ai = ar + M;
  float* br = ai + M;
  float* bi = br + M;
  float2* ring = reinterpret_cast<float2*>(bi + M);  // (RING, PAIRS)
  const int tid = threadIdx.x;
  const int hops = T + RING - 1;
  const float inv_n = 1.0f / (float)N;  // the transform's 1 / N, folded into the window
  int k_odd = K;  // K = k_odd x k_two
  while (k_odd % 2 == 0) k_odd /= 2;
  const int k_two = K / k_odd;

  for (int run = blockIdx.x; run < rows * runs_per_row; run += gridDim.x) {
    const int row = run / runs_per_row;
    const int a = (run % runs_per_row) * hops_per_run;
    const int b = min(a + hops_per_run, hops);
    if (a >= b) continue;
    const int t_hi = min(b - 1, T - 1);
    const int t_lo = max(a - (RING - 1), 0);
    float* out_r = out + (size_t)row * hops * HP;
    // a thread's ring entries are its own: no barrier between runs
    for (int q = tid; q < PAIRS; q += BG_THREADS) {
#pragma unroll
      for (int p = 0; p < RING; ++p) ring[p * PAIRS + q] = make_float2(0.0f, 0.0f);
    }

    for (int t = t_hi; t >= t_lo; --t) {
      const float* xr = re + ((size_t)row * T + t) * F;
      const float* xi = im + ((size_t)row * T + t) * F;
      __syncthreads();  // the previous frame's reads of both buffers are done
      for (int k = tid; k < M; k += BG_THREADS) unpack_point(xr, xi, table, N, M, k, ar[k], ai[k]);
      __syncthreads();
      // the frame in (fr, fi), the other buffer (gr, gi), swapped after each pass
      float *fr = ar, *fi = ai, *gr = br, *gi = bi;
      auto swap = [&]() {
        float* t0 = fr;
        fr = gr;
        gr = t0;
        t0 = fi;
        fi = gi;
        gi = t0;
        __syncthreads();
      };
      int ns = 1;
      if (k_odd > 1) {
        big_pass_odd(fr, fi, gr, gi, table, N, M, k_odd);
        ns = k_odd;
        swap();
      }
      for (int r = k_two; r > 1;) {
        if (r >= 8) {
          big_pass<8>(fr, fi, gr, gi, table, N, M, ns);
          ns *= 8;
          r /= 8;
        } else if (r == 4) {
          big_pass<4>(fr, fi, gr, gi, table, N, M, ns);
          ns *= 4;
          r = 1;
        } else {
          big_pass<2>(fr, fi, gr, gi, table, N, M, ns);
          ns *= 2;
          r = 1;
        }
        swap();
      }
      for (int pass = 0; pass < 3; ++pass) {
        big_pass<8>(fr, fi, gr, gi, table, N, M, ns);
        ns *= 8;
        swap();
      }

      // pair n = p PAIRS + q of the frame is piece p, pair q of hop t + p
      for (int q = tid; q < PAIRS; q += BG_THREADS) {
#pragma unroll
        for (int p = 0; p < RING; ++p) {
          const int n = p * PAIRS + q;
          ring_piece(ring + ((t + p) & (RING - 1)) * PAIRS + q, make_float2(fr[n], fi[n]),
                     window_pair(window, n, inv_n), p);
        }
      }
      const int h_first = t + RING - 1;
      const int h_last = t == 0 ? 0 : h_first;
      for (int h = h_first; h >= h_last; --h) {
        if (h >= a && h < b) {
          for (int q = tid; q < PAIRS; q += BG_THREADS)
            *reinterpret_cast<float2*>(out_r + (size_t)h * HP + 2 * q) =
                ring[(h & (RING - 1)) * PAIRS + q];
        }
      }
    }
  }
}

// The barrier before a cluster pass's reads or writes: the cluster's where
// another block's data crosses it, else the block's.
__device__ __forceinline__ void cl_barrier(cg::cluster_group& cluster, bool across) {
  if (across) {
    cluster.sync();
  } else {
    __syncthreads();
  }
}

// j / ns and j % ns, by shifts where ns is a power of two (ls = log2 ns;
// -1 otherwise)
__device__ __forceinline__ int div_ns(int j, int ns, int ls) { return ls >= 0 ? j >> ls : j / ns; }
__device__ __forceinline__ int mod_ns(int j, int ns, int ls) {
  return ls >= 0 ? j & (ns - 1) : j % ns;
}

// A radix-R Stockham pass of the cluster form, in place on the cluster's
// frame (point k in block k % C at k / C): butterfly j = c + C jl runs in
// block c, its R points there; writes cross blocks where ns % C != 0.  A
// thread stages S / R butterflies (S complex values) in registers.  ptw:
// the pass's twiddles where ns > 1, the cosines (R - 1, ns) then the sines,
// entry (q - 1, j % ns) the table's entry (j % ns) q N / (ns R): the same
// values, read by neighbouring lanes at neighbouring addresses.  `across`:
// whether the previous phase wrote to other blocks; on return, whether
// this one did.
template <int R, int S>
__device__ __forceinline__ void cluster_pass(cg::cluster_group& cluster, float* br, float* bi,
                                             const float* table, const float* ptw, int N, int M,
                                             int ns, int c, int lc, bool& across) {
  constexpr int BPT = S / R;  // butterflies a thread stages
  const int C = 1 << lc;
  const int nbl = (M / R) >> lc;  // butterflies a block runs
  const int ls = (ns & (ns - 1)) == 0 ? __ffs(ns) - 1 : -1;
  const bool remote = (ns & (C - 1)) != 0;
  cl_barrier(cluster, across);
  float vr[BPT][R], vi[BPT][R];
#pragma unroll
  for (int e = 0; e < BPT; ++e) {
    const int jl = threadIdx.x + e * CL_THREADS;
    if (jl < nbl) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        vr[e][q] = br[jl + q * nbl];
        vi[e][q] = bi[jl + q * nbl];
      }
      const int jm = mod_ns(c + (jl << lc), ns, ls);
      butterfly<R>(vr[e], vi[e], table, N, ns, [&](int q) {
        const int i = (q - 1) * ns + jm;
        return make_float2(__ldg(ptw + i), __ldg(ptw + (R - 1) * ns + i));
      });
    }
  }
  cl_barrier(cluster, remote);
#pragma unroll
  for (int e = 0; e < BPT; ++e) {
    const int jl = threadIdx.x + e * CL_THREADS;
    if (jl < nbl) {
      const int j = c + (jl << lc);
      const int d = div_ns(j, ns, ls) * ns * R + mod_ns(j, ns, ls);
      if (!remote) {
        // d + q ns = c (mod C): this block's, at (d + q ns) / C
#pragma unroll
        for (int q = 0; q < R; ++q) {
          br[(d >> lc) + q * (ns >> lc)] = vr[e][q];
          bi[(d >> lc) + q * (ns >> lc)] = vi[e][q];
        }
      } else {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int k = d + q * ns;
          const int rank = k & (C - 1);
          float* dr = rank == c ? br : cluster.map_shared_rank(br, rank);
          float* di = rank == c ? bi : cluster.map_shared_rank(bi, rank);
          dr[k >> lc] = vr[e][q];
          di[k >> lc] = vi[e][q];
        }
      }
    }
  }
  across = remote;
}

// As istft_ct2_big_kernel, with a frame and its ring in the shared memory
// of a cluster of C blocks (the launch's cluster dimension).  Dynamic
// shared memory 8 N / C bytes a block: its points (re, im: 2 x M / C
// floats) and its ring pairs (4 hops of N / 8 / C float2).  Cluster i
// takes run i of the rows x runs_per_row runs.  S: complex values a
// thread stages in a pass, at least M / C / CL_THREADS.  ptw: the radix
// passes' twiddles (cluster_pass), one pass after another in the plan's
// order, those with ns > 1.
template <int S>
__global__ void __launch_bounds__(CL_THREADS, 1)
istft_ct2_cluster_kernel(const float* __restrict__ re, const float* __restrict__ im,
                         const float* __restrict__ table, const float* __restrict__ ptw,
                         const float* __restrict__ window, float* __restrict__ out, int T, int N,
                         int runs_per_row, int hops_per_run) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int c = (int)cluster.block_rank();
  const int lc = __ffs(C) - 1;
  const int K = N / 1024, M = N / 2, HP = N / 4, F = M + 1, PAIRS = HP / 2;
  const int ML = M >> lc, PL = PAIRS >> lc;  // points and ring pairs a block holds
  extern __shared__ __align__(16) float cl_sm[];
  float* br = cl_sm;  // point c + C i at i
  float* bi = br + ML;
  float2* ring = reinterpret_cast<float2*>(bi + ML);  // (RING, PL): pair c + C i at i
  const int tid = threadIdx.x;
  const int run = blockIdx.x / C;
  const int row = run / runs_per_row;
  const int hops = T + RING - 1;
  const int a = (run % runs_per_row) * hops_per_run;
  const int b = min(a + hops_per_run, hops);
  // a whole cluster shares its run: all its blocks leave here or none
  if (a >= b) return;
  const int t_hi = min(b - 1, T - 1);
  const int t_lo = max(a - (RING - 1), 0);
  float* out_r = out + (size_t)row * hops * HP;
  const float inv_n = 1.0f / (float)N;
  int k_odd = K;
  while (k_odd % 2 == 0) k_odd /= 2;
  const int k_two = K / k_odd;
  for (int ql = tid; ql < PL; ql += CL_THREADS) {
#pragma unroll
    for (int p = 0; p < RING; ++p) ring[p * PL + ql] = make_float2(0.0f, 0.0f);
  }

  for (int t = t_hi; t >= t_lo; --t) {
    const float* xr = re + ((size_t)row * T + t) * F;
    const float* xi = im + ((size_t)row * T + t) * F;
    // the previous frame's last reads were of this block's own points
    __syncthreads();
    // the next frame's bins into L2 while this one is transformed: a line
    // of each plane a thread (the cluster's threads cover F floats in lines of 32)
    if (t > t_lo) {
      const int line = (c * CL_THREADS + tid) * 32;
      if (line < F) {
        prefetch_l2(xr - F + line);
        prefetch_l2(xi - F + line);
      }
    }
#pragma unroll 4
    for (int il = tid; il < ML; il += CL_THREADS)
      unpack_point(xr, xi, table, N, M, c + (il << lc), br[il], bi[il]);
    bool across = false;
    int ns = 1;
    if (k_odd > 1) {
      // the odd first pass: output n of butterfly j sums the points j + q
      // nb, all in block j % C (nb % C == 0), so a block computes the
      // outputs of its butterflies from its own points (at most S a
      // thread: nb / C butterflies of k_odd outputs are M / C), stages
      // them, and writes them, to any block, after the cluster's barrier.
      // Output-major (o = n nbl + j / C): a warp's lanes take neighbouring
      // butterflies at one n, so they read one twiddle and neighbouring
      // points, as the device-memory form's loop over j does.
      const int nb = M / k_odd, nbl = nb >> lc;
      auto at = [&](int k) { return make_float2(br[k >> lc], bi[k >> lc]); };
      __syncthreads();
      float2 y[S];
#pragma unroll
      for (int e = 0; e < S; ++e) {
        const int o = tid + e * CL_THREADS;
        if (o < nbl * k_odd)
          y[e] = odd_point(at, table, N, nb, k_odd, c + ((o % nbl) << lc), o / nbl);
      }
      cluster.sync();
#pragma unroll
      for (int e = 0; e < S; ++e) {
        const int o = tid + e * CL_THREADS;
        if (o < nbl * k_odd) {
          const int k = (c + ((o % nbl) << lc)) * k_odd + o / nbl;
          const int rank = k & (C - 1);
          float* dr = rank == c ? br : cluster.map_shared_rank(br, rank);
          float* di = rank == c ? bi : cluster.map_shared_rank(bi, rank);
          dr[k >> lc] = y[e].x;
          di[k >> lc] = y[e].y;
        }
      }
      across = true;
      ns = k_odd;
    }
    const float* tw = ptw;  // this pass's twiddles
    auto pass = [&](auto radix) {
      constexpr int R = decltype(radix)::value;
      cluster_pass<R, S>(cluster, br, bi, table, tw, N, M, ns, c, lc, across);
      if (ns > 1) tw += 2 * (R - 1) * ns;
      ns *= R;
    };
    for (int r = k_two; r > 1;) {
      if (r >= 8) {
        pass(std::integral_constant<int, 8>());
        r /= 8;
      } else if (r == 4) {
        pass(std::integral_constant<int, 4>());
        r = 1;
      } else {
        pass(std::integral_constant<int, 2>());
        r = 1;
      }
    }
    for (int k = 0; k < 3; ++k) pass(std::integral_constant<int, 8>());
    cl_barrier(cluster, across);

    // pair q = c + C ql: its points p PAIRS + q are this block's (PAIRS % C == 0)
    for (int ql = tid; ql < PL; ql += CL_THREADS) {
#pragma unroll
      for (int p = 0; p < RING; ++p) {
        const int n = p * PAIRS + c + (ql << lc);
        const int nl = p * PL + ql;
        ring_piece(ring + ((t + p) & (RING - 1)) * PL + ql, make_float2(br[nl], bi[nl]),
                   window_pair(window, n, inv_n), p);
      }
    }
    const int h_first = t + RING - 1;
    const int h_last = t == 0 ? 0 : h_first;
    for (int h = h_first; h >= h_last; --h) {
      if (h >= a && h < b) {
        for (int ql = tid; ql < PL; ql += CL_THREADS)
          *reinterpret_cast<float2*>(out_r + (size_t)h * HP + 2 * (c + (ql << lc))) =
              ring[(h & (RING - 1)) * PL + ql];
      }
    }
  }
  // no block leaves while another may still write to its shared memory
  cluster.sync();
}

// The cluster form's kernel for N with a cluster of C blocks, its staging
// the least of 8, 16 or 32 complex values a thread that holds a block's
// M / C points, with its dynamic shared memory (8 N / C bytes) allowed, and
// the launch's configuration; cudaErrorInvalidValue for a size or cluster
// it does not take.
cudaError_t cluster_setup(int N, int C, const void** fn, cudaLaunchConfig_t* cfg,
                          cudaLaunchAttribute* attr) {
  if (N <= 1024 * MR_K_MAX || N % 1024 != 0 || (C != 2 && C != 4 && C != CL_MAX))
    return cudaErrorInvalidValue;
  const int per_thread = (N / 2 / C + CL_THREADS - 1) / CL_THREADS;
  *fn = per_thread <= 8    ? (const void*)istft_ct2_cluster_kernel<8>
        : per_thread <= 16 ? (const void*)istft_ct2_cluster_kernel<16>
        : per_thread <= 32 ? (const void*)istft_ct2_cluster_kernel<32>
                           : nullptr;
  if (*fn == nullptr) return cudaErrorInvalidValue;
  const size_t smem = (size_t)8 * N / C;
  cudaError_t e = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->blockDim = dim3(CL_THREADS);
  cfg->dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The register form's kernel for n_fft = 1024 k, its dynamic shared memory
// and its block size; nullptr for a k it has no plan for (4096: the
// hand-scheduled form; odd k from 9: the mixed-radix form).  The plans are
// ops/istft_ct_cuda.py:REGISTER_PLANS.
const void* reg_kernel(int k, size_t* smem, int* threads) {
#define UMX_REG_PLAN(r1, r2, r3)                      \
  *smem = RegPlan<r1, r2, r3>::SMEM;                  \
  *threads = RegPlan<r1, r2, r3>::TH;                 \
  return (const void*)istft_ct2_reg_kernel<r1, r2, r3>;
  switch (k) {
    case 1: UMX_REG_PLAN(4, 16, 8)
    case 2: UMX_REG_PLAN(8, 16, 8)
    case 3: UMX_REG_PLAN(12, 16, 8)
    case 5: UMX_REG_PLAN(10, 16, 16)
    case 6: UMX_REG_PLAN(12, 16, 16)
    case 7: UMX_REG_PLAN(14, 16, 16)
    case 8: UMX_REG_PLAN(16, 16, 16)
    case 10: UMX_REG_PLAN(20, 16, 16)
    case 12: UMX_REG_PLAN(24, 16, 16)
    case 14: UMX_REG_PLAN(28, 16, 16)
    case 16: UMX_REG_PLAN(32, 16, 16)
    default: return nullptr;
  }
#undef UMX_REG_PLAN
}

// The register form's kernel for n_fft with its dynamic shared memory allowed
cudaError_t reg_setup(int n_fft, const void** fn, size_t* smem, int* threads) {
  if (n_fft < 1024 || n_fft % 1024 != 0 || n_fft / 1024 > MR_K_MAX) return cudaErrorInvalidValue;
  *fn = reg_kernel(n_fft / 1024, smem, threads);
  if (*fn == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// The kernel for n_fft = 1024 k and its dynamic shared memory; nullptr
// for a k it has no form for.
const void* istft_kernel(int k, size_t* smem) {
  *smem = mr_smem(k);
  switch (k) {
    case 1: return (const void*)istft_ct2_mr_kernel<1>;
    case 2: return (const void*)istft_ct2_mr_kernel<2>;
    case 3: return (const void*)istft_ct2_mr_kernel<3>;
    case 4: *smem = SMEM_BYTES; return (const void*)istft_ct2_kernel;
    case 5: return (const void*)istft_ct2_mr_kernel<5>;
    case 6: return (const void*)istft_ct2_mr_kernel<6>;
    case 7: return (const void*)istft_ct2_mr_kernel<7>;
    case 8: return (const void*)istft_ct2_mr_kernel<8>;
    case 9: return (const void*)istft_ct2_mr_kernel<9>;
    case 10: return (const void*)istft_ct2_mr_kernel<10>;
    case 11: return (const void*)istft_ct2_mr_kernel<11>;
    case 12: return (const void*)istft_ct2_mr_kernel<12>;
    case 13: return (const void*)istft_ct2_mr_kernel<13>;
    case 14: return (const void*)istft_ct2_mr_kernel<14>;
    case 15: return (const void*)istft_ct2_mr_kernel<15>;
    case 16: return (const void*)istft_ct2_mr_kernel<16>;
    default: return nullptr;
  }
}

// The kernel for n_fft with its dynamic shared memory allowed; its block
// size in `threads`.
cudaError_t istft_setup(int n_fft, const void** fn, size_t* smem, int* threads) {
  if (n_fft < 1024 || n_fft % 1024 != 0 || n_fft / 1024 > MR_K_MAX)
    return cudaErrorInvalidValue;
  *fn = istft_kernel(n_fft / 1024, smem);
  if (*fn == nullptr) return cudaErrorInvalidValue;
  *threads = n_fft == NW ? THREADS : MR_THREADS;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace

// Blocks of the kernel for n_fft that the current device holds at once,
// and the dynamic shared memory a block asks for (`smem`, bytes).  Above
// 16384, the device-memory form: one block an SM (its grid and its scratch
// slots; umx_istft_ct2_big) and no dynamic shared memory.
extern "C" int umx_istft_ct2_capacity(int n_fft, int* blocks, int* smem_bytes) {
  int dev = 0, sms = 0, per_sm = 0, threads = 0;
  const void* fn = nullptr;
  size_t smem = 0;
  *blocks = 0;
  *smem_bytes = 0;
  if (n_fft > 1024 * MR_K_MAX && n_fft % 1024 == 0) {
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    *blocks = sms;
    return (int)cudaSuccess;
  }
  cudaError_t e = istft_setup(n_fft, &fn, &smem, &threads);
  if (e != cudaSuccess) return (int)e;
  *smem_bytes = (int)smem;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  return (int)cudaSuccess;
}

// re/im (rows, T, F) f32 with F = N/2 + 1, table (2, N), window (N,) or null,
// out (rows, (T-1)*hop + N).  One launch of rows x runs_per_row blocks, each
// on hops_per_run output hops of its row.  Needs N = 1024 k with 1 <= k <= 16
// and hop = N/4 (checked by the wrapper; refused here as well).
extern "C" int umx_istft_ct2(const float* re, const float* im, const float* table,
                             const float* window, float* out, int rows, int T, int F, int N,
                             int hop, int runs_per_row, int hops_per_run, void* stream) {
  if (4 * hop != N || F != N / 2 + 1 || rows < 1 || T < 1 || runs_per_row < 1 ||
      hops_per_run < 1 || (long long)runs_per_row * hops_per_run < T + RING - 1 ||
      (long long)rows * runs_per_row > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  size_t smem = 0;
  int threads = 0;
  cudaError_t e = istft_setup(N, &fn, &smem, &threads);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&re, &im, &table, &window, &out, &T, &runs_per_row, &hops_per_run};
  e = cudaLaunchKernel(fn, dim3(rows * runs_per_row), dim3(threads), args, smem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The register form (n_fft = 1024 k up to 16384 with a plan in
// ops/istft_ct_cuda.py:REGISTER_PLANS): blocks the current device holds at
// once and the dynamic shared memory a block asks for.
extern "C" int umx_istft_ct2_reg_capacity(int n_fft, int* blocks, int* smem_bytes) {
  int dev = 0, sms = 0, per_sm = 0, threads = 0;
  const void* fn = nullptr;
  size_t smem = 0;
  *blocks = 0;
  *smem_bytes = 0;
  cudaError_t e = reg_setup(n_fft, &fn, &smem, &threads);
  if (e != cudaSuccess) return (int)e;
  *smem_bytes = (int)smem;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  return (int)cudaSuccess;
}

// The register form: the arguments of umx_istft_ct2, plus pass 1's
// twiddles `tw1` (ops/istft_ct_cuda.py:register_twiddles).
extern "C" int umx_istft_ct2_reg(const float* re, const float* im, const float* table,
                                 const float* tw1, const float* window, float* out, int rows,
                                 int T, int F, int N, int hop, int runs_per_row, int hops_per_run,
                                 void* stream) {
  if (4 * hop != N || F != N / 2 + 1 || rows < 1 || T < 1 || runs_per_row < 1 ||
      hops_per_run < 1 || (long long)runs_per_row * hops_per_run < T + RING - 1 ||
      (long long)rows * runs_per_row > 2147483647LL || tw1 == nullptr)
    return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  size_t smem = 0;
  int threads = 0;
  cudaError_t e = reg_setup(N, &fn, &smem, &threads);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&re, &im, &table, &tw1, &window, &out, &T, &runs_per_row, &hops_per_run};
  e = cudaLaunchKernel(fn, dim3(rows * runs_per_row), dim3(threads), args, smem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The cluster form, 16384 < N <= 232448: clusters of C blocks (2, 4 or 8)
// the current device holds at once, and the dynamic shared memory a block
// asks for (8 N / C bytes).  Returns the first CUDA error.
extern "C" int umx_istft_ct2_cluster_capacity(int n_fft, int cluster, int* clusters,
                                              int* smem_bytes) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* fn = nullptr;
  *clusters = 0;
  *smem_bytes = 0;
  cudaError_t e = cluster_setup(n_fft, cluster, &fn, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  *smem_bytes = (int)cfg.dynamicSmemBytes;
  cfg.gridDim = dim3(cluster);
  return (int)cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
}

// The cluster form: the arguments of umx_istft_ct2, plus the radix passes'
// twiddles `ptw` (ops/istft_ct_cuda.py:pass_twiddles) and the cluster's
// blocks C (2, 4 or 8, the smallest whose 8 N / C bytes fit a block: the
// wrapper's istft_cluster_size); one cluster a run, rows x runs_per_row
// clusters.
extern "C" int umx_istft_ct2_cluster(const float* re, const float* im, const float* table,
                                     const float* ptw, const float* window, float* out, int rows,
                                     int T, int F, int N, int hop, int cluster, int runs_per_row,
                                     int hops_per_run, void* stream) {
  if (4 * hop != N || F != N / 2 + 1 || rows < 1 || T < 1 || runs_per_row < 1 ||
      hops_per_run < 1 || (long long)runs_per_row * hops_per_run < T + RING - 1 ||
      (long long)rows * runs_per_row * cluster > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* fn = nullptr;
  cudaError_t e = cluster_setup(N, cluster, &fn, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3(rows * runs_per_row * cluster);
  cfg.stream = static_cast<cudaStream_t>(stream);
  void* args[] = {&re, &im, &table, &ptw, &window, &out, &T, &N, &runs_per_row, &hops_per_run};
  e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The device-memory form, N = 1024 k above 16384 (the wrapper runs it above
// the cluster form's 232448, and by name): the arguments of
// umx_istft_ct2, plus `scratch` (grid x 3 N floats) and the grid, at most
// rows x runs_per_row blocks (the blocks walk the runs grid-stride).
extern "C" int umx_istft_ct2_big(const float* re, const float* im, const float* table,
                                 const float* window, float* out, float* scratch, int rows, int T,
                                 int F, int N, int hop, int runs_per_row, int hops_per_run,
                                 int grid, void* stream) {
  if (N <= 1024 * MR_K_MAX || N % 1024 != 0 || 4 * hop != N || F != N / 2 + 1 || rows < 1 ||
      T < 1 || runs_per_row < 1 || hops_per_run < 1 ||
      (long long)runs_per_row * hops_per_run < T + RING - 1 || grid < 1 ||
      (long long)rows * runs_per_row > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  istft_ct2_big_kernel<<<grid, BG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      re, im, table, window, out, scratch, rows, T, N, runs_per_row, hops_per_run);
  return (int)cudaGetLastError();
}
