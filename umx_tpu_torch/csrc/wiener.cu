// The two passes of one multichannel Wiener-EM iteration, on (re, im)
// float32 planes in the (..., T, F) layout, for S = 4 sources and stereo.
//
// Replaces (umx_tpu/ops/wiener_pallas.py):
//   reduce, MODE_MASKS: _make_reduce_kernel_masks     (first iteration)
//   reduce, MODE_Y:     _make_reduce_kernel(from_mags=False)   (iterations >= 2)
//   apply,  MODE_MASKS: _make_apply_kernel_masks + _apply_common
//   apply,  MODE_Y:     _make_apply_kernel(from_mags=False) + _apply_common
//   reduce, MODE_MAGS:  _make_reduce_kernel(from_mags=True)   (wiener_filter_planes)
//   apply,  MODE_MAGS:  _make_apply_kernel(from_mags=True) + _apply_common
// The input mode is a template parameter, so each pass is one kernel.
// MODE_MAGS reads the target magnitudes (S, 2, T, F) with x: the first
// estimate is y_sc = mag_sc / max_abs * unit(x_c), with unit(0) = 1 + 0i
// and rsqrt elsewhere, as the TPU kernel's _unit_phasors.
//
// What bounds them on the H100: both are streaming passes over (T, F)
// planes with a few dozen flops per element and no tensor-core work, so
// device-memory bandwidth bounds them.  At a 60 s segment (T = 2584,
// F = 2049) reduce reads x and the masks or magnitudes (~254 MB) and apply
// reads them again and writes y (~593 MB).
//
// Design:
//  * reduce.  The TPU carried one accumulator across a sequential grid;
//    blocks here run in no order, so the sum is a fixed-order reduction
//    with no float atomics, in one launch.  A block of 8 warps owns 32
//    neighbouring bins (a warp's loads along f coalesce) and one slab of
//    time rows; warp w of the block is time lane w and walks the slab's
//    rows w, w + 8, w + 16, ..., keeping the 4*S sums (R00, R11, Re R01,
//    Im R01 per source) of its 32 bins in registers.  The 8 blocks that
//    share a bin group are one thread-block cluster, the slabs cut T into
//    eight in cluster-rank order.  The lanes' sums are added in lane order
//    in shared memory, then, after a cluster barrier, block r adds
//    statistics 2r and 2r+1 of the eight blocks in rank order through
//    distributed shared memory and stores them.  The order of every sum is
//    a function of (T, F) alone, so the result is bit-identical from run
//    to run and for a row whatever else runs.  Channel c of the masks is
//    read in place from the (S, T, 2F) tensor at offset c*F.
//    What held the first, two-pass form (pass 1 a grid of 128-bin x
//    64-row blocks, a second launch summing the partials) under half its
//    bound in mode mags: 21 warps an SM, each with one row's loads in
//    flight behind that row's unit phasors.  Here 65 x 8 blocks at
//    F = 2049 are 32 warps on each of the 132 SMs in one wave, and a
//    thread issues the loads of RB_AHEAD rows before their arithmetic.
//    F = 2049 makes a row 8196 bytes, not a multiple of 16, so there are
//    no 16-byte loads or TMA along f: bytes in flight come from warps and
//    rows issued ahead.
//  * apply.  One thread per (t, f): reads x, the masks (or y_in) and the
//    bin's 16 covariance sums, follows the operation order of the TPU
//    kernel's _apply_common (reg = sqrt(eps) added once, analytic
//    Hermitian 2x2 inverse, the source-independent z = Cxx^-1 x, final
//    x max_abs) and writes y (S, 2, T, F).
//  * 1/max_abs arrives as a device pointer, so no host sync is needed.
//  * Storage dtypes, as the TPU kernels take them (wiener_pallas.py
//    wiener_planes_from_masks / wiener_planes_pallas): the masks of mode
//    MASKS are read as float or __nv_bfloat16 (EngineConfig.mask_dtype)
//    and upcast in registers, exactly; the apply pass writes its y planes
//    as float or __nv_bfloat16 (WienerConfig.out_dtype, the last EM
//    iteration's only), rounded to nearest even after the float32
//    arithmetic.  The mask type and the output type are template
//    parameters, so each form is its own kernel and the float32 forms are
//    unchanged.  Rows of F = 2049 bf16 start on 2-byte boundaries only
//    (channel 1 of a mask row at byte 4098), so every bf16 access is a
//    scalar one; a warp's 32 neighbouring bins still coalesce.  bf16
//    halves the masks' read traffic in both passes and the apply pass's
//    dominant write.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int S = 4;          // sources (targets)
constexpr int BLOCK_F = 128;  // bins per block of the apply pass
// the reduce: bins per block, time lanes (warps) per block, blocks per
// cluster (the slabs of one bin group), rows whose loads a thread issues
// ahead
constexpr int RB_BINS = 32;
constexpr int RB_LANES = 8;
constexpr int RB_THREADS = RB_BINS * RB_LANES;
constexpr int RB_CLUSTER = 8;
constexpr int RB_AHEAD = 2;
constexpr int MODE_MASKS = 0;
constexpr int MODE_Y = 1;
constexpr int MODE_MAGS = 2;

using bf16 = __nv_bfloat16;

// a stored element as float32 (bf16 -> f32 is exact)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// store a float32 result in the output's dtype (bf16: round to nearest even)
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// x / |x| as (re, im); |x| = 0 gives 1 + 0i
__device__ __forceinline__ void unit_phasor(float re, float im, float* ure, float* uim) {
  const float a2 = re * re + im * im;
  const bool nz = a2 > 0.0f;
  const float rs = rsqrtf(nz ? a2 : 1.0f);
  *ure = nz ? re * rs : 1.0f;
  *uim = nz ? im * rs : 0.0f;
}

// One time row of one bin, as the reduce reads it.  a_re/a_im: MODE_MASKS
// and MODE_MAGS: mix planes (2, T, F); MODE_Y: y planes (S, 2, T, F).
// masks: (S, T, 2F) masks of element type MT (float or bf16), or MODE_MAGS'
// (S, 2, T, F) float magnitudes.
template <int MODE, typename MT>
struct ReduceRow;

template <typename MT>
struct ReduceRow<MODE_MASKS, MT> {
  float x0r, x0i, x1r, x1i, m[S][2];
  __device__ __forceinline__ void load(const float* a_re, const float* a_im, const MT* masks,
                                       size_t TF, int T, int F, int t, int f) {
    const size_t i = (size_t)t * F + f;
    x0r = a_re[i];
    x0i = a_im[i];
    x1r = a_re[TF + i];
    x1i = a_im[TF + i];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const size_t mi = ((size_t)s * T + t) * 2 * F + f;
      m[s][0] = to_f32(masks[mi]);
      m[s][1] = to_f32(masks[mi + F]);
    }
  }
  __device__ __forceinline__ void add(float* acc, float) const {
    const float ax0 = x0r * x0r + x0i * x0i;
    const float ax1 = x1r * x1r + x1i * x1i;
    const float cr = x0r * x1r + x0i * x1i;  // x0 conj(x1)
    const float ci = x0i * x1r - x0r * x1i;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float m0 = m[s][0], m1 = m[s][1];
      const float m01 = m0 * m1;
      acc[4 * s + 0] += m0 * m0 * ax0;
      acc[4 * s + 1] += m1 * m1 * ax1;
      acc[4 * s + 2] += m01 * cr;
      acc[4 * s + 3] += m01 * ci;
    }
  }
};

template <>
struct ReduceRow<MODE_MAGS, float> {
  float x0r, x0i, x1r, x1i, m[S][2];
  __device__ __forceinline__ void load(const float* a_re, const float* a_im, const float* mags,
                                       size_t TF, int, int F, int t, int f) {
    const size_t i = (size_t)t * F + f;
    x0r = a_re[i];
    x0i = a_im[i];
    x1r = a_re[TF + i];
    x1i = a_im[TF + i];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const size_t c0 = (size_t)(2 * s) * TF + i;
      m[s][0] = mags[c0];
      m[s][1] = mags[c0 + TF];
    }
  }
  __device__ __forceinline__ void add(float* acc, float inv) const {
    float u0r, u0i, u1r, u1i;
    unit_phasor(x0r, x0i, &u0r, &u0i);
    unit_phasor(x1r, x1i, &u1r, &u1i);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float m0 = m[s][0] * inv;
      const float m1 = m[s][1] * inv;
      const float yr0 = m0 * u0r, yi0 = m0 * u0i;
      const float yr1 = m1 * u1r, yi1 = m1 * u1i;
      acc[4 * s + 0] += yr0 * yr0 + yi0 * yi0;
      acc[4 * s + 1] += yr1 * yr1 + yi1 * yi1;
      acc[4 * s + 2] += yr0 * yr1 + yi0 * yi1;
      acc[4 * s + 3] += yi0 * yr1 - yr0 * yi1;
    }
  }
};

template <>
struct ReduceRow<MODE_Y, float> {
  // the 8 planes it reads with the evict-first hint: faster in this mode
  // on the H100, slower in the others (chip_forms.py wiener_reduce)
  float yr[S][2], yi[S][2];
  __device__ __forceinline__ void load(const float* a_re, const float* a_im, const float*,
                                       size_t TF, int, int F, int t, int f) {
    const size_t i = (size_t)t * F + f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const size_t c0 = (size_t)(2 * s) * TF + i;
      yr[s][0] = __ldcs(a_re + c0);
      yi[s][0] = __ldcs(a_im + c0);
      yr[s][1] = __ldcs(a_re + c0 + TF);
      yi[s][1] = __ldcs(a_im + c0 + TF);
    }
  }
  __device__ __forceinline__ void add(float* acc, float) const {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float yr0 = yr[s][0], yi0 = yi[s][0], yr1 = yr[s][1], yi1 = yi[s][1];
      acc[4 * s + 0] += yr0 * yr0 + yi0 * yi0;
      acc[4 * s + 1] += yr1 * yr1 + yi1 * yi1;
      acc[4 * s + 2] += yr0 * yr1 + yi0 * yi1;
      acc[4 * s + 3] += yi0 * yr1 - yr0 * yi1;
    }
  }
};

// grid (ceil(F / RB_BINS), RB_CLUSTER), clusters of the RB_CLUSTER blocks
// of one bin group; racc (4S, F).
template <int MODE, typename MT>
__global__ void __cluster_dims__(1, RB_CLUSTER, 1) __launch_bounds__(RB_THREADS)
    wiener_reduce_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
                  const MT* __restrict__ masks,      // (S, T, 2F) or (S, 2, T, F)
                  const float* __restrict__ inv_ma,  // (1,)
                  float* __restrict__ racc,          // (4S, F)
                  int T, int F) {
  __shared__ float lanes[RB_LANES][4 * S][RB_BINS];
  __shared__ float block_sum[4 * S][RB_BINS];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int f = blockIdx.x * RB_BINS + lane;
  const size_t TF = (size_t)T * F;
  const float inv = inv_ma[0];
  // this block's slab of time rows
  const int t_hi = (int)((long long)(rank + 1) * T / RB_CLUSTER);
  int t = (int)((long long)rank * T / RB_CLUSTER) + w;

  float acc[4 * S];
#pragma unroll
  for (int i = 0; i < 4 * S; ++i) acc[i] = 0.0f;
  if (f < F) {
    // RB_AHEAD rows' loads before their arithmetic; the sums stay in row order
    for (; t + (RB_AHEAD - 1) * RB_LANES < t_hi; t += RB_AHEAD * RB_LANES) {
      ReduceRow<MODE, MT> rows[RB_AHEAD];
#pragma unroll
      for (int u = 0; u < RB_AHEAD; ++u) rows[u].load(a_re, a_im, masks, TF, T, F, t + u * RB_LANES, f);
#pragma unroll
      for (int u = 0; u < RB_AHEAD; ++u) rows[u].add(acc, inv);
    }
    for (; t < t_hi; t += RB_LANES) {
      ReduceRow<MODE, MT> row;
      row.load(a_re, a_im, masks, TF, T, F, t, f);
      row.add(acc, inv);
    }
  }
#pragma unroll
  for (int i = 0; i < 4 * S; ++i) lanes[w][i][lane] = acc[i];
  __syncthreads();
  // the block's sums: its time lanes in lane order
  for (int q = threadIdx.x; q < 4 * S * RB_BINS; q += RB_THREADS) {
    const int i = q / RB_BINS, b = q % RB_BINS;
    float s = lanes[0][i][b];
#pragma unroll
    for (int l = 1; l < RB_LANES; ++l) s += lanes[l][i][b];
    block_sum[i][b] = s;
  }
  cluster.sync();
  // block `rank` finishes statistics 2*rank and 2*rank + 1: the slabs in
  // rank order (the masks-mode statistics are of y = mask * x / max_abs)
  static_assert(4 * S == 2 * RB_CLUSTER, "two statistics a block");
  if (threadIdx.x < 2 * RB_BINS) {
    const int i = 2 * rank + threadIdx.x / RB_BINS, b = threadIdx.x % RB_BINS;
    float s = cluster.map_shared_rank(&block_sum[0][0], 0)[i * RB_BINS + b];
#pragma unroll
    for (int k = 1; k < RB_CLUSTER; ++k) s += cluster.map_shared_rank(&block_sum[0][0], k)[i * RB_BINS + b];
    if (MODE == MODE_MASKS) s *= inv * inv;
    const int fo = blockIdx.x * RB_BINS + b;
    if (fo < F) racc[(size_t)i * F + fo] = s;
  }
  // no block leaves while another still reads its shared memory
  cluster.sync();
}

// MT: the masks' element type (MODE_MASKS; float in the other modes); OT:
// the y planes' element type.
template <int MODE, typename MT, typename OT>
__global__ void apply_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                             // masks (S,T,2F), or mags or y_re (S,2,T,F)
                             const MT* __restrict__ m_or_yre,
                             const float* __restrict__ y_im,      // y_im (S,2,T,F); MODE_Y only
                             const float* __restrict__ racc,      // (4S, F)
                             const float* __restrict__ inv_ma_p,  // (1,)
                             OT* __restrict__ yre_out, OT* __restrict__ yim_out,
                             int T, int F, float eps, float reg) {
  const int f = blockIdx.x * BLOCK_F + threadIdx.x;
  const int t = blockIdx.y;
  if (f >= F) return;
  const size_t TF = (size_t)T * F;
  const size_t i = (size_t)t * F + f;
  const float inv_ma = inv_ma_p[0];

  float v[S];
  if (MODE == MODE_MASKS) {
    const float sq = inv_ma * inv_ma;
    const float ax0 = xre[i] * xre[i] + xim[i] * xim[i];
    const float ax1 = xre[TF + i] * xre[TF + i] + xim[TF + i] * xim[TF + i];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const size_t mi = ((size_t)s * T + t) * 2 * F + f;
      const float m0 = to_f32(m_or_yre[mi]);
      const float m1 = to_f32(m_or_yre[mi + F]);
      v[s] = 0.5f * sq * (m0 * m0 * ax0 + m1 * m1 * ax1);
    }
  } else if (MODE == MODE_MAGS) {
    const float sq = inv_ma * inv_ma;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const size_t c0 = (size_t)(2 * s) * TF + i;
      const float m0 = to_f32(m_or_yre[c0]);
      const float m1 = to_f32(m_or_yre[c0 + TF]);
      v[s] = 0.5f * sq * (m0 * m0 + m1 * m1);
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const size_t c0 = (size_t)(2 * s) * TF + i;
      const float a = to_f32(m_or_yre[c0]), b = y_im[c0];
      const float c = to_f32(m_or_yre[c0 + TF]), d = y_im[c0 + TF];
      v[s] = 0.5f * (a * a + b * b + c * c + d * d);
    }
  }

  const float x0re = xre[i] * inv_ma, x0im = xim[i] * inv_ma;
  const float x1re = xre[TF + i] * inv_ma, x1im = xim[TF + i] * inv_ma;

  float r00[S], r11[S], r01re[S], r01im[S];
  float c00 = reg, c11 = reg, c01re = 0.0f, c01im = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float a00 = racc[(size_t)(4 * s + 0) * F + f];
    const float a11 = racc[(size_t)(4 * s + 1) * F + f];
    const float w = eps + 0.5f * (a00 + a11);  // sum_t v_s
    const float inv_w = 1.0f / w;
    r00[s] = a00 * inv_w;
    r11[s] = a11 * inv_w;
    r01re[s] = racc[(size_t)(4 * s + 2) * F + f] * inv_w;
    r01im[s] = racc[(size_t)(4 * s + 3) * F + f] * inv_w;
    c00 += v[s] * r00[s];
    c11 += v[s] * r11[s];
    c01re += v[s] * r01re[s];
    c01im += v[s] * r01im[s];
  }

  // Hermitian 2x2 inverse: det is real; z = Cxx^-1 x is source-independent
  const float det = c00 * c11 - (c01re * c01re + c01im * c01im);
  const float idet = 1.0f / det;
  const float z0re = (c11 * x0re - (c01re * x1re - c01im * x1im)) * idet;
  const float z0im = (c11 * x0im - (c01re * x1im + c01im * x1re)) * idet;
  const float z1re = (c00 * x1re - (c01re * x0re + c01im * x0im)) * idet;
  const float z1im = (c00 * x1im - (c01re * x0im - c01im * x0re)) * idet;

  const float ma = 1.0f / inv_ma;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float vs = v[s] * ma;
    const size_t o0 = (size_t)(2 * s) * TF + i;
    // y_s0 = v (R00 z0 + R01 z1); y_s1 = v (conj(R01) z0 + R11 z1)
    store(yre_out + o0, vs * (r00[s] * z0re + r01re[s] * z1re - r01im[s] * z1im));
    store(yim_out + o0, vs * (r00[s] * z0im + r01re[s] * z1im + r01im[s] * z1re));
    store(yre_out + o0 + TF, vs * (r01re[s] * z0re + r01im[s] * z0im + r11[s] * z1re));
    store(yim_out + o0 + TF, vs * (r01re[s] * z0im - r01im[s] * z0re + r11[s] * z1im));
  }
}

template <int MODE, typename MT>
int launch_reduce(const float* a_re, const float* a_im, const void* masks, const float* inv_ma,
                  float* racc, int T, int F, cudaStream_t st) {
  const dim3 grid((F + RB_BINS - 1) / RB_BINS, RB_CLUSTER);
  wiener_reduce_kernel<MODE, MT><<<grid, RB_THREADS, 0, st>>>(
      a_re, a_im, static_cast<const MT*>(masks), inv_ma, racc, T, F);
  return (int)cudaGetLastError();
}

template <int MODE, typename MT, typename OT>
int launch_apply(const float* xre, const float* xim, const void* m_or_yre, const float* y_im,
                 const float* racc, const float* inv_ma, void* yre_out, void* yim_out, int T,
                 int F, float eps, float reg, cudaStream_t st) {
  const dim3 grid((F + BLOCK_F - 1) / BLOCK_F, T);
  apply_kernel<MODE, MT, OT><<<grid, BLOCK_F, 0, st>>>(
      xre, xim, static_cast<const MT*>(m_or_yre), y_im, racc, inv_ma, static_cast<OT*>(yre_out),
      static_cast<OT*>(yim_out), T, F, eps, reg);
  return (int)cudaGetLastError();
}

template <int MODE, typename MT>
int launch_apply_out(int out_bf16, const float* xre, const float* xim, const void* m_or_yre,
                     const float* y_im, const float* racc, const float* inv_ma, void* yre_out,
                     void* yim_out, int T, int F, float eps, float reg, cudaStream_t st) {
  return out_bf16 ? launch_apply<MODE, MT, bf16>(xre, xim, m_or_yre, y_im, racc, inv_ma, yre_out,
                                                 yim_out, T, F, eps, reg, st)
                  : launch_apply<MODE, MT, float>(xre, xim, m_or_yre, y_im, racc, inv_ma, yre_out,
                                                  yim_out, T, F, eps, reg, st);
}

}  // namespace

// racc: (4S, F) result; one launch.  mask_bf16: the masks of mode MASKS are
// bf16 (other modes read float32 only).
extern "C" int umx_wiener_reduce(int mode, int mask_bf16, const float* a_re, const float* a_im,
                                 const void* masks, const float* inv_ma, float* racc, int T,
                                 int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || F < 1 || (mask_bf16 && mode != MODE_MASKS)) return (int)cudaErrorInvalidValue;
  if (mode == MODE_MASKS) {
    return mask_bf16 ? launch_reduce<MODE_MASKS, bf16>(a_re, a_im, masks, inv_ma, racc, T, F, st)
                     : launch_reduce<MODE_MASKS, float>(a_re, a_im, masks, inv_ma, racc, T, F, st);
  } else if (mode == MODE_Y) {
    return launch_reduce<MODE_Y, float>(a_re, a_im, masks, inv_ma, racc, T, F, st);
  } else if (mode == MODE_MAGS) {
    return launch_reduce<MODE_MAGS, float>(a_re, a_im, masks, inv_ma, racc, T, F, st);
  }
  return (int)cudaErrorInvalidValue;
}

// mask_bf16: as umx_wiener_reduce; out_bf16: the y planes are bf16.
extern "C" int umx_wiener_apply(int mode, int mask_bf16, int out_bf16, const float* xre,
                                const float* xim, const void* m_or_yre, const float* y_im,
                                const float* racc, const float* inv_ma, void* yre_out,
                                void* yim_out, int T, int F, float eps, float reg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || F < 1 || (mask_bf16 && mode != MODE_MASKS)) return (int)cudaErrorInvalidValue;
  if (mode == MODE_MASKS) {
    return mask_bf16
        ? launch_apply_out<MODE_MASKS, bf16>(out_bf16, xre, xim, m_or_yre, y_im, racc, inv_ma,
                                             yre_out, yim_out, T, F, eps, reg, st)
        : launch_apply_out<MODE_MASKS, float>(out_bf16, xre, xim, m_or_yre, y_im, racc, inv_ma,
                                              yre_out, yim_out, T, F, eps, reg, st);
  } else if (mode == MODE_Y) {
    return launch_apply_out<MODE_Y, float>(out_bf16, xre, xim, m_or_yre, y_im, racc, inv_ma,
                                           yre_out, yim_out, T, F, eps, reg, st);
  } else if (mode == MODE_MAGS) {
    return launch_apply_out<MODE_MAGS, float>(out_bf16, xre, xim, m_or_yre, y_im, racc, inv_ma,
                                              yre_out, yim_out, T, F, eps, reg, st);
  }
  return (int)cudaErrorInvalidValue;
}
