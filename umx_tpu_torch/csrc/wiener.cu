// The two passes of one multichannel Wiener-EM iteration, on (re, im)
// float32 planes in the (..., T, F) layout, for S = 4 sources and stereo.
//
// Replaces (umx_tpu/ops/wiener_pallas.py):
//   reduce, MODE_MASKS: _make_reduce_kernel_masks     (first iteration)
//   reduce, MODE_Y:     _make_reduce_kernel(from_mags=False)   (iterations >= 2)
//   apply,  MODE_MASKS: _make_apply_kernel_masks + _apply_common
//   apply,  MODE_Y:     _make_apply_kernel(from_mags=False) + _apply_common
// The input mode is a template parameter, so each pass is one kernel.
//
// What bounds them on the H100: both are streaming passes over (T, F)
// planes with a few dozen flops per element and no tensor-core work, so
// device-memory bandwidth bounds them.  At a 60 s segment (T = 2584,
// F = 2049) reduce reads x and the masks (~254 MB) and apply reads them
// again and writes y (~593 MB).
//
// Design:
//  * reduce.  The TPU carried one accumulator across a sequential grid;
//    blocks here run in no order, so the sum is a deterministic two-pass
//    reduction with no float atomics: pass 1, grid (ceil(F/128),
//    n_time_chunks), gives each thread one bin f and one chunk of time
//    rows and writes its 4*S sums (R00, R11, Re R01, Im R01 per source)
//    to partials (n_chunks, 4S, F); pass 2 sums the chunk axis in order.
//    The result is bit-identical from run to run.  Neighbouring threads
//    read neighbouring bins, so every load coalesces.  Channel c of the
//    masks is read in place from the (S, T, 2F) tensor at offset c*F.
//  * apply.  One thread per (t, f): reads x, the masks (or y_in) and the
//    bin's 16 covariance sums, follows the operation order of the TPU
//    kernel's _apply_common (reg = sqrt(eps) added once, analytic
//    Hermitian 2x2 inverse, the source-independent z = Cxx^-1 x, final
//    x max_abs) and writes y (S, 2, T, F).
//  * 1/max_abs arrives as a device pointer, so no host sync is needed.

#include <cuda_runtime.h>

namespace {

constexpr int S = 4;          // sources (targets)
constexpr int BLOCK_F = 128;  // bins per block
constexpr int MODE_MASKS = 0;
constexpr int MODE_Y = 1;

// a_re/a_im: MODE_MASKS: mix planes (2, T, F); MODE_Y: y planes (S, 2, T, F)
template <int MODE>
__global__ void reduce_partial_kernel(const float* __restrict__ a_re,
                                      const float* __restrict__ a_im,
                                      const float* __restrict__ masks,   // (S, T, 2F)
                                      const float* __restrict__ inv_ma,  // (1,)
                                      float* __restrict__ partials,      // (n_chunks, 4S, F)
                                      int T, int F, int t_chunk) {
  const int f = blockIdx.x * BLOCK_F + threadIdx.x;
  if (f >= F) return;
  const int chunk = blockIdx.y;
  const int t0 = chunk * t_chunk;
  const int t1 = min(T, t0 + t_chunk);
  const size_t TF = (size_t)T * F;

  float acc[4 * S];
#pragma unroll
  for (int i = 0; i < 4 * S; ++i) acc[i] = 0.0f;

  for (int t = t0; t < t1; ++t) {
    const size_t i = (size_t)t * F + f;
    if (MODE == MODE_MASKS) {
      const float x0r = a_re[i], x0i = a_im[i];
      const float x1r = a_re[TF + i], x1i = a_im[TF + i];
      const float ax0 = x0r * x0r + x0i * x0i;
      const float ax1 = x1r * x1r + x1i * x1i;
      const float cr = x0r * x1r + x0i * x1i;   // x0 conj(x1)
      const float ci = x0i * x1r - x0r * x1i;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const size_t mi = ((size_t)s * T + t) * 2 * F + f;
        const float m0 = masks[mi];
        const float m1 = masks[mi + F];
        const float m01 = m0 * m1;
        acc[4 * s + 0] += m0 * m0 * ax0;
        acc[4 * s + 1] += m1 * m1 * ax1;
        acc[4 * s + 2] += m01 * cr;
        acc[4 * s + 3] += m01 * ci;
      }
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const size_t c0 = (size_t)(2 * s) * TF + i;
        const float yr0 = a_re[c0], yi0 = a_im[c0];
        const float yr1 = a_re[c0 + TF], yi1 = a_im[c0 + TF];
        acc[4 * s + 0] += yr0 * yr0 + yi0 * yi0;
        acc[4 * s + 1] += yr1 * yr1 + yi1 * yi1;
        acc[4 * s + 2] += yr0 * yr1 + yi0 * yi1;
        acc[4 * s + 3] += yi0 * yr1 - yr0 * yi1;
      }
    }
  }
  // the masks-mode statistics are of y = mask * x / max_abs
  float scale = 1.0f;
  if (MODE == MODE_MASKS) {
    const float inv = inv_ma[0];
    scale = inv * inv;
  }
  float* out = partials + (size_t)chunk * 4 * S * F + f;
#pragma unroll
  for (int r = 0; r < 4 * S; ++r) out[(size_t)r * F] = acc[r] * scale;
}

__global__ void reduce_sum_kernel(const float* __restrict__ partials, float* __restrict__ racc,
                                  int n_chunks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < n_chunks; ++k) s += partials[(size_t)k * n + i];
  racc[i] = s;
}

template <int MODE>
__global__ void apply_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                             const float* __restrict__ m_or_yre,  // masks (S,T,2F) or y_re (S,2,T,F)
                             const float* __restrict__ y_im,      // y_im (S,2,T,F); MODE_Y only
                             const float* __restrict__ racc,      // (4S, F)
                             const float* __restrict__ inv_ma_p,  // (1,)
                             float* __restrict__ yre_out, float* __restrict__ yim_out,
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
      const float m0 = m_or_yre[mi];
      const float m1 = m_or_yre[mi + F];
      v[s] = 0.5f * sq * (m0 * m0 * ax0 + m1 * m1 * ax1);
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const size_t c0 = (size_t)(2 * s) * TF + i;
      const float a = m_or_yre[c0], b = y_im[c0];
      const float c = m_or_yre[c0 + TF], d = y_im[c0 + TF];
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
    yre_out[o0] = vs * (r00[s] * z0re + r01re[s] * z1re - r01im[s] * z1im);
    yim_out[o0] = vs * (r00[s] * z0im + r01re[s] * z1im + r01im[s] * z1re);
    yre_out[o0 + TF] = vs * (r01re[s] * z0re + r01im[s] * z0im + r11[s] * z1re);
    yim_out[o0 + TF] = vs * (r01re[s] * z0im - r01im[s] * z0re + r11[s] * z1im);
  }
}

}  // namespace

// partials: (ceil(T/t_chunk), 4S, F) scratch; racc: (4S, F) result.
extern "C" int umx_wiener_reduce(int mode, const float* a_re, const float* a_im,
                                 const float* masks, const float* inv_ma, float* partials,
                                 float* racc, int T, int F, int t_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (T + t_chunk - 1) / t_chunk;
  const dim3 grid((F + BLOCK_F - 1) / BLOCK_F, n_chunks);
  if (mode == MODE_MASKS) {
    reduce_partial_kernel<MODE_MASKS><<<grid, BLOCK_F, 0, st>>>(a_re, a_im, masks, inv_ma,
                                                               partials, T, F, t_chunk);
  } else if (mode == MODE_Y) {
    reduce_partial_kernel<MODE_Y><<<grid, BLOCK_F, 0, st>>>(a_re, a_im, masks, inv_ma,
                                                           partials, T, F, t_chunk);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = 4 * S * F;
  reduce_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(partials, racc, n_chunks, n);
  return (int)cudaGetLastError();
}

extern "C" int umx_wiener_apply(int mode, const float* xre, const float* xim,
                                const float* m_or_yre, const float* y_im, const float* racc,
                                const float* inv_ma, float* yre_out, float* yim_out, int T,
                                int F, float eps, float reg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((F + BLOCK_F - 1) / BLOCK_F, T);
  if (mode == MODE_MASKS) {
    apply_kernel<MODE_MASKS><<<grid, BLOCK_F, 0, st>>>(xre, xim, m_or_yre, y_im, racc, inv_ma,
                                                      yre_out, yim_out, T, F, eps, reg);
  } else if (mode == MODE_Y) {
    apply_kernel<MODE_Y><<<grid, BLOCK_F, 0, st>>>(xre, xim, m_or_yre, y_im, racc, inv_ma,
                                                  yre_out, yim_out, T, F, eps, reg);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
