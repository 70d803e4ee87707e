// K7: the normalized overlap-add that finishes every whole-track demix.
//
// Replaces umx_tpu/ops/ola_pallas.py::_transpose_kernel (through _ola_impl
// and overlap_add_normalized).  The TPU kernel is only the DMA transpose of
// chunk-major (n_chunks, M, stride) blocks to time-major rows, with the
// combine and the 1/sw multiply left to XLA, because VMEM tiling made the
// layout change the expensive step.  On the GPU the whole of _ola_impl is
// one gather pass:
//
//   out[m, n] = (ys[k, m, n - k*stride] + tail of chunk k-1) * inv_sw[n],
//   k = n / stride,
//
// and the samples past n_chunks*stride are the last chunk's tail alone.
// Every output sums the same two addends as the plain version, in the same
// order, with no FMA (__fadd_rn, then __fmul_rn), so the result is
// bit-equal to it.
//
// What bounds it on the H100: one read of ys and of inv_sw and one write of
// the output (0.49 GB at M = 8 rows of a 100 s UMX-L track, 0.96 GB at
// M = 16), no arithmetic to speak of: device-memory bandwidth.
//
// Design.  The first form gave each thread one output sample of one row, in
// a grid with the rows on its y axis; the card walked row 0 over the whole
// track before row 1, so inv_sw (26.5 MB) fell out of L2 between rows and
// came from device memory once a row, and every sample paid a 32-bit
// division and 64-bit index arithmetic.  Here:
//  * one block an SM; warp w of NW owns the samples [w*L/NW, (w+1)*L/NW)
//    of every row, cut at multiples of the vector width, so the warps'
//    shares differ by at most one vector;
//  * a warp walks its share in runs that never cross a chunk boundary: k
//    and the run's offsets are computed once a run, then a lane takes
//    every 32nd vector of the run;
//  * a lane loads its vector of inv_sw once and loops over all M rows with
//    it, so inv_sw is read from device memory once in all; the loads of
//    R_AHEAD rows (head and tail) are issued before their stores;
//  * vectors are 16 bytes (float4) where seg and stride are multiples of 4
//    and the pointers 16-byte aligned (60 s segments at 25 % overlap and
//    44.1 kHz are); otherwise the same kernel walks the runs in scalars.
// Plain loads and stores: the streaming hints (__ldcs, __stcs) and fewer
// rows ahead were slower on the H100, and so was a warp that walks its
// share once a row (chip_forms.py ola).  No shared memory, no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int R_AHEAD = 8;    // rows whose loads a lane issues together

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T ld(const float* p) { return *p; }
  static __device__ __forceinline__ void st(float* p, T v) { *p = v; }
  static __device__ __forceinline__ T combine(T head, T prev, T inv) {
    return __fmul_rn(__fadd_rn(head, prev), inv);
  }
  static __device__ __forceinline__ T scale(T v, T inv) { return __fmul_rn(v, inv); }
  static __device__ __forceinline__ T zero() { return 0.0f; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T ld(const float* p) { return *reinterpret_cast<const float4*>(p); }
  static __device__ __forceinline__ void st(float* p, T v) { *reinterpret_cast<float4*>(p) = v; }
  static __device__ __forceinline__ T combine(T h, T p, T inv) {
    return make_float4(__fmul_rn(__fadd_rn(h.x, p.x), inv.x), __fmul_rn(__fadd_rn(h.y, p.y), inv.y),
                       __fmul_rn(__fadd_rn(h.z, p.z), inv.z), __fmul_rn(__fadd_rn(h.w, p.w), inv.w));
  }
  static __device__ __forceinline__ T scale(T v, T inv) {
    return make_float4(__fmul_rn(v.x, inv.x), __fmul_rn(v.y, inv.y), __fmul_rn(v.z, inv.z),
                       __fmul_rn(v.w, inv.w));
  }
  static __device__ __forceinline__ T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
};

// One warp's share [a, b) of every row, V samples a lane at a time.
template <int V>
__device__ __forceinline__ void ola_share(const float* __restrict__ ys,
                                          const float* __restrict__ inv_sw,
                                          float* __restrict__ out, int n_chunks, int M, int seg,
                                          int stride, int L, int a, int b, int lane) {
  using W = Vec<V>;
  const int tail = seg - stride;
  const size_t chunk_step = (size_t)M * seg;  // from chunk k to chunk k+1, same row
  for (int n = a; n < b;) {
    // one run: the samples of [n, e) lie in chunk k's stride (k = n_chunks:
    // the last chunk's tail past n_chunks*stride)
    const int k = n / stride;
    const int k0 = k * stride;
    const int e = k < n_chunks ? min(b, k0 + stride) : b;
    const float* head_run = ys + (size_t)k * chunk_step - k0;
    const float* prev_run = ys + (size_t)(k - 1) * chunk_step + stride - k0;
    for (int s = n + lane * V; s < e; s += 32 * V) {
      const bool has_prev = k > 0 && s - k0 < tail;
      const typename W::T inv = W::ld(inv_sw + s);
      const float* hp = head_run + s;
      const float* pp = prev_run + s;
      float* op = out + s;
      // rows in groups of R_AHEAD: every load of a group is issued before
      // its stores, so a lane keeps up to 2 * R_AHEAD loads in flight
      int m = 0;
      if (k < n_chunks) {
        for (; m < M; m += R_AHEAD) {
          typename W::T h[R_AHEAD], p[R_AHEAD];
#pragma unroll
          for (int r = 0; r < R_AHEAD; ++r) {
            if (m + r < M) {
              h[r] = W::ld(hp + (size_t)r * seg);
              p[r] = has_prev ? W::ld(pp + (size_t)r * seg) : W::zero();
            }
          }
#pragma unroll
          for (int r = 0; r < R_AHEAD; ++r) {
            if (m + r < M) W::st(op + (size_t)r * L, W::combine(h[r], p[r], inv));
          }
          hp += (size_t)R_AHEAD * seg;
          pp += (size_t)R_AHEAD * seg;
          op += (size_t)R_AHEAD * L;
        }
      } else {
        for (; m < M; m += R_AHEAD) {
          typename W::T p[R_AHEAD];
#pragma unroll
          for (int r = 0; r < R_AHEAD; ++r) {
            if (m + r < M) p[r] = W::ld(pp + (size_t)r * seg);
          }
#pragma unroll
          for (int r = 0; r < R_AHEAD; ++r) {
            if (m + r < M) W::st(op + (size_t)r * L, W::scale(p[r], inv));
          }
          pp += (size_t)R_AHEAD * seg;
          op += (size_t)R_AHEAD * L;
        }
      }
    }
    n = e;
  }
}

__global__ void __launch_bounds__(THREADS)
    ola_normalized_kernel(const float* __restrict__ ys,      // (n_chunks, M, seg)
                          const float* __restrict__ inv_sw,  // (L,)
                          float* __restrict__ out,           // (M, L)
                          int n_chunks, int M, int seg, int stride, int L, int vec) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * (THREADS / 32);
  const int V = vec ? 4 : 1;
  const long long units = L / V;
  const int a = (int)(w * units / n_warps) * V;
  const int b = (int)((w + 1) * units / n_warps) * V;
  if (vec) {
    ola_share<4>(ys, inv_sw, out, n_chunks, M, seg, stride, L, a, b, lane);
  } else {
    ola_share<1>(ys, inv_sw, out, n_chunks, M, seg, stride, L, a, b, lane);
  }
}

}  // namespace

// Blocks of one launch on the current device: one an SM.  An SM holds two
// (128 registers a thread), but the second was no faster at 8 rows and
// slower at 16 on the H100 (chip_forms.py ola).
extern "C" int umx_ola_grid(int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(blocks, cudaDevAttrMultiProcessorCount, dev);
}

// ys (n_chunks, M, seg) f32, inv_sw (L,), out (M, L) with
// L = n_chunks*stride + (seg - stride) and 0 <= seg - stride <= stride; one
// launch of `blocks` blocks; vec = 1 takes 16-byte vectors (seg and stride
// multiples of 4, pointers 16-byte aligned).
extern "C" int umx_ola_normalized(const float* ys, const float* inv_sw, float* out, int n_chunks,
                                  int M, int seg, int stride, int L, int blocks, int vec,
                                  void* stream) {
  const int tail = seg - stride;
  if (n_chunks < 1 || M < 1 || stride < 1 || tail < 0 || tail > stride || blocks < 1 ||
      (long long)L != (long long)n_chunks * stride + tail ||
      (vec && (seg % 4 || stride % 4 || ((size_t)ys | (size_t)inv_sw | (size_t)out) % 16)))
    return (int)cudaErrorInvalidValue;
  ola_normalized_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ys, inv_sw, out, n_chunks, M, seg, stride, L, vec);
  return (int)cudaGetLastError();
}
