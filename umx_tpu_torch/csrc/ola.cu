// K7: the normalized overlap-add that finishes every whole-track demix.
//
// Replaces umx_tpu/ops/ola_pallas.py::_transpose_kernel (through _ola_impl
// and overlap_add_normalized).  The TPU kernel is only the DMA transpose of
// chunk-major (n_chunks, M, stride) blocks to time-major rows, with the
// combine and the 1/sw multiply left to XLA, because VMEM tiling made the
// layout change the expensive step.  On the GPU the whole of _ola_impl is
// one gather pass: each thread produces one output sample
//
//   out[m, n] = (ys[k, m, n - k*stride] + tail of chunk k-1) * inv_sw[n],
//   k = n / stride,
//
// and the samples past n_chunks*stride are the last chunk's tail.  Every
// output sums the same two addends as the plain version, in the same order,
// with no FMA (__fadd_rn, __fmul_rn), so the result is bit-equal to it.
//
// What bounds it on the H100: one read of ys and one write of the output
// (about 0.47 GB at M = 8 rows of a 100 s UMX-L track), no arithmetic to
// speak of, so device-memory bandwidth.  Threads of a warp take
// neighbouring n, so both the reads (along the chunk's time axis) and the
// writes coalesce; rows m run on the grid's y axis.  No shared memory, no
// atomics.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__global__ void ola_normalized_kernel(const float* __restrict__ ys,      // (n_chunks, M, seg)
                                      const float* __restrict__ inv_sw,  // (L,)
                                      float* __restrict__ out,           // (M, L)
                                      int n_chunks, int M, int seg, int stride, int L) {
  const int n = blockIdx.x * BLOCK + threadIdx.x;
  if (n >= L) return;
  const int m = blockIdx.y;
  const int tail = seg - stride;
  const int k = n / stride;
  const int j = n - k * stride;
  float v;
  if (k < n_chunks) {
    // chunk k's head plus chunk k-1's tail (zero where there is none)
    const float head = ys[((size_t)k * M + m) * seg + j];
    const float prev = (k > 0 && j < tail) ? ys[((size_t)(k - 1) * M + m) * seg + stride + j] : 0.0f;
    v = __fadd_rn(head, prev);
  } else {
    // past n_chunks*stride: the last chunk's tail alone
    v = ys[((size_t)(n_chunks - 1) * M + m) * seg + stride + j];
  }
  out[(size_t)m * L + n] = __fmul_rn(v, inv_sw[n]);
}

}  // namespace

// ys (n_chunks, M, seg) f32, inv_sw (L,), out (M, L) with
// L = n_chunks*stride + (seg - stride) and 0 <= seg - stride <= stride.
extern "C" int umx_ola_normalized(const float* ys, const float* inv_sw, float* out, int n_chunks,
                                  int M, int seg, int stride, int L, void* stream) {
  const int tail = seg - stride;
  if (n_chunks < 1 || M < 1 || M > 65535 || stride < 1 || tail < 0 || tail > stride ||
      L != n_chunks * stride + tail)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((L + BLOCK - 1) / BLOCK, M);
  ola_normalized_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      ys, inv_sw, out, n_chunks, M, seg, stride, L);
  return (int)cudaGetLastError();
}
