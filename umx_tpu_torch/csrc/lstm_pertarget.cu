// Per-target BLSTM recurrence for one LSTM layer (K9): one launch runs all
// T timesteps of every chain, each chain's W_hh and state staying on chip.
//
// Replaces: umx_tpu/ops/lstm_pallas.py:_make_kernel (reached via
// lstm_layer_pallas), the TPU kernel whose grid is (targets, time blocks)
// with one target's W_hh and h/c resident in VMEM while the grid walks
// that target's time blocks.
//
// Contract (the same function as the merged kernel at one batch row, with
// the chains laid out (T#, D) as the TPU kernel has them):
//   xp  (T#, T, D, 4G) f32   input projections + both biases, gates i|f|g|o
//   whh (T#, D, G, 4G) bf16  hidden-hidden weights, contracted over G
//   h0, c0 (T#, D, G)  f32
// Per step:  gates = xp_t + bf16(h_{t-1}) . whh[chain]   (f32 accumulation)
//            c = sigmoid(f) c + sigmoid(i) tanh(g);  h = sigmoid(o) tanh(c)
// Outputs hs (T#, T, D, G), hT, cT (T#, D, G), all f32.  Any T: the TPU
// kernel's time blocks (and their padding) are its DMA granularity only.
//
// What bounds it on the H100: the T steps are dependent, so a layer costs
// T times one step's latency; the bytes (x_proj and hs once, W_hh once)
// would take tens of microseconds.  A step is a (1 x G) by (G x 4G)
// product per chain, far too small for the tensor cores to matter; what a
// step waits for is W_hh.  The merged kernel (lstm_merged.cu) re-reads all
// of W_hh from L2 every step and pays one grid launch per step.
//
// Design: what the TPU kernel adds is residency, and this card's form of
// it is a thread-block cluster per chain.  grid = (CL, T# x D) with cluster
// dimension CL: block `rank` of a chain's cluster owns U = G / CL hidden
// units (rounded up to 8) and keeps, for the whole layer,
//   * its 4U gate columns of W_hh in shared memory (UMX-L: CL = 16,
//     U = 32, 128 KiB of bf16 per block; 8 clusters x 16 = 128 blocks),
//     laid out [column vector][k][8 columns] so that the lanes of a warp,
//     which split k, read neighbouring 16-byte words (no bank conflicts);
//   * c of its units in the registers of their owner threads;
//   * the whole bf16-rounded h_{t-1} (G floats) in shared memory, twice.
// Per step each warp takes column vectors of 8 gate columns, its lanes
// split the G-long dot product and a shuffle tree sums them; one owner
// thread per unit then applies the gates, writes h_t to hs and stores the
// bf16-rounded h_t into the h buffer for step t+1 of EVERY block of the
// cluster through distributed shared memory; one cluster.sync() ends the
// step.  Two h buffers make one barrier per step enough: step t+1's remote
// stores go to the buffer that was read in step t, which every block has
// left before that barrier.  Chains never talk to each other, so there is
// no grid-wide barrier and no cooperative launch.  x_proj of step t+1 is
// loaded before step t's product, off the critical path.
//
// Cluster size.  CL is 16, 8, 4, 2 or 1 blocks (above 8 is the
// non-portable size), none larger than leaves a block 32 units.  The device
// is asked (cudaOccupancyMaxActiveClusters) how many clusters of each size
// it holds at once, and the size that runs the chains in the fewest waves
// is taken, the larger on a tie.  If fewer clusters fit than there are
// chains, the rest run in a second wave: slower, still right (an H100 SXM
// placed 7 clusters of 16 at once, so UMX-L's 8 chains took two waves: a
// chain needs 10 blocks' shared memory and that card's GPCs hold one such
// cluster each).  A G whose W_hh slice fits no block's shared memory at any
// size is refused (cudaErrorInvalidConfiguration); on the H100's 227 KB
// that is G above 640.  Requires G % 8 == 0 and a 16-byte aligned W_hh (the
// wrapper checks before any launch).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int VEC = 8;  // bf16 columns per 16-byte load

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__global__ void __launch_bounds__(THREADS, 1)
lstm_pertarget_kernel(const float* __restrict__ xp,           // (T#, T, D, 4G)
                      const __nv_bfloat16* __restrict__ whh,  // (T#, D, G, 4G)
                      const float* __restrict__ h0,           // (T#, D, G)
                      const float* __restrict__ c0,           // (T#, D, G)
                      float* __restrict__ hs,                 // (T#, T, D, G)
                      float* __restrict__ hT,                 // (T#, D, G)
                      float* __restrict__ cT,                 // (T#, D, G)
                      int T, int D, int G, int U) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  const int r = blockIdx.y;  // chain = target * D + direction
  const int j = r / D;
  const int d = r % D;
  const int u0 = rank * U;                    // first hidden unit of this block
  const int nu = max(0, min(U, G - u0));      // units owned (a multiple of 8)
  const int nvec = nu / 2;                    // 4 * nu gate columns / 8 per vector
  const int vpg = nu / VEC;                   // column vectors per gate
  const int G4 = 4 * G;

  float* h_s = reinterpret_cast<float*>(smem_raw);     // (2, G): bf16-rounded h, two steps
  float* gsum = h_s + 2 * G;                           // (4, U): this step's dot products
  uint4* w_s = reinterpret_cast<uint4*>(gsum + 4 * U);  // (nvec, G) x 8 bf16

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const __nv_bfloat16* wg = whh + (size_t)r * G * G4;

  // k-major over the global rows, so neighbouring threads read
  // neighbouring 16-byte words of one W_hh row
  for (int i = tid; i < nvec * G; i += THREADS) {
    const int k = i / nvec;
    const int v = i % nvec;
    const int q = v / vpg;
    const int uu = (v % vpg) * VEC;
    w_s[(size_t)v * G + k] =
        *reinterpret_cast<const uint4*>(wg + (size_t)k * G4 + (size_t)q * G + u0 + uu);
  }
  for (int i = tid; i < G; i += THREADS) h_s[i] = bf16_round(h0[(size_t)r * G + i]);

  // thread tid < nu owns hidden unit u for the whole layer
  const bool owner = tid < nu;
  const int u = u0 + tid;
  float c = 0.0f, h_last = 0.0f;
  const size_t x_step = (size_t)D * G4;
  const size_t h_step = (size_t)D * G;
  const float* xp_r = xp + ((size_t)j * T * D + d) * G4;
  float* hs_r = hs + ((size_t)j * T * D + d) * G;
  float xg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (owner) {
    c = c0[(size_t)r * G + u];
    h_last = h0[(size_t)r * G + u];
#pragma unroll
    for (int q = 0; q < 4; ++q) xg[q] = xp_r[(size_t)q * G + u];
  }
  // every block of the cluster is running and has filled its own h buffer
  // before any block stores into it
  cluster.sync();

  for (int t = 0; t < T; ++t) {
    const float* hc = h_s + (t & 1) * G;
    float xn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (owner && t + 1 < T) {
#pragma unroll
      for (int q = 0; q < 4; ++q) xn[q] = xp_r[(size_t)(t + 1) * x_step + (size_t)q * G + u];
    }

    for (int v = warp; v < nvec; v += NWARPS) {
      const int q = v / vpg;
      const int uu = (v % vpg) * VEC;
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
      const uint4* wv = w_s + (size_t)v * G;
      for (int k = lane; k < G; k += 32) {
        const uint4 raw = wv[k];
        const float hv = hc[k];
        const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC / 2; ++e) {
          const float2 f = __bfloat1622float2(pair[e]);
          acc[2 * e] += hv * f.x;
          acc[2 * e + 1] += hv * f.y;
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) gsum[q * U + uu + e] = acc[e];
      }
    }
    __syncthreads();

    if (owner) {
      const float ig = sigmoidf_(xg[0] + gsum[tid]);
      const float fg = sigmoidf_(xg[1] + gsum[U + tid]);
      const float gg = tanhf(xg[2] + gsum[2 * U + tid]);
      const float og = sigmoidf_(xg[3] + gsum[3 * U + tid]);
      c = fg * c + ig * gg;
      h_last = og * tanhf(c);
      hs_r[(size_t)t * h_step + u] = h_last;
      const float hb = bf16_round(h_last);
      const int nb = ((t + 1) & 1) * G + u;
      for (int rk = 0; rk < CL; ++rk) cluster.map_shared_rank(h_s, rk)[nb] = hb;
#pragma unroll
      for (int q = 0; q < 4; ++q) xg[q] = xn[q];
    }
    // h_t has reached every block, and every block is done with h_{t-1}
    // and with gsum
    cluster.sync();
  }

  if (owner) {
    hT[(size_t)r * G + u] = h_last;
    cT[(size_t)r * G + u] = c;
  }
}

int units_per_block(int G, int CL) {
  const int per = (G + CL - 1) / CL;
  return (per + VEC - 1) / VEC * VEC;
}

size_t smem_bytes(int G, int U) {
  return (size_t)(2 * G + 4 * U) * sizeof(float) + (size_t)(U / 2) * G * 16;
}

// The launch configuration for clusters of CL blocks; attr must outlive cfg.
cudaError_t configure(int G, int R, int CL, cudaStream_t st, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  const size_t smem = smem_bytes(G, units_per_block(G, CL));
  cudaError_t e = cudaFuncSetAttribute(lstm_pertarget_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)(smem > 48 * 1024 ? smem : 48 * 1024));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(lstm_pertarget_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           CL > 8 ? 1 : 0);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CL, R, 1);
  cfg->blockDim = dim3(THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Clusters of CL blocks the device holds at once for this shape; 0 where a
// block's share of W_hh does not fit or the device cannot place the cluster.
int active_clusters(int G, int R, int CL, int smem_limit) {
  const int U = units_per_block(G, CL);
  if (U > THREADS || smem_bytes(G, U) > (size_t)smem_limit) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0;
  if (configure(G, R, CL, nullptr, &cfg, attr) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, lstm_pertarget_kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a cluster the device cannot place is not an error of the stream
    return 0;
  }
  return n;
}

}  // namespace

// K9: the whole layer in one launch.  chosen (2 ints, host memory) receives
// the cluster size that ran and the number of such clusters the device holds
// at once.  Returns the first CUDA error; cudaErrorInvalidConfiguration when
// no cluster size holds a chain's W_hh in shared memory.
extern "C" int umx_lstm_pertarget(const float* xp, const void* whh, const float* h0,
                                  const float* c0, float* hs, float* hT, float* cT, int T,
                                  int n_targets, int D, int G, int* chosen, void* stream) {
  if (G % VEC != 0 || T < 1 || n_targets < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(whh);
  const int R = n_targets * D;
  int dev = 0, smem_limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;

  int cl_max = 1;
  while (cl_max < 16 && G / (2 * cl_max) >= 32) cl_max *= 2;
  int CL = 0, active = 0, waves = 0;
  for (int cl = cl_max; cl >= 1 && waves != 1; cl /= 2) {
    const int n = active_clusters(G, R, cl, smem_limit);
    if (n < 1) continue;
    const int w_cl = (R + n - 1) / n;
    if (CL == 0 || w_cl < waves) {
      CL = cl;
      active = n;
      waves = w_cl;
    }
  }
  if (CL == 0) return (int)cudaErrorInvalidConfiguration;

  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  e = configure(G, R, CL, st, &cfg, attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, lstm_pertarget_kernel, xp, w, h0, c0, hs, hT, cT, T, D, G,
                         units_per_block(G, CL));
  if (e != cudaSuccess) return (int)e;
  chosen[0] = CL;
  chosen[1] = active;
  return (int)cudaGetLastError();
}
