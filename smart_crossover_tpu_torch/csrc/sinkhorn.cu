// Fused batched log-domain Sinkhorn for Hopper (sm_90a).
//
// Replaces the TPU kernel smart_crossover_tpu/ops/sinkhorn_pallas.py::
// _sinkhorn_kernel.  Per instance b, num_iters rounds of
//   f_i = reg * (log s_i - LSE_j((g_j - M_ij) / reg))
//   g_j = reg * (log d_j - LSE_i((f_i - M_ij) / reg))
// with every LSE taken max-first (two passes: max, then sum of exp), then
// plan_ij = exp((f_i + g_j - M_ij) / reg).
//
// Bound: each half-iteration reads all of M once.  A 256^2 instance (256
// KB) exceeds one block's shared memory, so M is streamed from L2 (64 x
// 256^2 f32 = 16 MB fits the 50 MB L2) by one grid per half-iteration:
//   rows    - one warp per (b, i) row, lanes on adjacent columns;
//   columns - a block owns 32 adjacent columns x 8 row groups; each thread
//             reduces its row group, the 8 partials meet in shared memory.
// The products that form t are __fmul_rn so nvcc cannot contract
// t - tmax into an FMA: the kernel rounds t exactly as the plain version.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRowWarps = 8;     // rows per block in the row pass
constexpr int kColX = 32;        // columns per block in the column pass
constexpr int kColY = 8;         // row groups per block in the column pass

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void log_kernel(const float* __restrict__ x, float* __restrict__ y,
                           float* __restrict__ zero, int n) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) {
    y[k] = logf(x[k]);
    if (zero) zero[k] = 0.0f;
  }
}

// f[b, i] from g[b, :]: one warp per row.
__global__ void __launch_bounds__(kRowWarps * 32)
row_kernel(const float* __restrict__ M, const float* __restrict__ log_s,
           const float* __restrict__ g, float* __restrict__ f,
           int B, int S, int D, float reg, float inv_reg) {
  int lane = threadIdx.x & 31;
  long r = (long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= (long)B * S) return;
  int b = (int)(r / S);
  const float* Mr = M + r * D;
  const float* gb = g + (long)b * D;
  float m = -CUDART_INF_F;
  for (int j = lane; j < D; j += 32) m = fmaxf(m, __fmul_rn(gb[j] - Mr[j], inv_reg));
  m = warp_max(m);
  float acc = 0.0f;
  for (int j = lane; j < D; j += 32) acc += expf(__fmul_rn(gb[j] - Mr[j], inv_reg) - m);
  acc = warp_sum(acc);
  if (lane == 0) f[r] = reg * (log_s[r] - (m + logf(acc)));
}

// g[b, j] from f[b, :]: block (kColX, kColY) over columns j, grid.y = b.
__global__ void __launch_bounds__(kColX * kColY)
col_kernel(const float* __restrict__ M, const float* __restrict__ log_d,
           const float* __restrict__ f, float* __restrict__ g,
           int S, int D, float reg, float inv_reg) {
  __shared__ float red[kColY][kColX + 1];
  int tx = threadIdx.x, ty = threadIdx.y;
  int j = blockIdx.x * kColX + tx;
  int b = blockIdx.y;
  const float* Mb = M + (long)b * S * D;
  const float* fb = f + (long)b * S;
  bool ok = j < D;

  float m = -CUDART_INF_F;
  if (ok)
    for (int i = ty; i < S; i += kColY)
      m = fmaxf(m, __fmul_rn(fb[i] - Mb[(long)i * D + j], inv_reg));
  red[ty][tx] = m;
  __syncthreads();
  if (ty == 0) {
    for (int k = 1; k < kColY; ++k) m = fmaxf(m, red[k][tx]);
    red[0][tx] = m;
  }
  __syncthreads();
  m = red[0][tx];
  __syncthreads();

  float acc = 0.0f;
  if (ok)
    for (int i = ty; i < S; i += kColY)
      acc += expf(__fmul_rn(fb[i] - Mb[(long)i * D + j], inv_reg) - m);
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && ok) {
    for (int k = 1; k < kColY; ++k) acc += red[k][tx];
    g[(long)b * D + j] = reg * (log_d[(long)b * D + j] - (m + logf(acc)));
  }
}

__global__ void plan_kernel(const float* __restrict__ M, const float* __restrict__ f,
                            const float* __restrict__ g, float* __restrict__ plan,
                            int B, int S, int D, float inv_reg) {
  long n = (long)B * S * D;
  for (long k = (long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (long)gridDim.x * blockDim.x) {
    long row = k / D;                 // b * S + i
    int j = (int)(k - row * D);
    int b = (int)(row / S);
    plan[k] = expf(__fmul_rn((f[row] + g[(long)b * D + j]) - M[k], inv_reg));
  }
}

}  // namespace

// Runs the whole solve on `stream`: 2 * num_iters + 3 launches.  log_s and
// log_d are caller-allocated scratch.  Returns cudaGetLastError().
extern "C" int scx_sinkhorn_fused(const float* s, const float* d, const float* M,
                                  float* plan, float* f, float* g,
                                  float* log_s, float* log_d,
                                  int B, int S, int D, float reg, int num_iters,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float inv_reg = 1.0f / reg;
  int nS = B * S, nD = B * D;
  log_kernel<<<(nS + 255) / 256, 256, 0, stream>>>(s, log_s, f, nS);
  log_kernel<<<(nD + 255) / 256, 256, 0, stream>>>(d, log_d, g, nD);
  dim3 row_grid((nS + kRowWarps - 1) / kRowWarps);
  dim3 col_grid((D + kColX - 1) / kColX, B);
  dim3 col_block(kColX, kColY);
  for (int it = 0; it < num_iters; ++it) {
    row_kernel<<<row_grid, kRowWarps * 32, 0, stream>>>(M, log_s, g, f, B, S, D, reg, inv_reg);
    col_kernel<<<col_grid, col_block, 0, stream>>>(M, log_d, f, g, S, D, reg, inv_reg);
  }
  long n = (long)B * S * D;
  int blocks = (int)((n + 255) / 256 < 132 * 32 ? (n + 255) / 256 : 132 * 32);
  plan_kernel<<<blocks, 256, 0, stream>>>(M, f, g, plan, B, S, D, inv_reg);
  return (int)cudaGetLastError();
}
