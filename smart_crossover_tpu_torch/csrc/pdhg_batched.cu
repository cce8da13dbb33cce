// Fixed-iteration batched PDHG for LP fleets, for Hopper (sm_90a).
//
// Replaces the TPU kernel smart_crossover_tpu/solvers/pdhg_batched.py::
// _batched_pdhg_kernel.  Per instance b (equality rows only, omega = 1),
// `iters` iterations of adaptive-step PDLP PDHG from x0 = clip(0, l, u),
// y0 = 0, eta0 = 0.9 / ||A_b||:
//   x_c = clip(x - eta (c - A'y), l, u),  y_c = y + eta (b - (2 A x_c - A x)),
//   accept iff eta <= eta_bar = (|dx|^2 + |dy|^2) / (2 |dy.(A x_c - A x)|),
// then the PDLP step schedule with index k + 2 (k^-p as expf(-p logf(k)),
// as the Pallas body) and the step-weighted sums.  Returns the last
// iterates and the step-weighted averages.
//
// Bound: each iteration reads A_b twice (64 KB at 64 x 256, 512 KB at
// 256 x 512), from L2 while the fleet's A fits its 50 MB, and waits on
// three block barriers.  One block per instance loops over all iterations
// in the kernel, so a launch replaces the plain version's ~25 launches per
// iteration; x, y, A x, their trial values and the sums live in shared
// memory ((3n + 5m) floats).  The fleet fills B of the 132 SMs (32 or 64):
// a known bound of this design.  Block reductions run in a fixed order
// (warp shuffle tree, then warps in order), so repeated launches are
// bit-identical.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums three per-thread values over the block in a fixed order; the totals
// are valid in thread 0.
__device__ __forceinline__ void block_sum3(float& a, float& b, float& c,
                                           float (*red)[3]) {
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  if (lane == 0) {
    red[w][0] = a;
    red[w][1] = b;
    red[w][2] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = b = c = 0.0f;
    for (int q = 0; q < kWarps; ++q) {
      a += red[q][0];
      b += red[q][1];
      c += red[q][2];
    }
  }
}

// A x for all rows of one instance: one warp per row.
__device__ __forceinline__ void rows_av(const float* __restrict__ A,
                                        const float* v, float* out, int m,
                                        int n) {
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i = w; i < m; i += kWarps) {
    const float* Ar = A + (size_t)i * n;
    float acc = 0.0f;
#pragma unroll 4
    for (int j = lane; j < n; j += 32) acc += Ar[j] * v[j];
    acc = warp_sum(acc);
    if (lane == 0) out[i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
pdhg_batched_kernel(const float* __restrict__ A_all,
                    const float* __restrict__ b_all,
                    const float* __restrict__ c_all,
                    const float* __restrict__ l_all,
                    const float* __restrict__ u_all,
                    const float* __restrict__ opnorms, float* x_out,
                    float* y_out, float* xa_out, float* ya_out, int m, int n,
                    int iters) {
  extern __shared__ float sm[];
  __shared__ float red[kWarps][3];
  __shared__ float dec[2];        // step weight w, next eta
  __shared__ int dec_accept;
  const int inst = blockIdx.x;
  const float* A = A_all + (size_t)inst * m * n;
  const float* bv = b_all + (size_t)inst * m;
  const float* cv = c_all + (size_t)inst * n;
  const float* lv = l_all + (size_t)inst * n;
  const float* uv = u_all + (size_t)inst * n;
  const float opnorm = opnorms[inst];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;

  float* x = sm;            // n
  float* xc = x + n;        // n
  float* xs = xc + n;       // n
  float* y = xs + n;        // m
  float* yc = y + m;        // m
  float* ys = yc + m;       // m
  float* ax = ys + m;       // m
  float* axc = ax + m;      // m

  for (int j = threadIdx.x; j < n; j += kThreads) {
    x[j] = fminf(fmaxf(0.0f, lv[j]), uv[j]);
    xs[j] = 0.0f;
  }
  for (int i = threadIdx.x; i < m; i += kThreads) {
    y[i] = 0.0f;
    ys[i] = 0.0f;
  }
  __syncthreads();
  rows_av(A, x, ax, m, n);
  __syncthreads();

  float eta = 0.9f / opnorm, wsum = 0.0f;
  for (int k = 0; k < iters; ++k) {
    // columns: x_c and |dx|^2
    float p_dxx = 0.0f, p_curv = 0.0f, p_dyy = 0.0f;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      float aty = 0.0f;
#pragma unroll 4
      for (int i = 0; i < m; ++i) aty += A[(size_t)i * n + j] * y[i];
      float v = fminf(fmaxf(x[j] - eta * (cv[j] - aty), lv[j]), uv[j]);
      xc[j] = v;
      float dx = v - x[j];
      p_dxx += dx * dx;
    }
    __syncthreads();
    // rows: A x_c, y_c, dy.(A x_c - A x) and |dy|^2
    for (int i = w; i < m; i += kWarps) {
      const float* Ar = A + (size_t)i * n;
      float acc = 0.0f;
#pragma unroll 4
      for (int j = lane; j < n; j += 32) acc += Ar[j] * xc[j];
      acc = warp_sum(acc);
      if (lane == 0) {
        float yn = y[i] + eta * (bv[i] - (2.0f * acc - ax[i]));
        axc[i] = acc;
        yc[i] = yn;
        float dy = yn - y[i];
        p_curv += dy * (acc - ax[i]);
        p_dyy += dy * dy;
      }
    }
    block_sum3(p_curv, p_dxx, p_dyy, red);
    if (threadIdx.x == 0) {
      float curv = fabsf(p_curv);
      float nz = p_dxx + p_dyy;
      float eta_bar = curv > 0.0f ? nz / (2.0f * curv) : 1e10f / opnorm;
      int accept = eta <= eta_bar;
      float logk = logf((float)k + 2.0f);
      float en = fminf((1.0f - expf(-0.3f * logk)) * eta_bar,
                       (1.0f + expf(-0.6f * logk)) * eta);
      en = fminf(fmaxf(en, 1e-10f / opnorm), 1e10f / opnorm);
      dec[0] = accept ? eta : 0.0f;
      dec[1] = en;
      dec_accept = accept;
    }
    __syncthreads();
    const float wt = dec[0];
    if (dec_accept) {          // block-uniform: swap current and trial
      float* t = x; x = xc; xc = t;
      t = y; y = yc; yc = t;
      t = ax; ax = axc; axc = t;
    }
    wsum += wt;
    eta = dec[1];
    for (int j = threadIdx.x; j < n; j += kThreads) xs[j] += wt * x[j];
    for (int i = threadIdx.x; i < m; i += kThreads) ys[i] += wt * y[i];
    __syncthreads();
  }

  const float safe = wsum > 0.0f ? wsum : 1.0f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    x_out[(size_t)inst * n + j] = x[j];
    xa_out[(size_t)inst * n + j] = xs[j] / safe;
  }
  for (int i = threadIdx.x; i < m; i += kThreads) {
    y_out[(size_t)inst * m + i] = y[i];
    ya_out[(size_t)inst * m + i] = ys[i] / safe;
  }
}

}  // namespace

// One launch, one block per instance, on `stream`.  A (B, m, n), b (B, m),
// c, l, u (B, n), opnorms (B); outputs x, x_avg (B, n), y, y_avg (B, m).
// Returns the launch's CUDA error code; a shape whose vectors do not fit
// one block's shared memory is refused (cudaErrorInvalidValue).
extern "C" int scx_pdhg_batched(const float* A, const float* b, const float* c,
                                const float* l, const float* u,
                                const float* opnorms, float* x, float* y,
                                float* xa, float* ya, int B, int m, int n,
                                int iters, void* stream_ptr) {
  size_t smem = (size_t)(3 * n + 5 * m) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  // the kernel's static shared memory (reduction scratch) comes on top
  if (smem + 1024 > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(pdhg_batched_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  pdhg_batched_kernel<<<B, kThreads, smem,
                        static_cast<cudaStream_t>(stream_ptr)>>>(
      A, b, c, l, u, opnorms, x, y, xa, ya, m, n, iters);
  return (int)cudaGetLastError();
}
