// Fused batched log-domain Sinkhorn for Hopper (sm_90a): one thread-block
// cluster of C blocks runs one instance's whole solve, M held in shared
// memory for every iteration, in one launch.
//
// Replaces the TPU kernel smart_crossover_tpu/ops/sinkhorn_pallas.py::
// _sinkhorn_kernel, which pins M in VMEM for all iterations.  Per instance
// b, num_iters rounds of
//   f_i = reg * (log s_i - LSE_j((g_j - M_ij) / reg))
//   g_j = reg * (log d_j - LSE_i((f_i - M_ij) / reg))
// with every LSE taken max-first (two passes: max, then sum of exp), then
// plan_ij = exp((f_i + g_j - M_ij) / reg).
//
// Bound on this card: the exps and the instructions around them.  Each
// cell takes one accurate expf per half-iteration (B*S*D*(2*iters + 1) in
// all), one MUFU ex2 at 16 per clock per SM plus about seven float32
// instructions each; M itself is read from shared memory, not from L2 or
// HBM, after one load.  So the design spends as few instructions per cell
// as it can: 16-byte shared loads, and t = (g - M) / reg kept in registers
// between the row half's max and exp passes.
//
// Design (ops/sinkhorn_fused.py::sinkhorn_cluster_plan picks C and the
// layout):
//   * rank q of the cluster owns rows [q*S/C, (q+1)*S/C) of M_b; it copies
//     the first n_res of them into its shared memory once (cp.async), each
//     row padded to Dp = D rounded up to 4 with +inf (a padded cell adds
//     exp(-inf) = 0), and reads the rest, if any, from global memory (L2)
//     behind the same row loop; log s and f of its rows live in its shared
//     memory, log d and g over all Dp columns are replicated in every rank;
//   * row half (f): a rank holds its rows whole, so f needs no exchange:
//     one warp per row (a half-warp per row, two rows at once, up to 256
//     columns, so that two rows' shuffle chains overlap), each lane on 4
//     adjacent columns, max then sum of exp;
//   * column half (g): thread (q4, r) takes the partial maxima of columns
//     4*q4..4*q4+3 over row group r of the rank's rows; the groups meet in
//     shared memory in a fixed order, the ranks combine their partials
//     through distributed shared memory (DSMEM) into the column max, each
//     rank takes partial sums of exp(t - colmax) the same way, and the sums
//     combine in rank order 0..C-1, so g is bit-identical in every rank and
//     across launches;
//   * every rank reads all C partials of every column through DSMEM, two
//     cluster barriers per iteration; the partial maxima and the partial
//     sums sit in separate buffers, each guarded by the other's barrier, so
//     no barrier guards their reuse;
//   * the plan is written from shared memory after the last iteration.
// The products that form t are __fmul_rn so nvcc cannot contract t - tmax
// into an FMA: the kernel rounds t exactly as the plain version; the exps
// are the accurate expf.  Only the order of the sums differs.
// Build with -DSCX_K1_STAMPS for clock64 totals per phase (rank 0 of
// instance 0, thread 0), read back by scx_sinkhorn_stamps.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// ops/sinkhorn_fused.py::_RED_FLOATS: the row-group partials of one pass,
// one float4 per thread
constexpr int kRed = 4 * kThreads;

#ifdef SCX_K1_STAMPS
// load, row half, column max, barrier A, combine max, column sum,
// barrier B, combine sum, plan
constexpr int kPhases = 9;
__device__ long long scx_k1_stamps[kPhases];
#define SCX_STAMP(k)                 \
  do {                               \
    const long long t_ = clock64();  \
    st[k] += t_ - t_last;            \
    t_last = t_;                     \
  } while (0)
#else
#define SCX_STAMP(k) \
  do {               \
  } while (0)
#endif

struct Args {
  const float* s;   // (B, S)
  const float* d;   // (B, D)
  const float* M;   // (B, S, D)
  float* plan;      // (B, S, D)
  float* f;         // (B, S)
  float* g;         // (B, D)
  int S, D, C, n_res, iters;
  float reg, inv_reg;
};

// Rank q's first row of n rows split over C ranks (config.py::split_rows).
__device__ __forceinline__ int lo_row(int q, int n, int C) {
  return (int)((long long)q * n / C);
}

// Max and sum over each group of L adjacent lanes (L = 32: the warp).
template <int L>
__device__ __forceinline__ float group_max(float v) {
  for (int o = L / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int L>
__device__ __forceinline__ float group_sum(float v) {
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float max4(float4 v) {
  return fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
}

__device__ __forceinline__ float4 fmax4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}

// Columns j..j+3 of a row: a 16-byte load where the row is padded and
// aligned (vec), else guarded loads with +inf past column D.
__device__ __forceinline__ float4 load4(const float* row, int j, int D, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(row + j);
  return make_float4(j < D ? row[j] : CUDART_INF_F, j + 1 < D ? row[j + 1] : CUDART_INF_F,
                     j + 2 < D ? row[j + 2] : CUDART_INF_F,
                     j + 3 < D ? row[j + 3] : CUDART_INF_F);
}

// (a - m) * inv_reg, rounded as the plain version rounds it.
__device__ __forceinline__ float4 scaled(float4 a, float4 m, float inv_reg) {
  return make_float4(__fmul_rn(a.x - m.x, inv_reg), __fmul_rn(a.y - m.y, inv_reg),
                     __fmul_rn(a.z - m.z, inv_reg), __fmul_rn(a.w - m.w, inv_reg));
}
__device__ __forceinline__ float4 scaled(float a, float4 m, float inv_reg) {
  return scaled(make_float4(a, a, a, a), m, inv_reg);
}

// LSE_j((g_j - row_j) * inv_reg) of one row, max-first, by a group of L
// lanes (the warp, or a half-warp taking one of two rows at once); every
// lane of the group returns it.  Lane `sub` of the group takes columns
// 4*(sub + L*k)..+3.  KV > 0 keeps those t in registers between the passes
// (for D4 <= L*KV); KV == 0 reads the row twice.  A group whose row is
// past the rank's last (valid false) loads nothing and only joins the
// shuffles.
template <int KV, int L>
__device__ __forceinline__ float row_lse(const float* row, bool vec, const float* g, int D,
                                         int D4, float inv_reg, int sub, bool valid) {
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const int n4 = valid ? D4 : 0;
  float m = -CUDART_INF_F;
  float acc = 0.0f;
  if (KV > 0) {
    float4 t[KV > 0 ? KV : 1];
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int q = sub + L * k;
      if (q < n4) {
        t[k] = scaled(g4[q], load4(row, 4 * q, D, vec), inv_reg);
        m = fmaxf(m, max4(t[k]));
      }
    }
    m = group_max<L>(m);
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      if (sub + L * k < n4) {
        acc += expf(t[k].x - m);
        acc += expf(t[k].y - m);
        acc += expf(t[k].z - m);
        acc += expf(t[k].w - m);
      }
    }
  } else {
    for (int q = sub; q < n4; q += L)
      m = fmaxf(m, max4(scaled(g4[q], load4(row, 4 * q, D, vec), inv_reg)));
    m = group_max<L>(m);
    for (int q = sub; q < n4; q += L) {
      const float4 t = scaled(g4[q], load4(row, 4 * q, D, vec), inv_reg);
      acc += expf(t.x - m);
      acc += expf(t.y - m);
      acc += expf(t.z - m);
      acc += expf(t.w - m);
    }
  }
  acc = group_sum<L>(acc);
  return m + logf(acc);
}

// This rank's rows li = r, r + G, ... < nr, columns 4*q4..+3: the first
// nres rows in shared memory (Ms, stride Dp), the rest in global memory
// (Mg, stride D).  Partial max of t = (f_i - M_ij) * inv_reg.
__device__ __forceinline__ float4 col_max(const float* Ms, const float* Mg, bool gvec,
                                          const float* fl, int nres, int nr, int r, int G,
                                          int D, int Dp, int q4, float inv_reg) {
  float4 m = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F);
  int li = r;
#pragma unroll 4
  for (; li < nres; li += G)
    m = fmax4(m, scaled(fl[li], load4(Ms + li * Dp, 4 * q4, D, true), inv_reg));
#pragma unroll 4
  for (; li < nr; li += G)
    m = fmax4(m, scaled(fl[li], load4(Mg + (size_t)li * D, 4 * q4, D, gvec), inv_reg));
  return m;
}

// The same rows' partial sums of exp(t - cmax), in row order.
__device__ __forceinline__ float4 col_sum(const float* Ms, const float* Mg, bool gvec,
                                          const float* fl, int nres, int nr, int r, int G,
                                          int D, int Dp, int q4, float inv_reg, float4 c) {
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int li = r;
#pragma unroll 4
  for (; li < nres; li += G) {
    const float4 t = scaled(fl[li], load4(Ms + li * Dp, 4 * q4, D, true), inv_reg);
    a.x += expf(t.x - c.x);
    a.y += expf(t.y - c.y);
    a.z += expf(t.z - c.z);
    a.w += expf(t.w - c.w);
  }
#pragma unroll 4
  for (; li < nr; li += G) {
    const float4 t = scaled(fl[li], load4(Mg + (size_t)li * D, 4 * q4, D, gvec), inv_reg);
    a.x += expf(t.x - c.x);
    a.y += expf(t.y - c.y);
    a.z += expf(t.z - c.z);
    a.w += expf(t.w - c.w);
  }
  return a;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// g of columns 4*q4..+3 from their column max c and sum a; 0 past D.
__device__ __forceinline__ float4 g_of(const float4 ld, float4 c, float4 a, float reg, int j,
                                       int D) {
  return make_float4(j < D ? reg * (ld.x - (c.x + logf(a.x))) : 0.0f,
                     j + 1 < D ? reg * (ld.y - (c.y + logf(a.y))) : 0.0f,
                     j + 2 < D ? reg * (ld.z - (c.z + logf(a.z))) : 0.0f,
                     j + 3 < D ? reg * (ld.w - (c.w + logf(a.w))) : 0.0f);
}

template <int KV, int L>
__global__ void __launch_bounds__(kThreads, 1) sinkhorn_cluster_kernel(const Args a) {
  constexpr int R = 32 / L;                  // rows per warp at once
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C;
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / C;
  const int S = a.S, D = a.D;
  const int Dp = (D + 3) & ~3, D4 = Dp / 4;
  const float reg = a.reg, inv_reg = a.inv_reg;
  const int r0 = lo_row(rank, S, C), nr = lo_row(rank + 1, S, C) - r0;
  const int nres = nr < a.n_res ? nr : a.n_res;
  const int rmax = (S + C - 1) / C;
  // column passes: thread (q4, r) = (tid % D4, tid / D4), G row groups
  const int G = D4 >= kThreads ? 1 : kThreads / D4;
  const int r_own = D4 >= kThreads ? 0 : tid / D4;
  const bool col_on = r_own < G;

  // dynamic shared memory (ops/sinkhorn_fused.py::sinkhorn_smem_bytes)
  float* Ms = smem;                          // n_res rows of Dp
  float* g = Ms + (size_t)a.n_res * Dp;      // Dp, replicated
  float* ld = g + Dp;                        // log d
  float* cm = ld + Dp;                       // column max
  float* pmax = cm + Dp;                     // this rank's partial max
  float* psum = pmax + Dp;                   // this rank's partial sum
  float4* red = reinterpret_cast<float4*>(psum + Dp);   // row-group partials
  float* ls = psum + Dp + kRed;              // log s of this rank's rows
  float* fl = ls + rmax;                     // f of this rank's rows
  float4* cm4 = reinterpret_cast<float4*>(cm);
  float4* pmax4 = reinterpret_cast<float4*>(pmax);
  float4* psum4 = reinterpret_cast<float4*>(psum);
  float4* g4 = reinterpret_cast<float4*>(g);
  const float4* ld4 = reinterpret_cast<const float4*>(ld);
  const float* Mg = a.M + ((size_t)b * S + r0) * D;   // this rank's rows
  // global rows load 16 bytes at a time where every row starts aligned
  const bool gvec = (D & 3) == 0 && (reinterpret_cast<uintptr_t>(a.M) & 15u) == 0;

#ifdef SCX_K1_STAMPS
  long long st[kPhases] = {};
  long long t_last = clock64();
#endif

  // the resident rows, once, padded to Dp with +inf
  if (gvec) {
    const size_t n4 = (size_t)nres * D4;
    for (size_t k = tid; k < n4; k += kThreads)
      __pipeline_memcpy_async(Ms + 4 * k, Mg + 4 * k, 16);
  } else {
    for (int li = warp; li < nres; li += kWarps)
      for (int j = lane; j < Dp; j += 32) {
        if (j < D) __pipeline_memcpy_async(Ms + (size_t)li * Dp + j, Mg + (size_t)li * D + j, 4);
        else Ms[(size_t)li * Dp + j] = CUDART_INF_F;
      }
  }
  __pipeline_commit();
  for (int j = tid; j < Dp; j += kThreads) {
    g[j] = 0.0f;
    ld[j] = j < D ? logf(a.d[(size_t)b * D + j]) : 0.0f;
  }
  for (int li = tid; li < nr; li += kThreads) {
    ls[li] = logf(a.s[(size_t)b * S + r0 + li]);
    fl[li] = 0.0f;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  SCX_STAMP(0);

  for (int it = 0; it < a.iters; ++it) {
    // ---- row half: f of this rank's rows from g, R rows per warp at once
    for (int base = warp * R; base < nr; base += kWarps * R) {
      const int li = base + lane / L, sub = lane % L;
      const bool valid = li < nr;
      float lse;
      if (base + R <= nres) {
        lse = row_lse<KV, L>(Ms + li * Dp, true, g, D, D4, inv_reg, sub, valid);
      } else if (base >= nres) {
        lse = row_lse<KV, L>(Mg + (size_t)li * D, gvec, g, D, D4, inv_reg, sub, valid);
      } else {                                 // a pair across the last resident row
        const bool res = li < nres;
        lse = row_lse<KV, L>(res ? Ms + li * Dp : Mg + (size_t)li * D, res || gvec, g, D, D4,
                             inv_reg, sub, valid);
      }
      if (valid && sub == 0) fl[li] = reg * (ls[li] - lse);
    }
    __syncthreads();
    SCX_STAMP(1);

    // ---- column half, pass 1: partial column maxima over this rank's rows
    if (col_on)
      for (int q4 = tid - r_own * D4; q4 < D4; q4 += kThreads) {
        const float4 m = col_max(Ms, Mg, gvec, fl, nres, nr, r_own, G, D, Dp, q4, inv_reg);
        if (G == 1) pmax4[q4] = m;
        else red[r_own * D4 + q4] = m;
      }
    if (G > 1) {
      __syncthreads();
      for (int q4 = tid; q4 < D4; q4 += kThreads) {
        float4 m = red[q4];
        for (int r = 1; r < G; ++r) m = fmax4(m, red[r * D4 + q4]);
        pmax4[q4] = m;
      }
    }
    SCX_STAMP(2);
    cl.sync();                                     // A: partial maxima posted
    SCX_STAMP(3);
    for (int q4 = tid; q4 < D4; q4 += kThreads) {
      float4 m = cl.map_shared_rank(pmax4, 0u)[q4];
      for (int q = 1; q < C; ++q) m = fmax4(m, cl.map_shared_rank(pmax4, (unsigned)q)[q4]);
      cm4[q4] = m;
    }
    __syncthreads();
    SCX_STAMP(4);

    // ---- column half, pass 2: partial sums of exp(t - colmax)
    if (col_on)
      for (int q4 = tid - r_own * D4; q4 < D4; q4 += kThreads) {
        const float4 s4 =
            col_sum(Ms, Mg, gvec, fl, nres, nr, r_own, G, D, Dp, q4, inv_reg, cm4[q4]);
        if (G == 1) psum4[q4] = s4;
        else red[r_own * D4 + q4] = s4;
      }
    if (G > 1) {
      __syncthreads();
      for (int q4 = tid; q4 < D4; q4 += kThreads) {
        float4 s4 = red[q4];
        for (int r = 1; r < G; ++r) s4 = add4(s4, red[r * D4 + q4]);
        psum4[q4] = s4;
      }
    }
    SCX_STAMP(5);
    cl.sync();                                     // B: partial sums posted
    SCX_STAMP(6);
    for (int q4 = tid; q4 < D4; q4 += kThreads) {
      float4 s4 = cl.map_shared_rank(psum4, 0u)[q4];
      for (int q = 1; q < C; ++q) s4 = add4(s4, cl.map_shared_rank(psum4, (unsigned)q)[q4]);
      g4[q4] = g_of(ld4[q4], cm4[q4], s4, reg, 4 * q4, D);
    }
    __syncthreads();
    SCX_STAMP(7);
  }

  // ---- the plan, f and g
  for (int li = warp; li < nr; li += kWarps) {
    const float fi = fl[li];
    const float* row = li < nres ? Ms + (size_t)li * Dp : Mg + (size_t)li * D;
    float* out = a.plan + ((size_t)b * S + r0 + li) * D;
    for (int j = lane; j < D; j += 32) out[j] = expf(__fmul_rn((fi + g[j]) - row[j], inv_reg));
  }
  for (int li = tid; li < nr; li += kThreads) a.f[(size_t)b * S + r0 + li] = fl[li];
  if (rank == 0)
    for (int j = tid; j < D; j += kThreads) a.g[(size_t)b * D + j] = g[j];
  SCX_STAMP(8);
#ifdef SCX_K1_STAMPS
  if (b == 0 && rank == 0 && tid == 0)
    for (int k = 0; k < kPhases; ++k) scx_k1_stamps[k] = st[k];
#endif
  cl.sync();         // no rank leaves while another may still read its partials
}

// Bytes of dynamic shared memory of one block
// (ops/sinkhorn_fused.py::sinkhorn_smem_bytes).
size_t smem_bytes(int S, int D, int C, int n_res) {
  const size_t Dp = ((size_t)D + 3) & ~(size_t)3;
  const size_t floats = (size_t)n_res * Dp + 5 * Dp + kRed + 2 * (size_t)((S + C - 1) / C);
  return (4 * floats + 15) / 16 * 16;
}

using Kernel = void (*)(Args);

// The row half keeps a lane's 4*KV values of t in registers where the row
// fits: up to 256 columns two rows per warp (16 lanes each), up to 1024 one;
// past that it reads each row twice.
Kernel kernel_for(int D) {
  const int D4 = (D + 3) / 4;
  if (D4 <= 64) return sinkhorn_cluster_kernel<4, 16>;
  if (D4 <= 128) return sinkhorn_cluster_kernel<4, 32>;
  if (D4 <= 256) return sinkhorn_cluster_kernel<8, 32>;
  return sinkhorn_cluster_kernel<0, 32>;
}

// Lets the kernel take `smem` bytes and, above 8, a non-portable cluster.
cudaError_t prepare(Kernel k, size_t smem, int C) {
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// A cluster launch of B*C blocks; attr must outlive the config.
cudaLaunchConfig_t launch_config(int B, int C, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" int scx_sinkhorn_smem_bytes(int S, int D, int C, int n_res) {
  return (int)smem_bytes(S, D, C, n_res);
}

// How many clusters of this launch the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int scx_sinkhorn_max_clusters(int B, int S, int D, int C, int n_res) {
  const Kernel k = kernel_for(D);
  const size_t smem = smem_bytes(S, D, C, n_res);
  cudaError_t e = prepare(k, smem, C);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(B, C, smem, nullptr, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)k, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return n;
}

// Runs the whole solve on `stream`: one cluster launch of C blocks per
// instance; rank q keeps min(its rows, n_res) rows of M in shared memory.
// Returns the error of the shared-memory opt-in or launch, else
// cudaGetLastError().
extern "C" int scx_sinkhorn_fused(const float* s, const float* d, const float* M, float* plan,
                                  float* f, float* g, int B, int S, int D, float reg,
                                  int num_iters, int C, int n_res, void* stream_ptr) {
  const Args a = {s, d, M, plan, f, g, S, D, C, n_res, num_iters, reg, 1.0f / reg};
  const Kernel k = kernel_for(D);
  const size_t smem = smem_bytes(S, D, C, n_res);
  cudaError_t e = prepare(k, smem, C);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(B, C, smem, static_cast<cudaStream_t>(stream_ptr), &attr);
  e = cudaLaunchKernelEx(&cfg, k, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifdef SCX_K1_STAMPS
// The last launch's clock64 totals per phase (rank 0 of instance 0).
extern "C" int scx_sinkhorn_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, scx_k1_stamps, sizeof(long long) * kPhases);
}
#endif
