// Chunks of reflected-Halpern PDHG on a dense A, for Hopper (sm_90a).
//
// Replaces the TPU kernel smart_crossover_tpu/ops/pdhg_pallas.py::
// _halpern_chunk_kernel: chunk iterations of reflected-Halpern PDHG with a
// fixed step (solvers/pdhg.py::_pdhg_core_halpern), one iteration as a
// column phase (A'y, then the clipped primal step and the Halpern update of
// x), a row phase (A x_t, the dual step, the Halpern update of y and A x).
// (The adaptive chunk kernel it once shared this source with now runs on
// thread-block clusters, csrc/pdhg_cluster.cu.)
//
// Bound: an iteration reads A twice, and A (512 x 2048 f32 = 4 MB at the
// shapes the reference ran) sits in the 50 MB L2 for the whole chunk, so
// the loop is bound by L2 bandwidth and by the two grid-wide barriers an
// iteration needs (x_t must be complete before A x_t, y before A'y).  The
// TPU kernel pinned A in VMEM; here one persistent cooperative launch per
// chunk keeps A in L2 and replaces the ~20 launches of each plain
// iteration by two cooperative_groups grid syncs:
//   column phase - a block owns tiles of 32 adjacent columns; its 8 warps
//                  split the rows, lanes on adjacent columns (coalesced),
//                  and the 8 partial sums meet in shared memory;
//   row phase    - one warp per row, lanes along the row.
// A is read in place (row-major, one copy: the TPU needed a second,
// relaid copy only for Mosaic).  Data that other blocks wrote inside the
// launch is read with ld.global.cg (L2, not the SM's L1, which other SMs'
// stores do not update).  No sum crosses blocks, so repeated launches are
// bit-identical.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // columns per tile in the column phase
constexpr int kMaxGrid = 1024;     // the largest grid launched

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (A'y)_j for the kTile columns of one tile: warp w sums rows w, w + 8, ...
// for column j = tile * 32 + lane.  The total lands in warp 0's lanes.
__device__ __forceinline__ float tile_aty(const float* __restrict__ A,
                                          const float* y, int m, int n, int j,
                                          float (*red)[kTile + 1]) {
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float acc = 0.0f;
  if (j < n) {
#pragma unroll 4
    for (int i = w; i < m; i += kWarps) acc += A[(size_t)i * n + j] * __ldcg(y + i);
  }
  red[w][lane] = acc;
  __syncthreads();
  float tot = 0.0f;
  if (w == 0)
    for (int k = 0; k < kWarps; ++k) tot += red[k][lane];
  __syncthreads();
  return tot;
}

// (A v)_i for one row, by one warp; every lane returns the same sum.
__device__ __forceinline__ float row_av(const float* __restrict__ Ar,
                                        const float* v, int n) {
  int lane = threadIdx.x & 31;
  float acc = 0.0f;
#pragma unroll 4
  for (int j = lane; j < n; j += 32) acc += Ar[j] * __ldcg(v + j);
  return warp_sum(acc);
}

// x, y, ax are updated in place; xt is scratch for T(z)'s primal part.
__global__ void __launch_bounds__(kThreads)
halpern_chunk_kernel(const float* __restrict__ A, const float* __restrict__ b,
                     const float* __restrict__ c, const float* __restrict__ l,
                     const float* __restrict__ u, const float* __restrict__ eq,
                     float* x, float* y, float* ax,
                     const float* __restrict__ xa, const float* __restrict__ ya,
                     const float* __restrict__ axa, float* xt,
                     const float* __restrict__ scal_in, float* scal_out,
                     int m, int n, int chunk) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[kWarps][kTile + 1];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int ntiles = (n + kTile - 1) / kTile;
  const int G = gridDim.x;
  const float omega = scal_in[0], step = scal_in[2];
  const float tau = step / omega, sigma = step * omega;
  float k = scal_in[1];

  for (int it = 0; it < chunk; ++it) {
    const float lam = (k + 1.0f) / (k + 2.0f);
    // column phase: x_t = clip(x - tau (c - A'y), l, u); x <- Halpern step
    for (int t = blockIdx.x; t < ntiles; t += G) {
      int j = t * kTile + lane;
      float aty = tile_aty(A, y, m, n, j, red);
      if (w == 0 && j < n) {
        float xj = __ldcg(x + j);
        float v = fminf(fmaxf(xj - tau * (c[j] - aty), l[j]), u[j]);
        __stcg(xt + j, v);
        x[j] = lam * (2.0f * v - xj) + (1.0f - lam) * xa[j];
      }
    }
    grid.sync();
    // row phase: A x_t, y_t; y and A x <- Halpern step
    for (int i = blockIdx.x * kWarps + w; i < m; i += G * kWarps) {
      float a = row_av(A + (size_t)i * n, xt, n);
      if (lane == 0) {
        float axo = __ldcg(ax + i), yo = __ldcg(y + i);
        float yt0 = yo + sigma * (b[i] - (2.0f * a - axo));
        float yt = eq[i] > 0.0f ? yt0 : fminf(yt0, 0.0f);
        __stcg(y + i, lam * (2.0f * yt - yo) + (1.0f - lam) * ya[i]);
        ax[i] = lam * (2.0f * a - axo) + (1.0f - lam) * axa[i];
      }
    }
    k += 1.0f;
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scal_out[0] = omega;
    scal_out[1] = k;
    scal_out[2] = step;
  }
}

// Co-resident blocks of `fn` on the current device, and the grid to use:
// enough blocks for every column tile and every row group, no more.
cudaError_t grid_for(const void* fn, int m, int n, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  if (e != cudaSuccess) return e;
  int want = (n + kTile - 1) / kTile;
  int rows = (m + kWarps - 1) / kWarps;
  if (rows > want) want = rows;
  int cap = sms * per_sm < kMaxGrid ? sms * per_sm : kMaxGrid;
  if (cap < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = want < cap ? want : cap;
  return cudaSuccess;
}

}  // namespace

// One cooperative launch of `chunk` Halpern iterations; x, y, ax in place,
// xt (n) scratch.  scal_in / scal_out: [omega, k, step].
extern "C" int scx_halpern_chunk(const float* A, const float* b, const float* c,
                                 const float* l, const float* u, const float* eq,
                                 float* x, float* y, float* ax, const float* xa,
                                 const float* ya, const float* axa, float* xt,
                                 const float* scal_in, float* scal_out, int m,
                                 int n, int chunk, void* stream_ptr) {
  int grid = 0;
  cudaError_t e = grid_for((const void*)halpern_chunk_kernel, m, n, &grid);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&A, &b, &c, &l, &u, &eq, &x, &y, &ax, &xa, &ya, &axa, &xt,
                  &scal_in, &scal_out, &m, &n, &chunk};
  e = cudaLaunchCooperativeKernel((const void*)halpern_chunk_kernel,
                                  dim3(grid), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream_ptr));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
