// Float64 certificate of a batch of transportation bases for Hopper (sm_90a):
// one thread block recomputes one instance's vertex and duals from its basis
// mask alone and takes the verdict's numbers.
//
// Replaces no TPU kernel: the JAX package certifies on the host in NumPy and
// SciPy (smart_crossover_tpu/network_methods/certify.py), as the port's CPU
// path still does (network_methods/certify.py::certify_ot_basis).  The
// certificate is that path's, computed from the same inputs only (the mask,
// the masses, the costs) and sharing no code with the device route:
//   arcs      the mask's True cells in flat order; S + D - 1 of them, else
//             status 1 (the count goes back);
//   tree      nodes 0..S-1 supplies, S..S+D-1 demands; a walk from the last
//             demand node (the row the CPU path drops) over the arcs; a node
//             left unreached means the arcs hold a cycle: status 2;
//   duals     y_root = 0, y_{S+j} - y_i = M_ij on every tree arc, down the
//             tree from the root;
//   flows     each arc carries its lower node's subtree balance: x = m_v -
//             sum of the arcs to v's children, m_v = s_i or d_j, from the
//             leaves up (Ax = b with b = [-s, d], arc (i, j) at -1 in row i,
//             +1 in row S + j);
//   numbers   max_feas_err = max_v |(Ax)_v - b_v|, each row summed over its
//             arcs in flat order from 0, as SciPy's CSC product does;
//             min_flow; min_rcost = min over all S*D cells of M_ij - (y_{S+j}
//             - y_i); obj = sum over the tree arcs of x M, in a fixed order.
// Everything is float64; M is read in its own dtype (float32 or float64) and
// widened exactly.  A spanning tree's system has one solution, so no
// factorisation is needed and none is made.
//
// Bound on this card: one read of the S*D mask bytes and the S*D costs; the
// tree walk and the flows are a serial chain over the V = S + D nodes (a few
// shared-memory round trips a node), which binds the block at the main
// path's shapes rather than bytes.
//
// Design: the block compacts the mask tile by tile (a block scan keeps flat
// order), builds each node's arc list (a supply's arcs are a run of the flat
// list; a demand's come from one pass that each column's owner thread makes
// over the list), prefetches the tree arcs' costs, then thread 0 walks the
// tree breadth first and sums the flows in reverse walk order; the feasibility,
// the flows' minimum, the objective and the reduced-cost minimum are parallel
// passes with fixed-order reductions.  Node and arc arrays live in shared
// memory where they fit beside the kernel's static shared memory (52 V +
// 4 D bytes: V up to ~4,200 at S = D on an H100), else in a global region per block that the caller
// passes.  Nothing is atomic but the column counts, whose totals do not
// depend on order, so repeat launches give the same bits.  A NaN propagates
// through the minima and maxima, as in NumPy.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / kWarp;
constexpr int kTileBytes = 64;  // mask bytes a thread reads per tile

// status of an instance
constexpr int kTree = 0;
constexpr int kCount = 1;
constexpr int kCycle = 2;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// A block's region: doubles first (cost n1, y V, acc V), then ints (arc_row,
// arc_col, col_list n1 each; row_start S + 1; col_start D + 1; col_fill D;
// par, parc, order V each).
__host__ __device__ inline size_t region_bytes(int S, int D) {
  const size_t V = (size_t)S + D, n1 = V - 1;
  return align16((n1 + 2 * V) * sizeof(double) +
                 (3 * n1 + (size_t)S + 1 + (size_t)D + 1 + (size_t)D + 3 * V) * sizeof(int));
}

// NumPy's minimum and maximum: a NaN wins, else the smaller (larger); a tie
// keeps the first.
__device__ __forceinline__ double nmin(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}
__device__ __forceinline__ double nmax(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

// Exclusive prefix of v over the block (threads in order) and the block's
// total; every thread of the block calls it.  wsum: kMaxWarps ints.
__device__ int block_exclusive_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  int incl = v;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  __syncthreads();  // wsum may still be read by a previous call
  if (lane == kWarp - 1) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? wsum[lane] : 0;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += t;
    }
    if (lane < nwarps) wsum[lane] = w;
  }
  __syncthreads();
  total = wsum[nwarps - 1];
  return (warp > 0 ? wsum[warp - 1] : 0) + incl - v;
}

// The verdict's four numbers over the block, each thread's partials in a
// fixed order: max feasibility error, min flow, min reduced cost, objective.
struct Nums {
  double feas, min_flow, min_rc, obj;
};

__device__ __forceinline__ Nums combine(Nums a, Nums b) {
  return Nums{nmax(a.feas, b.feas), nmin(a.min_flow, b.min_flow), nmin(a.min_rc, b.min_rc),
              a.obj + b.obj};
}

__device__ __forceinline__ Nums shfl_down(Nums a, int off) {
  return Nums{__shfl_down_sync(0xffffffffu, a.feas, off),
              __shfl_down_sync(0xffffffffu, a.min_flow, off),
              __shfl_down_sync(0xffffffffu, a.min_rc, off),
              __shfl_down_sync(0xffffffffu, a.obj, off)};
}

__device__ __forceinline__ Nums warp_reduce(Nums a) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) a = combine(a, shfl_down(a, off));
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    certify_kernel(const unsigned char* __restrict__ mask, const T* __restrict__ M,
                   const double* __restrict__ s, const double* __restrict__ d,
                   unsigned char* scratch, int S, int D, int* __restrict__ status,
                   long long* __restrict__ n_arcs, double* __restrict__ nums,
                   long long* __restrict__ arcs_out, double* __restrict__ flows_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wsum[kMaxWarps];
  __shared__ Nums wnums[kMaxWarps];
  __shared__ int s_reached;

  const int V = S + D, n1 = V - 1, root = V - 1;
  const size_t SD = (size_t)S * D;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % kWarp, warp = tid / kWarp, nwarps = nt / kWarp;
  const unsigned char* mb = mask + (size_t)b * SD;
  const T* Mb = M + (size_t)b * SD;
  const double* sb = s + (size_t)b * S;
  const double* db = d + (size_t)b * D;

  unsigned char* region = scratch ? scratch + (size_t)b * region_bytes(S, D) : smem;
  double* cost = reinterpret_cast<double*>(region);
  double* y = cost + n1;
  double* acc = y + V;  // node balances, then each non-root node's arc flow
  int* arc_row = reinterpret_cast<int*>(acc + V);
  int* arc_col = arc_row + n1;
  int* col_list = arc_col + n1;
  int* row_start = col_list + n1;
  int* col_start = row_start + S + 1;
  int* col_fill = col_start + D + 1;  // column counts, then fill positions
  int* par = col_fill + D;
  int* parc = par + V;
  int* order = parc + V;

  for (int j = tid; j < D; j += nt) col_fill[j] = 0;

  // 1. the mask's True cells in flat order, each thread 64 bytes a tile
  long long total = 0;
  const bool aligned = ((uintptr_t)mb & 15) == 0;
  for (size_t base = 0; base < SD; base += (size_t)nt * kTileBytes) {
    const size_t off = base + (size_t)tid * kTileBytes;
    unsigned int w[kTileBytes / 4];
    if (aligned && off + kTileBytes <= SD) {
#pragma unroll
      for (int k = 0; k < kTileBytes / 16; ++k) {
        const uint4 v = reinterpret_cast<const uint4*>(mb + off)[k];
        w[4 * k] = v.x;
        w[4 * k + 1] = v.y;
        w[4 * k + 2] = v.z;
        w[4 * k + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kTileBytes / 4; ++k) {
        w[k] = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const size_t f = off + 4 * k + q;
          if (f < SD) w[k] |= (unsigned int)mb[f] << (8 * q);
        }
      }
    }
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kTileBytes / 4; ++k) cnt += __popc(__vcmpne4(w[k], 0u)) / 8;
    int tile_total;
    long long pos = total + block_exclusive_scan(cnt, wsum, tile_total);
    if (cnt) {
#pragma unroll
      for (int q = 0; q < kTileBytes; ++q) {
        if ((w[q / 4] >> (8 * (q % 4))) & 0xffu) {
          if (pos < n1) {
            arc_row[pos] = (int)((off + q) / D);
            arc_col[pos] = (int)((off + q) % D);
          }
          ++pos;
        }
      }
    }
    total += tile_total;
  }
  if (tid == 0) n_arcs[b] = total;
  if (total != n1) {
    if (tid == 0) status[b] = kCount;
    return;
  }
  __syncthreads();

  // 2. each node's arc list: a supply's is the run of its row in the flat
  // list, a demand's the flat list's arcs of its column in flat order
  for (int p = tid; p < n1; p += nt) atomicAdd(&col_fill[arc_col[p]], 1);
  for (int i = tid; i <= S; i += nt) {
    int lo = 0, hi = n1;  // the first arc of a row >= i
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (arc_row[mid] < i) lo = mid + 1; else hi = mid;
    }
    row_start[i] = lo;
  }
  __syncthreads();
  int carry = 0;
  for (int base = 0; base < D; base += nt) {
    const int j = base + tid;
    int chunk;
    const int ex = block_exclusive_scan(j < D ? col_fill[j] : 0, wsum, chunk);
    if (j < D) col_start[j] = carry + ex;
    carry += chunk;
  }
  if (tid == 0) col_start[D] = n1;
  __syncthreads();
  for (int j = tid; j < D; j += nt) col_fill[j] = col_start[j];
  __syncthreads();
  // thread j % nt owns column j (nt is a power of two)
  for (int p = 0; p < n1; ++p) {
    const int j = arc_col[p];
    if ((j & (nt - 1)) == tid) col_list[col_fill[j]++] = p;
  }
  for (int p = tid; p < n1; p += nt) cost[p] = (double)Mb[(size_t)arc_row[p] * D + arc_col[p]];
  for (int v = tid; v < V; v += nt) {
    par[v] = -1;
    acc[v] = v < S ? sb[v] : db[v - S];
  }
  __syncthreads();

  // 3. thread 0: the walk from the root, duals on the way down
  if (tid == 0) {
    int head = 0, tail = 0;
    order[tail++] = root;
    par[root] = root;
    parc[root] = -1;
    y[root] = 0.0;
    while (head < tail) {
      const int v = order[head++];
      const double yv = y[v];
      if (v < S) {
        for (int p = row_start[v]; p < row_start[v + 1]; ++p) {
          const int u = S + arc_col[p];
          if (par[u] < 0) {
            par[u] = v;
            parc[u] = p;
            y[u] = yv + cost[p];
            order[tail++] = u;
          }
        }
      } else {
        for (int q = col_start[v - S]; q < col_start[v - S + 1]; ++q) {
          const int p = col_list[q];
          const int u = arc_row[p];
          if (par[u] < 0) {
            par[u] = v;
            parc[u] = p;
            y[u] = yv - cost[p];
            order[tail++] = u;
          }
        }
      }
    }
    // flows from the leaves up: a node follows all of its children
    if (tail == V) {
      for (int k = V - 1; k > 0; --k) {
        const int v = order[k];
        acc[par[v]] -= acc[v];
      }
    }
    s_reached = tail;
  }
  __syncthreads();
  if (s_reached != V) {
    if (tid == 0) status[b] = kCycle;
    return;
  }

  // 4. the numbers; the tree's arcs and flows in flat order
  Nums mine{0.0, CUDART_INF, CUDART_INF, 0.0};
  for (int v = tid; v < V; v += nt) {
    double ax = 0.0, bv;
    if (v < S) {
      bv = -sb[v];
      for (int p = row_start[v]; p < row_start[v + 1]; ++p) {
        const int u = S + arc_col[p];
        ax += -(par[u] == v ? acc[u] : acc[v]);
      }
    } else {
      bv = db[v - S];
      for (int q = col_start[v - S]; q < col_start[v - S + 1]; ++q) {
        const int u = arc_row[col_list[q]];
        ax += par[u] == v ? acc[u] : acc[v];
      }
    }
    mine.feas = nmax(mine.feas, fabs(ax - bv));
    if (v != root) {
      const int p = parc[v];
      mine.min_flow = nmin(mine.min_flow, acc[v]);
      mine.obj += acc[v] * cost[p];
      const size_t o = (size_t)b * n1 + p;
      arcs_out[o] = (long long)arc_row[p] * D + arc_col[p];
      flows_out[o] = acc[v];
    }
  }
  for (int i = warp; i < S; i += nwarps) {
    const T* row = Mb + (size_t)i * D;
    const double yi = y[i];
#pragma unroll 4
    for (int j = lane; j < D; j += kWarp)
      mine.min_rc = nmin(mine.min_rc, (double)row[j] - (y[S + j] - yi));
  }
  mine = warp_reduce(mine);
  if (lane == 0) wnums[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    Nums w = wnums[lane < nwarps ? lane : 0];
    if (lane >= nwarps) w = Nums{0.0, CUDART_INF, CUDART_INF, 0.0};
    w = warp_reduce(w);
    if (lane == 0) {
      double* out = nums + (size_t)b * 4;
      out[0] = w.feas;
      out[1] = w.min_flow;
      out[2] = w.min_rc;
      out[3] = w.obj;
      status[b] = kTree;
    }
  }
}

// Bytes of global scratch a block needs for an S x D instance: 0 where its
// region fits the current device's shared memory per block beside the
// kernel's static shared memory; a negative CUDA error if a query fails or
// the bytes pass INT_MAX.
template <typename T>
int scratch_bytes(int S, int D) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, certify_kernel<T>);
  if (e != cudaSuccess) return -(int)e;
  const size_t bytes = region_bytes(S, D);
  if (fa.sharedSizeBytes + bytes <= (size_t)optin) return 0;
  return bytes <= (size_t)INT_MAX ? (int)bytes : -(int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* mask, const void* M, const double* s, const double* d, void* scratch,
           int B, int S, int D, int* status, long long* n_arcs, double* nums, long long* arcs,
           double* flows, cudaStream_t stream) {
  if (B <= 0) return (int)cudaSuccess;
  // a power of two, so that column j's owner is j & (threads - 1)
  const int threads = (size_t)S * D >= (size_t)kMaxThreads * kTileBytes ? kMaxThreads : 256;
  size_t smem = 0;
  if (!scratch) {
    if (scratch_bytes<T>(S, D) != 0) return (int)cudaErrorInvalidValue;
    smem = region_bytes(S, D);
    const cudaError_t e = cudaFuncSetAttribute(
        certify_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  certify_kernel<T><<<B, threads, smem, stream>>>(
      static_cast<const unsigned char*>(mask), static_cast<const T*>(M), s, d,
      static_cast<unsigned char*>(scratch), S, D, status, n_arcs, nums, arcs, flows);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of global scratch each block needs for an S x D instance with costs
// in float64 (f64) or float32: 0 where its region fits in shared memory on
// the current device; a negative CUDA error if a query fails.
extern "C" int scx_certify_scratch_bytes(int S, int D, int f64) {
  return f64 ? scratch_bytes<double>(S, D) : scratch_bytes<float>(S, D);
}

// Certifies B bases on `stream`, one block per instance: mask (B, S, D)
// bytes (nonzero = basic), M (B, S, D) float64 where f64 else float32, s
// (B, S) and d (B, D) float64, all contiguous.  Writes status (B; 0 a
// spanning tree, 1 not S + D - 1 arcs, 2 S + D - 1 arcs that hold a cycle),
// n_arcs (B), and for the trees nums (B, 4: max feasibility error, min
// flow, min reduced cost, objective), arcs (B, S + D - 1: flat cell
// indices in flat order) and flows (B, S + D - 1, float64).  `scratch` is
// null where a block's region fits in shared memory, else B regions of
// scx_certify_scratch_bytes(S, D, f64) bytes.  Returns cudaGetLastError()
// (or the error of the shared-memory opt-in).
extern "C" int scx_certify(const void* mask, const void* M, const double* s, const double* d,
                           void* scratch, int B, int S, int D, int f64, int* status,
                           long long* n_arcs, double* nums, long long* arcs, double* flows,
                           void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return f64 ? launch<double>(mask, M, s, d, scratch, B, S, D, status, n_arcs, nums, arcs,
                              flows, stream)
             : launch<float>(mask, M, s, d, scratch, B, S, D, status, n_arcs, nums, arcs,
                             flows, stream);
}
