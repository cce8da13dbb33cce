// Walk of a batch of spanning trees, each given as a dense bipartite mask,
// for Hopper (sm_90a): one thread block walks one instance's tree and
// returns each node's parent in the tree rooted at node 0 (row 0), or the
// tree's flows for given row and column sums.
//
// Replaces no TPU kernel: the JAX package computes both as lax.while_loops
// (smart_crossover_tpu/ops/tree.py::bipartite_tree_solve, leaf elimination;
// smart_crossover_tpu/ops/transport_simplex_parent.py::build_parent_from_mask,
// a masked breadth-first search), which the port ran as host-driven loops of
// dense (B, S, D) passes, O(diameter) rounds each.  The plain versions stay in
// ops/tree.py as the CPU path and the oracle.  Nodes 0..S-1 are rows,
// S..S+D-1 columns; arc (i, j) joins row i and column S + j.
//   arcs      the mask's nonzero cells in flat order; S + D - 1 of them, else
//             status 1;
//   tree      a walk breadth first from the root over the arcs; a node left
//             unreached means the arcs hold a cycle: status 2;
//   parent    rooted at node 0: each node's neighbour towards node 0,
//             parent[0] = 0; in a tree it is unique, so it equals any other
//             search's;
//   flows     rooted at the first node of largest |mass|: each arc carries
//             its lower node's subtree balance, acc_v = m_v minus the sum of
//             the arcs to v's children, m_v = s_i on a row, d_j on a column,
//             summed in float64 in reverse walk order, then rounded once into
//             the flows' dtype and scattered into the caller's zeroed dense
//             X.  Masses may have any sign.  Masses rounded to float32 do not
//             balance, and the root keeps the gap: at a zero-mass leaf the
//             gap would put a flow of a few roundings on its arc, where the
//             push to feasibility then stalls (its ratio is 0);
//   depth     the walk's deepest level from its root, for the caller's trace
//             counter.
//
// Bound on this card: one read of the S*D mask bytes (16 MiB at 16 x 1024^2,
// ~5 us at 3.35 TB/s) and the scatter of V - 1 flows; the walk and the
// flows' sums are a serial chain over the V = S + D nodes (a few
// shared-memory round trips an arc), which binds the block at the main
// path's shapes rather than bytes.  The design spends the block's threads
// where the work is parallel (the compaction, the arc lists, the outputs)
// and keeps the chain in shared memory on one thread, in place of the plain
// loops' dense passes over all S*D cells in every round.
//
// Design: the block compacts the mask tile by tile, 16-byte loads aligned
// down from the instance's first byte (a block scan keeps flat order), takes
// each row's arcs as a run of the flat list and each column's from one pass
// that the column's owner thread makes over the list, finds the flows' root
// by a block reduction, then thread 0 walks the tree and sums the flows.
// Node and arc arrays live in shared memory where they fit beside the
// kernel's static shared memory (36 V bytes, up to V ~ 6,400 on an H100),
// else in a global region per block that the caller passes.  Nothing is atomic but the column counts, whose totals do not
// depend on order, so repeat launches give the same bits.

#include <cuda_runtime.h>
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
constexpr int kUnreached = 2;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// A block's region: acc (V doubles), then ints: arc_row, arc_col, col_list
// (n1 each), row_start (S + 1), col_start (D + 1), col_fill (D), par, order
// (V each).
__host__ __device__ inline size_t region_bytes(int S, int D) {
  const size_t V = (size_t)S + D, n1 = V - 1;
  return align16(V * sizeof(double) +
                 (3 * n1 + (size_t)S + 1 + (size_t)D + 1 + (size_t)D + 2 * V) * sizeof(int));
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

// The first node of largest |acc| over the block (every thread calls it);
// wbest, widx: kMaxWarps each.
__device__ int block_argmax_abs(const double* acc, int V, double* wbest, int* widx) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  double best = -1.0;
  int idx = V;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const double a = fabs(acc[v]);
    if (a > best) {
      best = a;
      idx = v;
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const double ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  if (lane == 0) {
    wbest[warp] = best;
    widx[warp] = idx;
  }
  __syncthreads();
  best = wbest[0];
  idx = widx[0];
  for (int w = 1; w < nwarps; ++w) {
    if (wbest[w] > best || (wbest[w] == best && widx[w] < idx)) {
      best = wbest[w];
      idx = widx[w];
    }
  }
  return idx < V ? idx : 0;  // no comparable mass (NaNs): node 0
}

// One block per instance.  mask: instance b's S*D bytes start at mask + b *
// stride (rows contiguous within it).  Exactly one of parent_out (B, V) and
// X (B, S, D, zeroed by the caller, with s (B, S) and d (B, D)) is non-null.
// info (B, 2): status, depth.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    tree_walk_kernel(const unsigned char* __restrict__ mask, long long stride,
                     const T* __restrict__ s, const T* __restrict__ d, unsigned char* scratch,
                     int S, int D, long long* __restrict__ parent_out, T* __restrict__ X,
                     int* __restrict__ info) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wsum[kMaxWarps];
  __shared__ double wbest[kMaxWarps];
  __shared__ int s_reached;

  const int V = S + D, n1 = V - 1;
  const size_t SD = (size_t)S * D;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const unsigned char* mb = mask + (size_t)b * stride;

  unsigned char* region = scratch ? scratch + (size_t)b * region_bytes(S, D) : smem;
  double* acc = reinterpret_cast<double*>(region);
  int* arc_row = reinterpret_cast<int*>(acc + V);
  int* arc_col = arc_row + n1;
  int* col_list = arc_col + n1;  // each column's rows, in flat order
  int* row_start = col_list + n1;
  int* col_start = row_start + S + 1;
  int* col_fill = col_start + D + 1;  // column counts, then fill positions
  int* par = col_fill + D;
  int* order = par + V;

  for (int j = tid; j < D; j += nt) col_fill[j] = 0;

  // 1. the mask's nonzero cells in flat order, each thread 64 bytes a tile
  // of the span that starts at mb aligned down to 16 bytes; a 16-byte load
  // that holds a byte of the instance stays inside its allocation
  const int lead = (int)((uintptr_t)mb & 15);
  const unsigned char* m0 = mb - lead;
  const size_t span = SD + lead;
  long long total = 0;
  for (size_t base = 0; base < span; base += (size_t)nt * kTileBytes) {
    const size_t off = base + (size_t)tid * kTileBytes;
    unsigned int w[kTileBytes / 4];
#pragma unroll
    for (int k = 0; k < kTileBytes / 16; ++k) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (off + 16 * k < span) v = reinterpret_cast<const uint4*>(m0 + off)[k];
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
    if (off < (size_t)lead || off + kTileBytes > span) {
      // the span's first and last tiles: drop the bytes outside the instance
#pragma unroll
      for (int q = 0; q < kTileBytes; ++q) {
        if (off + q < (size_t)lead || off + q >= span) w[q / 4] &= ~(0xffu << (8 * (q % 4)));
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
            const size_t f = off + q - lead;
            arc_row[pos] = (int)(f / D);
            arc_col[pos] = (int)(f % D);
          }
          ++pos;
        }
      }
    }
    total += tile_total;
  }
  if (total != n1) {
    if (tid == 0) {
      info[2 * b] = kCount;
      info[2 * b + 1] = 0;
    }
    return;
  }
  __syncthreads();

  // 2. each node's arc list: a row's is the run of its row in the flat
  // list, a column's the rows of the flat list's arcs in its column
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
    if ((j & (nt - 1)) == tid) col_list[col_fill[j]++] = arc_row[p];
  }
  for (int v = tid; v < V; v += nt) {
    par[v] = -1;
    if (X) acc[v] = v < S ? (double)s[(size_t)b * S + v] : (double)d[(size_t)b * D + v - S];
  }
  __syncthreads();
  const int root = X ? block_argmax_abs(acc, V, wbest, wsum) : 0;

  // 3. thread 0: the walk from the root, level by level, then the flows from
  // the leaves up (a node follows all of its children in the walk)
  if (tid == 0) {
    int head = 0, tail = 0, depth = 0, level_end = 1;
    order[tail++] = root;
    par[root] = root;
    while (head < tail) {
      if (head == level_end) {
        ++depth;
        level_end = tail;
      }
      const int v = order[head++];
      if (v < S) {
        for (int p = row_start[v]; p < row_start[v + 1]; ++p) {
          const int u = S + arc_col[p];
          if (par[u] < 0) {
            par[u] = v;
            order[tail++] = u;
          }
        }
      } else {
        for (int q = col_start[v - S]; q < col_start[v - S + 1]; ++q) {
          const int u = col_list[q];
          if (par[u] < 0) {
            par[u] = v;
            order[tail++] = u;
          }
        }
      }
    }
    if (X && tail == V) {
      for (int k = V - 1; k > 0; --k) {
        const int v = order[k];
        acc[par[v]] -= acc[v];
      }
    }
    s_reached = tail;
    info[2 * b] = tail == V ? kTree : kUnreached;
    info[2 * b + 1] = depth;
  }
  __syncthreads();
  if (s_reached != V) return;

  // 4. the outputs
  for (int v = tid; v < V; v += nt) {
    const int p = par[v];
    if (parent_out) parent_out[(size_t)b * V + v] = p;
    if (X && v != root) {
      const size_t cell = v < S ? (size_t)v * D + (p - S) : (size_t)p * D + (v - S);
      X[(size_t)b * SD + cell] = (T)acc[v];
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
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, tree_walk_kernel<T>);
  if (e != cudaSuccess) return -(int)e;
  const size_t bytes = region_bytes(S, D);
  if (fa.sharedSizeBytes + bytes <= (size_t)optin) return 0;
  return bytes <= (size_t)INT_MAX ? (int)bytes : -(int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* mask, long long stride, const void* s, const void* d, void* scratch,
           int B, int S, int D, long long* parent, void* X, int* info, cudaStream_t stream) {
  if (B <= 0) return (int)cudaSuccess;
  // a power of two, so that column j's owner is j & (threads - 1)
  const int threads = (size_t)S * D >= (size_t)kMaxThreads * kTileBytes ? kMaxThreads : 256;
  size_t smem = 0;
  if (!scratch) {
    if (scratch_bytes<T>(S, D) != 0) return (int)cudaErrorInvalidValue;
    smem = region_bytes(S, D);
    const cudaError_t e = cudaFuncSetAttribute(
        tree_walk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tree_walk_kernel<T><<<B, threads, smem, stream>>>(
      static_cast<const unsigned char*>(mask), stride, static_cast<const T*>(s),
      static_cast<const T*>(d), static_cast<unsigned char*>(scratch), S, D, parent,
      static_cast<T*>(X), info);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of global scratch each block needs for an S x D instance, the kernel
// built for float64 (f64) or float32 flows: 0 where its region fits in
// shared memory on the current device; a negative CUDA error if a query
// fails.
extern "C" int scx_tree_walk_scratch_bytes(int S, int D, int f64) {
  return f64 ? scratch_bytes<double>(S, D) : scratch_bytes<float>(S, D);
}

// Walks B spanning trees on `stream`, one block per instance.  mask: bytes
// (nonzero = arc), instance b's S*D cells contiguous from mask + b * stride.
// Writes info (B, 2 int32: status 0 a spanning tree, 1 not S + D - 1 arcs,
// 2 a node left unreached; the walk's depth from its root) and for the
// trees either the parent vector (B, S + D int64) rooted at node 0, or,
// where X is given instead, the flows into X (B, S, D, zeroed by the
// caller, float64 where f64 else float32) for row sums s (B, S) and column
// sums d (B, D) in X's dtype, all contiguous.
// `scratch` is null where a block's region fits in shared memory, else B
// regions of scx_tree_walk_scratch_bytes(S, D, f64) bytes.  Returns
// cudaGetLastError() (or the error of the shared-memory opt-in).
extern "C" int scx_tree_walk(const void* mask, long long stride, const void* s, const void* d,
                             void* scratch, int B, int S, int D, int f64, long long* parent,
                             void* X, int* info, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((parent == nullptr) == (X == nullptr)) return (int)cudaErrorInvalidValue;
  return f64 ? launch<double>(mask, stride, s, d, scratch, B, S, D, parent, X, info, stream)
             : launch<float>(mask, stride, s, d, scratch, B, S, D, parent, X, info, stream);
}
