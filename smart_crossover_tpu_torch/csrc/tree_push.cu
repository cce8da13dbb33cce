// Irrigation push to feasibility for Hopper (sm_90a): one thread block runs
// one instance's whole push loop, with no host sync.
//
// Replaces no TPU kernel: the JAX package runs the push as a
// lax.while_loop (smart_crossover_tpu/ops/tree.py::push_to_bfs), and the
// port's plain version (ops/tree.py::push_to_bfs_plain, the CPU path) drives
// it from the host at some twenty small launches a step.  The step is the
// plain loop's, exactly:
//   (I1, J1)  the most negative cell, the first in flat order; stop when
//             X[I1,J1] >= -tol (in T) or after max_iter steps;
//   J2, I2    the first argmax of row I1, the first argmax of column J1;
//   theta     min(min(-X[I1,J1], X[I1,J2]), X[I2,J1]), as torch.minimum;
//   update    X[I1,J1] += theta, X[I2,J1] -= theta, X[I1,J2] -= theta,
//             X[I2,J2] += theta, each a read-modify-write in that order, so
//             that I1 == I2 or J1 == J2 come out as in the plain loop.
//
// Bound on this card: the steps are a serial chain, each a few dependent
// reductions over a row, a column and the row minima, so the loop is bound
// by latency (block barriers, L1/L2 round trips), not by bytes or
// operations: after one pass over the S*D values of X, a step reads
// O(S + D) values and writes four.
//
// Design: a step changes two rows, I1 and I2, so each row's (min, first
// column of the min) is kept in a cache and only those two rows are
// recomputed; the row minima are grouped by 32 rows and each group's
// (min, first row) is kept too, so the next (I1, J1) is two warp
// reductions.  The cache lives in shared memory where it fits beside the
// kernel's static shared memory (S up to ~28,100 rows at float32, ~18,700
// at float64 on an H100), else in a global scratch the caller passes, a
// region per block: the same steps, slower.  A step is four block barriers: the argmaxes of row I1 and
// column J1 in one pass over the block; warp 0 combines them and lane 0
// applies the update; the minima of rows I1 and I2 in one pass; warp 0
// combines them, refreshes their groups and finds the next cell.  Ties go
// to the smaller index everywhere and a NaN wins a reduction, as in
// torch.min and torch.argmax; nothing is atomic, so the result is the plain
// loop's bit for bit and repeat launches are identical.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / kWarp;

template <typename T>
struct Arg {
  T v;
  int i;
};

template <typename T>
__device__ __forceinline__ bool is_nan(T x) {
  return x != x;
}

// Whether (a, ia) wins over (b, ib) in a min (kMin) or max reduction: a NaN
// first, then the better value, then the smaller index.
template <bool kMin, typename T>
__device__ __forceinline__ bool wins(T a, int ia, T b, int ib) {
  if (is_nan(a)) return !is_nan(b) || ia < ib;
  if (is_nan(b)) return false;
  return (kMin ? a < b : a > b) || (a == b && ia < ib);
}

// An empty entry: loses to every value at any index.
template <bool kMin, typename T>
__device__ __forceinline__ Arg<T> none() {
  const T inf = (T)CUDART_INF_F;
  return Arg<T>{kMin ? inf : -inf, INT_MAX};
}

template <bool kMin, typename T>
__device__ __forceinline__ void take(Arg<T>& a, T v, int i) {
  if (wins<kMin>(v, i, a.v, a.i)) a = Arg<T>{v, i};
}

// The warp's winner, in lane 0; every lane of the warp takes part.
template <bool kMin, typename T>
__device__ __forceinline__ Arg<T> warp_reduce(Arg<T> a) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const T v = __shfl_down_sync(0xffffffffu, a.v, off);
    const int i = __shfl_down_sync(0xffffffffu, a.i, off);
    take<kMin>(a, v, i);
  }
  return a;
}

// torch.minimum: a NaN propagates, else (b < a) ? b : a.
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  return b < a ? b : a;
}

// A block's cache: row minima rv/rc (S) and group minima gv/gr (ceil(S/32)),
// the values first, then the ints, padded to 16 bytes so that the regions of
// a global scratch stay aligned.
__host__ __device__ inline size_t cache_bytes(int S, int itemsize) {
  const size_t ng = (size_t)(S + kWarp - 1) / kWarp;
  return (((size_t)S + ng) * (size_t)(itemsize + 4) + 15) & ~(size_t)15;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    tree_push_kernel(T* X, long long* __restrict__ iters, unsigned char* scratch, int S,
                     int D, T ntol, int max_iter) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NG = (S + kWarp - 1) / kWarp;
  unsigned char* cache =
      scratch ? scratch + (size_t)blockIdx.x * cache_bytes(S, (int)sizeof(T)) : smem;
  T* rv = reinterpret_cast<T*>(cache);
  T* gv = rv + S;
  int* rc = reinterpret_cast<int*>(gv + NG);
  int* gr = rc + S;
  // two warp-partial slots per warp
  __shared__ T pv[2 * kMaxWarps];
  __shared__ int pi[2 * kMaxWarps];
  __shared__ T s_vmin;
  __shared__ int s_I1, s_J1, s_I2;

  T* Xb = X + (size_t)blockIdx.x * S * D;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % kWarp, warp = tid / kWarp, nwarps = nt / kWarp;

  // warp 0: group g's (min, first row) from the row minima
  auto refresh_group = [&](int g) {
    const int i = g * kWarp + lane;
    Arg<T> m = none<true, T>();
    if (i < S) m = Arg<T>{rv[i], i};
    m = warp_reduce<true>(m);
    if (lane == 0) {
      gv[g] = m.v;
      gr[g] = m.i;
    }
  };
  // warp 0: the next (I1, J1) from the group minima
  auto find_min = [&]() {
    Arg<T> m = none<true, T>();
    for (int g = lane; g < NG; g += kWarp) take<true>(m, gv[g], gr[g]);
    m = warp_reduce<true>(m);
    if (lane == 0) {
      s_vmin = m.v;
      s_I1 = m.i;
      s_J1 = rc[m.i];
    }
  };

  // every row's (min, first column), a warp a row
  for (int i = warp; i < S; i += nwarps) {
    const T* row = Xb + (size_t)i * D;
    Arg<T> m = none<true, T>();
    for (int j = lane; j < D; j += kWarp) take<true>(m, row[j], j);
    m = warp_reduce<true>(m);
    if (lane == 0) {
      rv[i] = m.v;
      rc[i] = m.i;
    }
  }
  __syncthreads();
  if (warp == 0) {
    for (int g = 0; g < NG; ++g) refresh_group(g);
    __syncwarp();
    find_min();
  }
  __syncthreads();

  long long it = 0;
  for (;;) {
    const T vmin = s_vmin;
    const int I1 = s_I1, J1 = s_J1;
    if (!(vmin < ntol) || it >= max_iter) break;
    const T* row1 = Xb + (size_t)I1 * D;

    // J2 = first argmax of row I1, I2 = first argmax of column J1
    Arg<T> r = none<false, T>(), c = none<false, T>();
    for (int j = tid; j < D; j += nt) take<false>(r, row1[j], j);
    for (int i = tid; i < S; i += nt) take<false>(c, Xb[(size_t)i * D + J1], i);
    r = warp_reduce<false>(r);
    c = warp_reduce<false>(c);
    if (lane == 0) {
      pv[warp] = r.v;
      pi[warp] = r.i;
      pv[kMaxWarps + warp] = c.v;
      pi[kMaxWarps + warp] = c.i;
    }
    __syncthreads();
    if (warp == 0) {
      r = none<false, T>();
      c = none<false, T>();
      if (lane < nwarps) {
        r = Arg<T>{pv[lane], pi[lane]};
        c = Arg<T>{pv[kMaxWarps + lane], pi[kMaxWarps + lane]};
      }
      r = warp_reduce<false>(r);
      c = warp_reduce<false>(c);
      if (lane == 0) {
        const int J2 = r.i, I2 = c.i;
        const T theta = tmin(tmin(-vmin, r.v), c.v);
        // the four cells in the plain loop's order, with the values read
        // above (X[I1,J1] = vmin, X[I2,J1] = c.v, X[I1,J2] = r.v); an update
        // is seen by the later ones on the same cell, the last store wins
        const size_t cell[4] = {(size_t)I1 * D + J1, (size_t)I2 * D + J1,
                                (size_t)I1 * D + J2, (size_t)I2 * D + J2};
        T v[4] = {vmin, c.v, r.v, Xb[cell[3]]};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const T n = (k == 0 || k == 3) ? v[k] + theta : v[k] - theta;
          v[k] = n;
#pragma unroll
          for (int m = k + 1; m < 4; ++m)
            if (cell[m] == cell[k]) v[m] = n;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) Xb[cell[k]] = v[k];
        s_I2 = I2;
      }
    }
    __syncthreads();

    // the new minima of rows I1 and I2
    const int I2 = s_I2;
    const T* row2 = Xb + (size_t)I2 * D;
    Arg<T> m1 = none<true, T>(), m2 = none<true, T>();
    for (int j = tid; j < D; j += nt) {
      take<true>(m1, row1[j], j);
      if (I2 != I1) take<true>(m2, row2[j], j);
    }
    m1 = warp_reduce<true>(m1);
    m2 = warp_reduce<true>(m2);
    if (lane == 0) {
      pv[warp] = m1.v;
      pi[warp] = m1.i;
      pv[kMaxWarps + warp] = m2.v;
      pi[kMaxWarps + warp] = m2.i;
    }
    __syncthreads();
    if (warp == 0) {
      m1 = none<true, T>();
      m2 = none<true, T>();
      if (lane < nwarps) {
        m1 = Arg<T>{pv[lane], pi[lane]};
        m2 = Arg<T>{pv[kMaxWarps + lane], pi[kMaxWarps + lane]};
      }
      m1 = warp_reduce<true>(m1);
      m2 = warp_reduce<true>(m2);
      if (lane == 0) {
        rv[I1] = m1.v;
        rc[I1] = m1.i;
        if (I2 != I1) {
          rv[I2] = m2.v;
          rc[I2] = m2.i;
        }
      }
      __syncwarp();
      refresh_group(I1 / kWarp);
      if (I2 / kWarp != I1 / kWarp) refresh_group(I2 / kWarp);
      __syncwarp();
      find_min();
    }
    ++it;
    __syncthreads();
  }
  if (tid == 0) iters[blockIdx.x] = it;
}

// Bytes of global scratch a block needs for S rows: 0 where the cache fits
// the current device's shared memory per block beside the kernel's static
// shared memory; a negative CUDA error if a query fails or the bytes pass
// INT_MAX.
template <typename T>
int scratch_bytes(int S) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, tree_push_kernel<T>);
  if (e != cudaSuccess) return -(int)e;
  const size_t bytes = cache_bytes(S, (int)sizeof(T));
  if (fa.sharedSizeBytes + bytes <= (size_t)optin) return 0;
  return bytes <= (size_t)INT_MAX ? (int)bytes : -(int)cudaErrorInvalidValue;
}

template <typename T>
int launch(void* X, long long* iters, void* scratch, int B, int S, int D, double tol,
           int max_iter, cudaStream_t stream) {
  const int wide = S > D ? S : D;
  const int threads = wide >= kMaxThreads ? kMaxThreads : (wide + kWarp - 1) / kWarp * kWarp;
  size_t smem = 0;
  if (!scratch) {
    if (scratch_bytes<T>(S) != 0) return (int)cudaErrorInvalidValue;
    smem = cache_bytes(S, (int)sizeof(T));
    const cudaError_t e = cudaFuncSetAttribute(
        tree_push_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tree_push_kernel<T><<<B, threads, smem, stream>>>(
      static_cast<T*>(X), iters, static_cast<unsigned char*>(scratch), S, D, (T)(-tol),
      max_iter);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of global scratch each block needs for S rows of float64 (f64) or
// float32 values: 0 where its cache fits in shared memory on the current
// device; a negative CUDA error if a query fails.
extern "C" int scx_tree_push_scratch_bytes(int S, int f64) {
  return f64 ? scratch_bytes<double>(S) : scratch_bytes<float>(S);
}

// Pushes X (B, S, D), contiguous, float64 where f64 else float32, to
// feasibility in place on `stream`, one block per instance, and writes
// each instance's steps to iters (B, int64).  `scratch` is null where the
// blocks' caches fit in shared memory, else B regions of
// scx_tree_push_scratch_bytes(S, f64) bytes.  Returns cudaGetLastError()
// (or the error of the shared-memory opt-in).
extern "C" int scx_tree_push(void* X, long long* iters, void* scratch, int B, int S, int D,
                             double tol, int max_iter, int f64, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return f64 ? launch<double>(X, iters, scratch, B, S, D, tol, max_iter, stream)
             : launch<float>(X, iters, scratch, B, S, D, tol, max_iter, stream);
}
