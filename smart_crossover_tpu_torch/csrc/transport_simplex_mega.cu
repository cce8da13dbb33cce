// In-kernel transportation simplex for Hopper (sm_90a): one thread block
// runs one instance's whole pivot loop, to optimality, with no host sync.
//
// Replaces the TPU kernel smart_crossover_tpu/ops/transport_simplex_mega.py::
// _mega_kernel and keeps its pivot rule exactly:
//   pricing   Dantzig over non-basic cells of M - u - v; ties to the lowest
//             flat index (lowest row, then lowest column); stop at
//             dmin >= -tol;
//   ratio     theta = min Xv over the cycle's decreasing tree cells; the
//             leaving arc is the lowest node id with ratio <= theta + 1e-12;
//   entering  the new tree cell's cost is the exact M[ei, ej];
//   refresh   every `refresh` pivots and at exit,
//             pot[v] = (-1)^dep[v] sum_k N[v,k] (-1)^dep[k] w[k].
// The tree is the root-path indicator matrix N (V x V bytes, N[u,w] = 1 iff
// w is on u's root path) plus per-node parent / depth / cell cost w / cell
// flow Xv, keyed by child node; node ids are rows 0..S-1, columns S..V-1.
//
// Bound: each pivot reads the pricing pass (M f32 + basis mask, S*D cells)
// and rewrites the N rows of the re-hung subtree.  One instance's N is 256
// KB at 256^2 and 2.4 MB at 784^2 (V = 1568, no TPU 128-padding), beyond a
// block's shared memory even bit-packed, so N, M and the mask stay in global
// memory, where at 64 x 256^2 they are L2-resident.  The per-node vectors
// live in shared memory.  Only the rows of the re-hung subtree are touched
// (the TPU kernel rewrites all V rows); each warp owns whole rows, so a row
// is read and rewritten by one warp with coalesced byte loads.  Phases are
// separated by __syncthreads(); argmins are block-wide (value, index)
// reductions.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct Scratch {          // block-wide reduction slots
  float f[kWarps];
  int i[kWarps];
  float fb;
  int ib;
};

__device__ __forceinline__ void argmin_pair(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

// Block-wide argmin of (v, i): smallest v, ties to the smallest i.  All
// threads receive the result.
__device__ void block_argmin(float& v, int& i, Scratch& sc) {
  for (int o = 16; o > 0; o >>= 1) {
    float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    argmin_pair(v, i, v2, i2);
  }
  int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) { sc.f[w] = v; sc.i[w] = i; }
  __syncthreads();
  if (w == 0) {
    v = sc.f[threadIdx.x];
    i = sc.i[threadIdx.x];
    for (int o = 16; o > 0; o >>= 1) {
      float v2 = __shfl_xor_sync(0xffffffffu, v, o);
      int i2 = __shfl_xor_sync(0xffffffffu, i, o);
      argmin_pair(v, i, v2, i2);
    }
    if (threadIdx.x == 0) { sc.fb = v; sc.ib = i; }
  }
  __syncthreads();
  v = sc.fb;
  i = sc.ib;
  __syncthreads();
}

__device__ float block_min(float v, Scratch& sc) {
  int i = 0;
  block_argmin(v, i, sc);
  return v;
}

__device__ int block_min_int(int i, Scratch& sc) {
  for (int o = 16; o > 0; o >>= 1) i = min(i, __shfl_xor_sync(0xffffffffu, i, o));
  int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) sc.i[w] = i;
  __syncthreads();
  if (w == 0) {
    i = sc.i[threadIdx.x];
    for (int o = 16; o > 0; o >>= 1) i = min(i, __shfl_xor_sync(0xffffffffu, i, o));
    if (threadIdx.x == 0) sc.ib = i;
  }
  __syncthreads();
  i = sc.ib;
  __syncthreads();
  return i;
}

struct Inst {
  int S, D, V;
  const float* M;          // (S, D)
  unsigned char* N;        // (V, V) working copy
  unsigned char* mask;     // (S, D) pricing mask: 1 = basic
  // shared-memory node vectors (double-buffered where a pivot reads old
  // values of other nodes while writing new ones)
  int* parent; int* parent2;
  int* dep;    int* dep2;
  float* w;    float* w2;
  float* Xv;   float* Xv2;
  float* pot;
  int* child;
  unsigned char* ax; unsigned char* ay; unsigned char* inC;
};

__device__ __forceinline__ float parity(int dep) { return (dep & 1) ? -1.0f : 1.0f; }

// pot[v] = (-1)^dep[v] * sum_k N[v,k] (-1)^dep[k] w[k]; one warp per row.
__device__ void refresh_pot(Inst& I) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int v = warp; v < I.V; v += kWarps) {
    const unsigned char* row = I.N + (long)v * I.V;
    float acc = 0.0f;
    for (int k = lane; k < I.V; k += 32)
      if (row[k]) acc += parity(I.dep[k]) * I.w[k];
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) I.pot[v] = parity(I.dep[v]) * acc;
  }
  __syncthreads();
}

// Dantzig pricing: (dmin, flat index) over M - u - v, basic cells priced 0.
__device__ void price(Inst& I, Scratch& sc, float& dmin, int& flat) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* vpot = I.pot + I.S;
  float best = CUDART_INF_F;
  int bi = INT_MAX;
  for (int i = warp; i < I.S; i += kWarps) {
    float u = I.pot[i];
    const float* Mr = I.M + (long)i * I.D;
    const unsigned char* Br = I.mask + (long)i * I.D;
    for (int j = lane; j < I.D; j += 32) {
      float dl = Br[j] ? 0.0f : (Mr[j] - u) - vpot[j];
      if (dl < best) { best = dl; bi = i * I.D + j; }
    }
  }
  block_argmin(best, bi, sc);
  dmin = best;
  flat = bi;
}

__device__ __forceinline__ bool is_dec(const Inst& I, int k) {
  // decreasing cycle cell: on the cycle and keyed by a row node on x's
  // branch or by a column node on y's branch
  bool onc = I.ax[k] != I.ay[k];
  return onc && ((I.ax[k] != 0) == (k < I.S));
}

__device__ __forceinline__ float sign_of(const Inst& I, int k) {
  if (I.ax[k] == I.ay[k]) return 0.0f;
  return ((I.ax[k] != 0) == (k < I.S)) ? -1.0f : 1.0f;
}

// One pivot on the entering cell (ei, ej) with reduced cost dmin.
__device__ void pivot(Inst& I, Scratch& sc, float dmin, int ei, int ej) {
  const int S = I.S, V = I.V;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int x_end = ei, y_end = S + ej;

  // cycle: root-path rows of both endpoints
  for (int k = tid; k < V; k += kThreads) {
    I.ax[k] = I.N[(long)x_end * V + k];
    I.ay[k] = I.N[(long)y_end * V + k];
    I.child[k] = -1;
  }
  __syncthreads();

  // ratio test
  float r = CUDART_INF_F;
  for (int k = tid; k < V; k += kThreads)
    if (is_dec(I, k)) r = fminf(r, I.Xv[k]);
  const float theta = block_min(r, sc);
  const float thr = theta + 1e-12f;
  int c = V;
  for (int k = tid; k < V; k += kThreads) {
    float rk = is_dec(I, k) ? I.Xv[k] : CUDART_INF_F;
    if (rk <= thr) { c = k; break; }
  }
  const int cl = block_min_int(c, sc);

  const int dep_cl = I.dep[cl];
  const bool on_x = I.ax[cl] != 0;
  const int e_same = on_x ? x_end : y_end;
  const int e_other = on_x ? y_end : x_end;
  const unsigned char* nes = on_x ? I.ax : I.ay;
  const unsigned char* neo = on_x ? I.ay : I.ax;
  const int p_cl = I.parent[cl];
  const int li = cl < S ? cl : p_cl;
  const int lj = cl < S ? p_cl - S : cl - S;
  const float m_enter = I.M[(long)ei * I.D + ej];
  const float row_shift = on_x ? dmin : -dmin;

  // re-key map: the path e_same..cl reverses, so each path node below cl
  // hands its (Xv, w) to its old parent; targets are distinct on a path
  for (int v = tid; v < V; v += kThreads)
    if (nes[v] && I.dep[v] >= dep_cl && v != cl) I.child[I.parent[v]] = v;

  // N rows of the re-hung subtree C = {t : N[t, cl]}:
  //   N'[t] = (N[t] ^ nes) | lca_bit(t) | neo
  for (int t = warp; t < V; t += kWarps) {
    unsigned char* row = I.N + (long)t * V;
    if (!row[cl]) {
      if (lane == 0) { I.dep2[t] = I.dep[t]; I.inC[t] = 0; }
      continue;
    }
    int lca = -1;
    for (int k = lane; k < V; k += 32)
      if (row[k] && nes[k]) lca = max(lca, I.dep[k]);
    for (int o = 16; o > 0; o >>= 1) lca = max(lca, __shfl_xor_sync(0xffffffffu, lca, o));
    int cnt = 0;
    for (int k = lane; k < V; k += 32) {
      unsigned char nb = row[k];
      unsigned char common = nb & nes[k];
      unsigned char lca_bit = (common && I.dep[k] == lca) ? 1 : 0;
      unsigned char nn = (unsigned char)((nb ^ nes[k]) | lca_bit | neo[k]);
      row[k] = nn;
      cnt += nn;
    }
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    if (lane == 0) { I.dep2[t] = cnt - 1; I.inC[t] = 1; }
  }
  __syncthreads();

  // per-node re-key, parent reversal, potential shift on C
  for (int t = tid; t < V; t += kThreads) {
    int ch = I.child[t];
    bool hit = ch >= 0;
    float xv = hit ? I.Xv[ch] + sign_of(I, ch) * theta : I.Xv[t] + sign_of(I, t) * theta;
    float wt = hit ? I.w[ch] : I.w[t];
    bool seg_hit = hit && nes[t] && I.dep[t] >= dep_cl;
    int pt = seg_hit ? ch : I.parent[t];
    if (t == e_same) { xv = theta; wt = m_enter; pt = e_other; }
    I.Xv2[t] = xv;
    I.w2[t] = wt;
    I.parent2[t] = pt;
    if (I.inC[t]) I.pot[t] += (t < S) ? row_shift : -row_shift;
  }
  if (tid == 0) {
    I.mask[(long)ei * I.D + ej] = 1;
    I.mask[(long)li * I.D + lj] = 0;
  }
  __syncthreads();
  int* ti; float* tf;
  ti = I.parent; I.parent = I.parent2; I.parent2 = ti;
  ti = I.dep; I.dep = I.dep2; I.dep2 = ti;
  tf = I.Xv; I.Xv = I.Xv2; I.Xv2 = tf;
  tf = I.w; I.w = I.w2; I.w2 = tf;
}

__global__ void __launch_bounds__(kThreads)
mega_kernel(const float* __restrict__ M, const unsigned char* __restrict__ N_in,
            const unsigned char* __restrict__ mask_in,
            const int* __restrict__ parent_in, const int* __restrict__ dep_in,
            const float* __restrict__ w_in, const float* __restrict__ Xv_in,
            unsigned char* N_work, unsigned char* mask_out, int* parent_out,
            float* Xv_out, float* w_out, float* pot_out, int* stats,
            int S, int D, float tol, int max_pivots, int refresh) {
  extern __shared__ unsigned char smem[];
  __shared__ Scratch sc;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int V = S + D;
  const long VV = (long)V * V, SD = (long)S * D;

  Inst I;
  I.S = S; I.D = D; I.V = V;
  I.M = M + b * SD;
  I.N = N_work + b * VV;
  I.mask = mask_out + b * SD;
  int* ip = reinterpret_cast<int*>(smem);
  I.parent = ip; I.parent2 = ip + V; I.dep = ip + 2 * V; I.dep2 = ip + 3 * V;
  I.child = ip + 4 * V;
  float* fp = reinterpret_cast<float*>(ip + 5 * V);
  I.w = fp; I.w2 = fp + V; I.Xv = fp + 2 * V; I.Xv2 = fp + 3 * V; I.pot = fp + 4 * V;
  unsigned char* bp = reinterpret_cast<unsigned char*>(fp + 5 * V);
  I.ax = bp; I.ay = bp + V; I.inC = bp + 2 * V;

  const unsigned char* Nb = N_in + b * VV;
  for (long k = tid; k < VV; k += kThreads) I.N[k] = Nb[k];
  const unsigned char* mb = mask_in + b * SD;
  for (long k = tid; k < SD; k += kThreads) I.mask[k] = mb[k];
  for (int k = tid; k < V; k += kThreads) {
    I.parent[k] = parent_in[b * V + k];
    I.dep[k] = dep_in[b * V + k];
    I.w[k] = w_in[b * V + k];
    I.Xv[k] = Xv_in[b * V + k];
    I.pot[k] = 0.0f;
  }
  __syncthreads();

  // Loop structure of the TPU kernel: refresh, price; if not optimal, run
  // up to `refresh` pivots, stopping early where the drifted pricing finds
  // nothing to enter; the refreshed check alone decides optimality.
  int it = 0;
  bool optimal = false;
  while (it < max_pivots) {
    refresh_pot(I);
    float dmin; int flat;
    price(I, sc, dmin, flat);
    if (dmin >= -tol) { optimal = true; break; }
    const int start = it;
    while (true) {
      pivot(I, sc, dmin, flat / D, flat % D);
      ++it;
      if (it >= start + refresh || it >= max_pivots) break;
      price(I, sc, dmin, flat);
      if (dmin >= -tol) break;
    }
  }
  refresh_pot(I);

  for (int k = tid; k < V; k += kThreads) {
    parent_out[b * V + k] = I.parent[k];
    Xv_out[b * V + k] = I.Xv[k];
    w_out[b * V + k] = I.w[k];
    pot_out[b * V + k] = I.pot[k];
  }
  if (tid == 0) {
    stats[2 * b] = it;
    stats[2 * b + 1] = optimal ? 1 : 0;
  }
}

}  // namespace

// Bytes of dynamic shared memory for an instance with V nodes.
static size_t mega_smem_bytes(int V) { return (size_t)V * (5 * 4 + 5 * 4 + 3); }

// Launches one block per instance on `stream`.  N_in / mask_in are read
// only; the kernel copies them into N_work / mask_out.  Returns
// cudaGetLastError() (or the error of the shared-memory opt-in).
extern "C" int scx_transport_simplex_mega(
    const float* M, const unsigned char* N_in, const unsigned char* mask_in,
    const int* parent_in, const int* dep_in, const float* w_in, const float* Xv_in,
    unsigned char* N_work, unsigned char* mask_out, int* parent_out,
    float* Xv_out, float* w_out, float* pot_out, int* stats,
    int B, int S, int D, float tol, int max_pivots, int refresh, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  size_t smem = mega_smem_bytes(S + D);
  cudaError_t e = cudaFuncSetAttribute(mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  mega_kernel<<<B, kThreads, smem, stream>>>(M, N_in, mask_in, parent_in, dep_in, w_in, Xv_in,
                                             N_work, mask_out, parent_out, Xv_out, w_out,
                                             pot_out, stats, S, D, tol, max_pivots, refresh);
  return (int)cudaGetLastError();
}
