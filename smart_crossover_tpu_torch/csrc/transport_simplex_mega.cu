// In-kernel transportation simplex for Hopper (sm_90a): one thread-block
// cluster of C blocks runs one instance's whole pivot loop, to optimality,
// with no host sync.
//
// Replaces the TPU kernel smart_crossover_tpu/ops/transport_simplex_mega.py::
// _mega_kernel and keeps its pivot rule exactly:
//   pricing   Dantzig over non-basic cells of (M - u) - v in float32, no
//             FMA; ties to the lowest flat index; stop at dmin >= -tol;
//   ratio     theta = min Xv over the cycle's decreasing tree cells; the
//             leaving arc is the lowest node id with ratio <= theta + 1e-12;
//   entering  the new tree cell's cost is the exact M[ei, ej];
//   refresh   every `refresh` pivots and at exit,
//             pot[v] = (-1)^dep[v] sum_k N[v,k] (-1)^dep[k] w[k].
// The tree is the root-path indicator matrix N (N[u,w] = 1 iff w is on u's
// root path) plus per-node parent / depth / cell cost w / cell flow Xv,
// keyed by child node; node ids are rows 0..S-1, columns S..V-1.
//
// Bound on this card: a pivot must read the S*D costs and the basis mask
// once for pricing (4 B + 1 bit per cell) and rewrite the N rows of the
// re-hung subtree; at 16 x 784^2 the batch's M is 39 MB, so one pivot of
// all 16 instances is at least 12 us at HBM's 3.35 TB/s, less from L2.
//
// Design (ops/transport_simplex_mega.py::cluster_plan picks C):
//   * a cluster of C <= 8 blocks of 1024 threads per instance fills the
//     SMs (B*C <= 132; the one-block design used 16 of 132 at 16 x 784^2);
//   * pricing is split by rows of M: rank r prices rows [r*S/C,(r+1)*S/C)
//     over all columns, M read with 16-byte loads from L2 (the batch's M
//     fits there once N and the mask have left global memory); each rank
//     posts its (dmin, flat) in its shared memory, and after a cluster
//     barrier every rank reduces all C of them through distributed shared
//     memory (DSMEM) to the same entering cell;
//   * the mask is bit-packed, ceil(D/32) words per row, and each rank holds
//     its rows of it; N is bit-packed, ceil(V/32) words per row, and rank
//     r owns rows [r*V/C,(r+1)*V/C); both slices live in shared memory
//     where they fit, else in a global scratch buffer, reached through the
//     same row pointers;
//   * the row update is word algebra, N'[t] = (N[t] ^ nes) | lca_bit | neo:
//     N[t] & nes is the root path t shares with e_same, so the LCA is the
//     nes node at depth popcount(N[t] & nes) - 1 (a per-pivot table), the
//     new depth is popcount(N'[t]) - 1, and subtree membership is one bit
//     test of the row in shared memory;
//   * the node vectors (parent, dep, w, Xv, pot, child, the depth table;
//     ids and depths int16) are replicated in every rank, and every rank
//     applies the same per-node update, so the replicas stay identical
//     without a broadcast.  Only what one rank alone computes crosses the
//     cluster: the (dmin, flat) pairs, the cycle rows x_end and y_end of N
//     (DSMEM loads), and the new dep and pot of the re-hung rows a rank
//     owns (DSMEM stores).  Three cluster barriers per pivot.
// Reductions run in a fixed order and nothing is atomic, so repeat launches
// are bit-identical.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// ops/transport_simplex_mega.py::_STATIC_SMEM
constexpr int kStaticSmem = 1024;

struct Pivot {            // one pivot's scalars, set by warp 0
  float theta, m_enter, row_shift;
  int cl, dep_cl, on_x, e_same, e_other, li, lj;
};

struct Scratch {          // static shared memory
  int2 part;              // this rank's pricing (dmin bits, flat)
  float f[kWarps];
  int i[kWarps];
  float fb;
  int ib;
  Pivot pv;
};
static_assert(sizeof(Scratch) <= kStaticSmem, "static shared memory");

struct Args {
  const float* M;                 // (B, S, D)
  const unsigned char* N_in;      // (B, V, V) bool
  const unsigned char* mask_in;   // (B, S, D) bool
  const int* parent_in;
  const int* dep_in;
  const float* w_in;
  const float* Xv_in;
  uint32_t* N_glob;               // (B, V, ceil(V/32)) where N is global
  uint32_t* mask_glob;            // (B, S, ceil(D/32)) where the mask is
  unsigned char* mask_out;
  int* parent_out;
  float* Xv_out;
  float* w_out;
  float* pot_out;
  int* stats;
  int S, D, C, n_smem, mask_smem;
  float tol;
  int max_pivots, refresh;
};

struct Inst {
  int S, D, V, WN, WD, C;
  int m0, m1, n0, n1;       // this rank's rows of M and of N
  bool n_smem;
  const float* M;           // this instance's costs
  uint32_t* Nrow0;          // row n0 of this rank's N slice
  uint32_t* Brow0;          // row m0 of this rank's mask slice
  uint32_t* Ninst;          // this instance's N in global memory
  uint32_t* ax;
  uint32_t* ay;
  float *w, *w2, *Xv, *Xv2, *pot;
  short *parent, *parent2, *dep, *child, *nad;
};

// Rank q's first row of n rows split over C ranks, and the owner of row t.
__device__ __forceinline__ int lo_row(int q, int n, int C) {
  return (int)((long long)q * n / C);
}
__device__ __forceinline__ int owner(int t, int n, int C) {
  return (int)(((long long)(t + 1) * C - 1) / n);
}

__device__ __forceinline__ bool bit(const uint32_t* row, int k) {
  return (row[k >> 5] >> (k & 31)) & 1u;
}

// The bits of word w that stand for row nodes (ids < S).
__device__ __forceinline__ uint32_t row_nodes(int w, int S) {
  const int k0 = w * 32;
  if (k0 + 32 <= S) return kFull;
  if (k0 >= S) return 0u;
  return (1u << (S - k0)) - 1u;
}

// Row t of N, owned by this rank: in shared memory or in global memory.
__device__ __forceinline__ uint32_t* own_row(const Inst& I, int t) {
  return I.Nrow0 + (size_t)(t - I.n0) * I.WN;
}

// Row t of N, owned by any rank of the cluster (the same layout: DSMEM or
// global memory).
__device__ __forceinline__ const uint32_t* any_row(const Inst& I,
                                                   cg::cluster_group& cl,
                                                   int t) {
  if (!I.n_smem) return I.Ninst + (size_t)t * I.WN;
  const int q = owner(t, I.V, I.C);
  const uint32_t* base = cl.map_shared_rank(I.Nrow0, (unsigned)q);
  return base + (size_t)(t - lo_row(q, I.V, I.C)) * I.WN;
}

__device__ __forceinline__ void argmin_pair(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

// Block-wide argmin of (v, i): smallest v, ties to the smallest i.  All
// threads receive the result.
__device__ void block_argmin(float& v, int& i, Scratch& sc) {
  for (int o = 16; o > 0; o >>= 1) {
    float v2 = __shfl_xor_sync(kFull, v, o);
    int i2 = __shfl_xor_sync(kFull, i, o);
    argmin_pair(v, i, v2, i2);
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) { sc.f[w] = v; sc.i[w] = i; }
  __syncthreads();
  if (w == 0) {
    v = sc.f[threadIdx.x];
    i = sc.i[threadIdx.x];
    for (int o = 16; o > 0; o >>= 1) {
      float v2 = __shfl_xor_sync(kFull, v, o);
      int i2 = __shfl_xor_sync(kFull, i, o);
      argmin_pair(v, i, v2, i2);
    }
    if (threadIdx.x == 0) { sc.fb = v; sc.ib = i; }
  }
  __syncthreads();
  v = sc.fb;
  i = sc.ib;
  __syncthreads();
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float parity(int dep) { return (dep & 1) ? -1.0f : 1.0f; }

// Packs bool rows [r0, r1) of width n into 32-bit words, W per row, row r
// at dst + (r - r0) * W; one warp per row, one ballot per word.
__device__ void pack_rows(const unsigned char* src, int n, int r0, int r1,
                          uint32_t* dst, int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const unsigned char* s = src + (size_t)r * n;
    uint32_t* d = dst + (size_t)(r - r0) * W;
    for (int w = 0; w < W; ++w) {
      const int k = w * 32 + lane;
      const unsigned word = __ballot_sync(kFull, k < n && s[k] != 0);
      if (lane == 0) d[w] = word;
    }
  }
}

// pot of this rank's rows of N, pushed into every rank's replica; one warp
// per row, lanes on words, a fixed-order warp sum.  Ends with a cluster
// barrier.
__device__ void refresh_pot(Inst& I, cg::cluster_group& cl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = I.n0 + warp; t < I.n1; t += kWarps) {
    const uint32_t* row = own_row(I, t);
    float acc = 0.0f;
    for (int w = lane; w < I.WN; w += 32) {
      for (uint32_t x = row[w]; x; x &= x - 1) {
        const int k = w * 32 + __ffs(x) - 1;
        acc = __fadd_rn(acc, parity(I.dep[k]) * I.w[k]);
      }
    }
    for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, o));
    const float p = parity(I.dep[t]) * acc;
    if (lane < I.C) cl.map_shared_rank(I.pot, (unsigned)lane)[t] = p;
  }
  cl.sync();
}

// Dantzig pricing over the whole instance: this rank's rows, then the
// cluster-wide (value, index) minimum.  Every rank returns the same pair.
__device__ void price(Inst& I, Scratch& sc, cg::cluster_group& cl,
                      float& dmin, int& flat) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = I.D;
  const float* vpot = I.pot + I.S;
  float best = CUDART_INF_F;
  int bi = INT_MAX;
  // each thread visits its cells in increasing flat order, so a strict
  // '<' keeps the lowest index among its ties
  for (int i = I.m0 + warp; i < I.m1; i += kWarps) {
    const float u = I.pot[i];
    const float* Mr = I.M + (size_t)i * D;
    const uint32_t* Br = I.Brow0 + (size_t)(i - I.m0) * I.WD;
    const int fi = i * D;
    int head = (int)((4u - (((uintptr_t)Mr >> 2) & 3u)) & 3u);
    if (head > D) head = D;
    const int nvec = (D - head) >> 2;
    const int tail = head + 4 * nvec;
#define SCX_CELL(j, m)                                                        \
    {                                                                         \
      const int jj = (j);                                                     \
      const float dl = ((Br[jj >> 5] >> (jj & 31)) & 1u)                      \
                           ? 0.0f : __fsub_rn(__fsub_rn((m), u), vpot[jj]);   \
      if (dl < best) { best = dl; bi = fi + jj; }                             \
    }
    if (lane < head) SCX_CELL(lane, __ldg(Mr + lane));
    const float4* M4 = reinterpret_cast<const float4*>(Mr + head);
    if (head == 0 && (I.S & 3) == 0) {
      // aligned rows: v and the mask word come in one load per 4 cells
      // (v[j..j+3] is 16-byte aligned and j..j+3 share a mask word)
#pragma unroll 4
      for (int q = lane; q < nvec; q += 32) {
        const float4 m = __ldg(M4 + q);
        const int j = 4 * q;
        const float4 v = *reinterpret_cast<const float4*>(vpot + j);
        const uint32_t bw = Br[j >> 5] >> (j & 31);
        const float d0 = (bw & 1u) ? 0.0f : __fsub_rn(__fsub_rn(m.x, u), v.x);
        const float d1 = (bw & 2u) ? 0.0f : __fsub_rn(__fsub_rn(m.y, u), v.y);
        const float d2 = (bw & 4u) ? 0.0f : __fsub_rn(__fsub_rn(m.z, u), v.z);
        const float d3 = (bw & 8u) ? 0.0f : __fsub_rn(__fsub_rn(m.w, u), v.w);
        if (d0 < best) { best = d0; bi = fi + j; }
        if (d1 < best) { best = d1; bi = fi + j + 1; }
        if (d2 < best) { best = d2; bi = fi + j + 2; }
        if (d3 < best) { best = d3; bi = fi + j + 3; }
      }
    } else {
#pragma unroll 4
      for (int q = lane; q < nvec; q += 32) {
        const float4 m = __ldg(M4 + q);
        const int j = head + 4 * q;
        SCX_CELL(j, m.x);
        SCX_CELL(j + 1, m.y);
        SCX_CELL(j + 2, m.z);
        SCX_CELL(j + 3, m.w);
      }
    }
    if (tail + lane < D) SCX_CELL(tail + lane, __ldg(Mr + tail + lane));
#undef SCX_CELL
  }
  block_argmin(best, bi, sc);
  if (threadIdx.x == 0) sc.part = make_int2(__float_as_int(best), bi);
  cl.sync();                                   // barrier 1
  dmin = CUDART_INF_F;
  flat = INT_MAX;
  for (int q = 0; q < I.C; ++q) {
    const int2 r = *cl.map_shared_rank(&sc.part, (unsigned)q);
    argmin_pair(dmin, flat, __int_as_float(r.x), r.y);
  }
}

__device__ __forceinline__ float sign_of(const Inst& I, int k) {
  const bool x = bit(I.ax, k), y = bit(I.ay, k);
  if (x == y) return 0.0f;
  return (x == (k < I.S)) ? -1.0f : 1.0f;
}

// The decreasing cycle cells of word w: on the cycle and keyed by a row
// node on x's branch or by a column node on y's branch.
__device__ __forceinline__ uint32_t dec_word(const Inst& I, int w) {
  return (I.ax[w] ^ I.ay[w]) & ~(I.ax[w] ^ row_nodes(w, I.S));
}

// One pivot on the entering cell flat = ei * D + ej with reduced cost dmin.
__device__ void pivot(Inst& I, Scratch& sc, cg::cluster_group& cl,
                      float dmin, int flat) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = I.S, V = I.V, WN = I.WN;
  const int ei = flat / I.D, ej = flat - ei * I.D;
  const int x_end = ei, y_end = S + ej;

  // the cycle: root-path rows of both endpoints, from their owners
  {
    const uint32_t* rx = any_row(I, cl, x_end);
    const uint32_t* ry = any_row(I, cl, y_end);
    for (int w = tid; w < 2 * WN; w += kThreads) {
      if (w < WN) I.ax[w] = rx[w];
      else I.ay[w - WN] = ry[w - WN];
    }
  }
  __syncthreads();

  // ratio test over the cycle's decreasing cells, by warp 0
  if (warp == 0) {
    float r = CUDART_INF_F;
    for (int w = lane; w < WN; w += 32)
      for (uint32_t x = dec_word(I, w); x; x &= x - 1)
        r = fminf(r, I.Xv[w * 32 + __ffs(x) - 1]);
    for (int o = 16; o > 0; o >>= 1) r = fminf(r, __shfl_xor_sync(kFull, r, o));
    const float theta = r;
    const float thr = theta + 1e-12f;
    int c = V;
    for (int w = lane; w < WN && c == V; w += 32) {
      for (uint32_t x = dec_word(I, w); x; x &= x - 1) {
        const int k = w * 32 + __ffs(x) - 1;
        if (I.Xv[k] <= thr) { c = k; break; }
      }
    }
    for (int o = 16; o > 0; o >>= 1) c = min(c, __shfl_xor_sync(kFull, c, o));
    if (lane == 0) {
      Pivot& p = sc.pv;
      const bool on_x = bit(I.ax, c);
      const int p_cl = I.parent[c];
      p.theta = theta;
      p.cl = c;
      p.dep_cl = I.dep[c];
      p.on_x = on_x ? 1 : 0;
      p.e_same = on_x ? x_end : y_end;
      p.e_other = on_x ? y_end : x_end;
      p.li = c < S ? c : p_cl;
      p.lj = c < S ? p_cl - S : c - S;
      p.m_enter = I.M[(size_t)ei * I.D + ej];
      p.row_shift = on_x ? dmin : -dmin;
    }
  }
  __syncthreads();
  const Pivot pv = sc.pv;
  const uint32_t* nes = pv.on_x ? I.ax : I.ay;
  const uint32_t* neo = pv.on_x ? I.ay : I.ax;

  // the path e_same..cl reverses: each path node below cl hands its (Xv,
  // w) to its old parent (targets are distinct on a path); and the table
  // of e_same's root path by depth
  for (int w = tid; w < WN; w += kThreads) {
    for (uint32_t x = nes[w]; x; x &= x - 1) {
      const int k = w * 32 + __ffs(x) - 1;
      const int dk = I.dep[k];
      I.nad[dk] = (short)k;
      if (dk >= pv.dep_cl && k != pv.cl) I.child[I.parent[k]] = (short)k;
    }
  }
  __syncthreads();

  // per-node re-key and parent reversal, into the second buffers
  for (int t = tid; t < V; t += kThreads) {
    const int ch = I.child[t];
    const bool hit = ch >= 0;
    const int k = hit ? ch : t;
    float xv = __fadd_rn(I.Xv[k], sign_of(I, k) * pv.theta);
    float wt = I.w[k];
    const bool seg_hit = hit && bit(nes, t) && I.dep[t] >= pv.dep_cl;
    int pt = seg_hit ? ch : I.parent[t];
    if (t == pv.e_same) { xv = pv.theta; wt = pv.m_enter; pt = pv.e_other; }
    I.Xv2[t] = xv;
    I.w2[t] = wt;
    I.parent2[t] = (short)pt;
    if (hit) I.child[t] = -1;
  }
  if (tid == 0) {
    if (ei >= I.m0 && ei < I.m1)
      I.Brow0[(size_t)(ei - I.m0) * I.WD + (ej >> 5)] |= 1u << (ej & 31);
    if (pv.li >= I.m0 && pv.li < I.m1)
      I.Brow0[(size_t)(pv.li - I.m0) * I.WD + (pv.lj >> 5)] &= ~(1u << (pv.lj & 31));
  }
  cl.sync();                 // barrier 2: every rank has read the cycle rows
  short* ts = I.parent; I.parent = I.parent2; I.parent2 = ts;
  float* tf = I.Xv; I.Xv = I.Xv2; I.Xv2 = tf;
  tf = I.w; I.w = I.w2; I.w2 = tf;

  // this rank's N rows of the re-hung subtree {t : N[t, cl]}, one warp per
  // row: N'[t] = (N[t] ^ nes) | lca_bit | neo; the new dep and the shifted
  // pot go to every rank
  for (int t = I.n0 + warp; t < I.n1; t += kWarps) {
    uint32_t* row = own_row(I, t);
    if (!bit(row, pv.cl)) continue;
    int cnt = 0;
    for (int w = lane; w < WN; w += 32) cnt += __popc(row[w] & nes[w]);
    cnt = warp_sum(cnt);
    const int lca = I.nad[cnt - 1];
    int nd = 0;
    for (int w = lane; w < WN; w += 32) {
      uint32_t x = (row[w] ^ nes[w]) | neo[w];
      if (w == (lca >> 5)) x |= 1u << (lca & 31);
      row[w] = x;
      nd += __popc(x);
    }
    nd = warp_sum(nd);
    const float p = __fadd_rn(I.pot[t], t < S ? pv.row_shift : -pv.row_shift);
    __syncwarp();
    if (lane < I.C) {
      cl.map_shared_rank(I.dep, (unsigned)lane)[t] = (short)(nd - 1);
      cl.map_shared_rank(I.pot, (unsigned)lane)[t] = p;
    }
  }
  cl.sync();                 // barrier 3: dep and pot are whole again
}

__global__ void __launch_bounds__(kThreads, 1) mega_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch sc;
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x;
  const int C = a.C;
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / C;
  const int S = a.S, D = a.D, V = S + D;

  Inst I;
  I.S = S; I.D = D; I.V = V; I.C = C;
  I.WN = (V + 31) / 32;
  I.WD = (D + 31) / 32;
  I.m0 = lo_row(rank, S, C); I.m1 = lo_row(rank + 1, S, C);
  I.n0 = lo_row(rank, V, C); I.n1 = lo_row(rank + 1, V, C);
  I.n_smem = a.n_smem != 0;
  I.M = a.M + (size_t)b * S * D;
  I.Ninst = a.N_glob + (size_t)b * V * I.WN;
  uint32_t* up = reinterpret_cast<uint32_t*>(smem);
  I.ax = up; I.ay = up + I.WN; up += 2 * I.WN;
  if (a.mask_smem) {
    I.Brow0 = up;
    up += (size_t)((S + C - 1) / C) * I.WD;
  } else {
    I.Brow0 = a.mask_glob + ((size_t)b * S + I.m0) * I.WD;
  }
  if (I.n_smem) {
    I.Nrow0 = up;
    up += (size_t)((V + C - 1) / C) * I.WN;
  } else {
    I.Nrow0 = I.Ninst + (size_t)I.n0 * I.WN;
  }
  // the float vectors start 16-byte aligned (pricing reads v as float4)
  const size_t words = (size_t)(up - reinterpret_cast<uint32_t*>(smem));
  float* fp = reinterpret_cast<float*>(smem) + (words + 3) / 4 * 4;
  I.w = fp; I.w2 = fp + V; I.Xv = fp + 2 * V; I.Xv2 = fp + 3 * V; I.pot = fp + 4 * V;
  short* sp = reinterpret_cast<short*>(fp + 5 * V);
  I.parent = sp; I.parent2 = sp + V; I.dep = sp + 2 * V; I.child = sp + 3 * V;
  I.nad = sp + 4 * V;

  pack_rows(a.N_in + (size_t)b * V * V, V, I.n0, I.n1, I.Nrow0, I.WN);
  pack_rows(a.mask_in + (size_t)b * S * D, D, I.m0, I.m1, I.Brow0, I.WD);
  for (int k = tid; k < V; k += kThreads) {
    I.parent[k] = (short)a.parent_in[(size_t)b * V + k];
    I.dep[k] = (short)a.dep_in[(size_t)b * V + k];
    I.w[k] = a.w_in[(size_t)b * V + k];
    I.Xv[k] = a.Xv_in[(size_t)b * V + k];
    I.pot[k] = 0.0f;
    I.child[k] = -1;
  }
  cl.sync();                 // every block of the cluster runs and is set up

  // Loop structure of the TPU kernel: refresh, price; if not optimal, run
  // up to `refresh` pivots, stopping early where the drifted pricing finds
  // nothing to enter; the refreshed check alone decides optimality.
  int it = 0;
  bool optimal = false;
  while (it < a.max_pivots) {
    refresh_pot(I, cl);
    float dmin;
    int flat;
    price(I, sc, cl, dmin, flat);
    if (dmin >= -a.tol) { optimal = true; break; }
    const int start = it;
    while (true) {
      pivot(I, sc, cl, dmin, flat);
      ++it;
      if (it >= start + a.refresh || it >= a.max_pivots) break;
      price(I, sc, cl, dmin, flat);
      if (dmin >= -a.tol) break;
    }
  }
  refresh_pot(I, cl);        // its barrier ends all DSMEM traffic

  if (rank == 0) {
    for (int k = tid; k < V; k += kThreads) {
      a.parent_out[(size_t)b * V + k] = I.parent[k];
      a.Xv_out[(size_t)b * V + k] = I.Xv[k];
      a.w_out[(size_t)b * V + k] = I.w[k];
      a.pot_out[(size_t)b * V + k] = I.pot[k];
    }
    if (tid == 0) {
      a.stats[2 * b] = it;
      a.stats[2 * b + 1] = optimal ? 1 : 0;
    }
  }
  unsigned char* mo = a.mask_out + (size_t)b * S * D + (size_t)I.m0 * D;
  const int cells = (I.m1 - I.m0) * D;
  for (int f = tid; f < cells; f += kThreads) {
    const int i = f / D, j = f - i * D;
    mo[f] = bit(I.Brow0 + (size_t)i * I.WD, j) ? 1 : 0;
  }
}

// Bytes of dynamic shared memory of one block
// (ops/transport_simplex_mega.py::mega_smem_bytes).
size_t mega_smem_bytes(int S, int D, int C, int n_smem, int mask_smem) {
  const size_t V = (size_t)S + D, WN = (V + 31) / 32, WD = ((size_t)D + 31) / 32;
  size_t words = 2 * WN;
  if (mask_smem) words += (((size_t)S + C - 1) / C) * WD;
  if (n_smem) words += ((V + C - 1) / C) * WN;
  const size_t b = (words + 3) / 4 * 16 + 4 * 5 * V + 2 * 5 * V;
  return (b + 15) / 16 * 16;
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

extern "C" int scx_transport_simplex_mega_smem_bytes(int S, int D, int C, int n_smem,
                                                     int mask_smem) {
  return (int)mega_smem_bytes(S, D, C, n_smem, mask_smem);
}

// How many clusters of this launch the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int scx_transport_simplex_mega_max_clusters(int B, int S, int D, int C,
                                                       int n_smem, int mask_smem) {
  const size_t smem = mega_smem_bytes(S, D, C, n_smem, mask_smem);
  cudaError_t e = cudaFuncSetAttribute(mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(B, C, smem, nullptr, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)mega_kernel, &cfg);
  return e != cudaSuccess ? -(int)e : n;
}

// Launches one cluster of C blocks per instance on `stream`.  N_in /
// mask_in are read only; N_glob / mask_glob are scratch where N / the mask
// do not live in shared memory (n_smem / mask_smem 0).  Returns
// cudaGetLastError() (or the error of the shared-memory opt-in or launch).
extern "C" int scx_transport_simplex_mega(
    const float* M, const unsigned char* N_in, const unsigned char* mask_in,
    const int* parent_in, const int* dep_in, const float* w_in, const float* Xv_in,
    uint32_t* N_glob, uint32_t* mask_glob, unsigned char* mask_out, int* parent_out,
    float* Xv_out, float* w_out, float* pot_out, int* stats, int B, int S, int D,
    int C, int n_smem, int mask_smem, float tol, int max_pivots, int refresh,
    void* stream_ptr) {
  const Args a = {M, N_in, mask_in, parent_in, dep_in, w_in, Xv_in, N_glob, mask_glob,
                  mask_out, parent_out, Xv_out, w_out, pot_out, stats, S, D, C, n_smem,
                  mask_smem, tol, max_pivots, refresh};
  const size_t smem = mega_smem_bytes(S, D, C, n_smem, mask_smem);
  cudaError_t e = cudaFuncSetAttribute(mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(B, C, smem, static_cast<cudaStream_t>(stream_ptr),
                                         &attr);
  e = cudaLaunchKernelEx(&cfg, mega_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
