// PDHG on a dense A for Hopper (sm_90a): one thread-block cluster of C
// blocks per LP, the rows of A held in shared memory for every iteration,
// the whole loop in one launch.  Two kernels share the layout and helpers:
// pdhg_cluster_kernel (adaptive steps) and halpern_cluster_kernel (below
// it, reflected Halpern with a fixed step).
//
// pdhg_cluster_kernel replaces two TPU kernels that run the same iteration:
//   solvers/pdhg_batched.py::_batched_pdhg_kernel (K5)  a fleet of B
//       equality LPs, `iters` iterations from x0 = clip(0, l, u), y0 = 0,
//       eta0 = 0.9 / ||A_b||, omega = 1; returns the last iterates and the
//       step-weighted averages;
//   ops/pdhg_pallas.py::_pdhg_chunk_kernel (K3)  one LP with '<' rows and
//       the primal weight omega, `chunk` iterations from a given state;
//       updates the step-weighted sums and returns the scalar state.
// One iteration (tau = eta / omega, sigma = eta * omega):
//   x_c = clip(x - tau (c - A'y), l, u),  y_c = y + sigma (b - (2 A x_c - A x)),
//   '<' rows clamped to y_c <= 0,
//   accept iff eta <= eta_bar = (omega |dx|^2 + |dy|^2 / omega) / (2 |dy.(A x_c - A x)|),
// then the PDLP step schedule with index k + 2 (k^-p as expf(-p logf(k)),
// as the Pallas bodies) and the step-weighted sums.
//
// Bound on this card: each iteration reads A twice (A'y, then A x_c).  At
// 512 x 2048 (K3) A is 4 MB and at 256 x 512 (K5) 512 KB per instance;
// streamed from L2 by one block (K5) or 64 blocks (K3), the earlier designs
// ran at 17 B per clock per SM.  Here rank q of the cluster owns rows
// split_rows(m, C)[q] (config.py::split_rows) and copies as many of them as
// fit into its shared memory once (cp.async, rows padded to np = n rounded
// up to 4 with zeros); the rest it reads from global memory (L2, about 25 B
// per clock per SM) behind the same loops.  Resident rows are read at up to
// 128 B per clock per SM.  What is left is latency: barriers, the DSMEM
// combine and the reductions (PERF.md has the per-phase clock64 split).
// ops/pdhg_cluster.py::pdhg_cluster_plan picks C and the combine.
//
// Per iteration, per rank:
//   column pass  partial (A'y)_j over the owned rows for all columns:
//                thread (q4, r) takes columns 4*q4..+3 over row group r,
//                16-byte loads, the first rows in global memory loaded
//                ahead; the groups meet in shared memory in a fixed order;
//                barrier A;
//   combine      the C partials of each column summed in rank order, then
//                x_c.  All-read: every rank reads all C partials of every
//                column through distributed shared memory (DSMEM) and
//                computes all of x_c.  Scatter: the column pass stores each
//                partial straight into the shared memory of the rank that
//                owns its column quad (rank q owns split_rows(np / 4, C)[q]);
//                after barrier A rank q sums its C local partials, clips its
//                quads and stores them into every other rank's x_c; barrier
//                A2.  x and x_c are replicated in every rank, so both give
//                every rank the same x_c;
//   row pass     (A x_c)_i of the owned rows, a warp per row, kRows rows at
//                once, then y_c, the curvature partial dy.(A x_c - A x) and
//                |dy|^2 over the owned rows and |dx|^2 over the owned column
//                quads, summed over the block in a fixed order and posted;
//                barrier B;
//   decision     every rank has received the C ranks' partials (one 16-byte
//                DSMEM store each, before barrier B); warp 0 adds them in a
//                fixed order, identical in every rank; every
//                thread takes the same accept and step decision; the accept
//                flips which of the double-buffered x, y, A x is current (no
//                copy); the running sums of the owned column quads and rows
//                are updated in shared memory.
// y, A x and b live only in the rank that owns their rows.  Each exchange
// buffer is rewritten only after a barrier that every reader of its last
// contents has passed, so two cluster barriers per iteration suffice
// (three with the scatter combine; block barriers where C = 1).  Every sum
// runs in a fixed order, so repeated launches are bit-identical, and at a
// fixed C the residency of the rows does not change a bit of the result.
// Build with -DSCX_PDHG_STAMPS for clock64 totals per phase (rank 0 of
// instance 0, thread 0), read back by scx_pdhg_stamps (scx_halpern_stamps
// for the Halpern kernel).

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 4;          // rows a warp takes at once in the row pass
constexpr int kPrefetch = 4;      // global rows a thread loads ahead in the column pass
// ops/pdhg_cluster.py::_SCRATCH_FLOATS: the warps' partial sums (kWarps x 3),
// the cluster's totals (4) and the C ranks' partials as received (16 x 4),
// within 128 floats
constexpr int kScratch = 128;

#ifdef SCX_PDHG_STAMPS
// load, column pass, barrier A, combine and x_c, barrier A2, row pass,
// barrier B, decision, output
constexpr int kPhases = 9;
__device__ long long scx_pdhg_stamp_totals[kPhases];
// load, column pass, barrier A, combine and x_t, barrier A2 (with the x
// update behind it), row pass, block barrier, output
constexpr int kHalpernPhases = 8;
__device__ long long scx_halpern_stamp_totals[kHalpernPhases];
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
  const float* A;        // (B, m, n)
  const float* b;        // (B, m)
  const float* c;        // (B, n)
  const float* l;
  const float* u;
  const float* eq;       // (m): 1 on '=' rows; null: every row '='
  const float* opnorm;   // (B): K5's ||A_b||; null when scal_in is given
  const float* x_in;     // (n), (m), (m): K3's state; null: K5's start
  const float* y_in;
  const float* ax_in;
  const float* scal_in;  // K3: wsum, eta, omega, k, opnorm; null: K5
  float* x_out;          // (B, n)
  float* y_out;          // (B, m)
  float* ax_out;         // (m) or null
  float* xs;             // (B, n) running sums, in place (K5: the averages out)
  float* ys;             // (B, m)
  float* scal_out;       // K3: wsum, eta, omega, k, opnorm
  int m, n, C, n_res, iters, scatter;
};

// Rank q's first row of n rows split over C ranks (config.py::split_rows).
__device__ __forceinline__ int lo_row(int q, int n, int C) {
  return (int)((long long)q * n / C);
}

__device__ __forceinline__ int pad4(int v) { return (v + 3) & ~3; }

// The rank that owns column quad q4 of n4 (the largest q with lo_row(q) <= q4).
__device__ __forceinline__ int quad_owner(int q4, int n4, int C) {
  return (int)(((long long)(q4 + 1) * C + n4 - 1) / n4) - 1;
}

// Sums each of N values over the warp, the N butterflies interleaved;
// every lane gets the same sums, in the same fixed order in every warp.
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < N; ++r) v[r] += __shfl_xor_sync(kFull, v[r], o);
}

// Columns j..j+3 of a row: a 16-byte load where the row is padded and
// aligned (vec), else guarded loads with 0 past column n.
__device__ __forceinline__ float4 load4(const float* row, int j, int n, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(row + j);
  return make_float4(j < n ? row[j] : 0.0f, j + 1 < n ? row[j + 1] : 0.0f,
                     j + 2 < n ? row[j + 2] : 0.0f, j + 3 < n ? row[j + 3] : 0.0f);
}

__device__ __forceinline__ float4 fma4(float4 a, float s, float4 acc) {
  return make_float4(fmaf(a.x, s, acc.x), fmaf(a.y, s, acc.y), fmaf(a.z, s, acc.z),
                     fmaf(a.w, s, acc.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// (A v)_i of the first R of a step's rows at once by one warp, lanes on
// adjacent column quads, the rows' loads interleaved and unconditional;
// every lane gets every row's sum.  Fewer rows keep more loads in flight.
template <int R>
__device__ __forceinline__ void rows_dot(const float* (&rows)[kRows],
                                         const bool (&vec)[kRows], const float* v, int n,
                                         int n4, int lane, float (&out)[kRows]) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float4 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll(8 / R)
  for (int q = lane; q < n4; q += 32) {
    const float4 x = v4[q];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = load4(rows[r], 4 * q, n, vec[r]);
      acc[r].x = fmaf(a.x, x.x, acc[r].x);
      acc[r].y = fmaf(a.y, x.y, acc[r].y);
      acc[r].z = fmaf(a.z, x.z, acc[r].z);
      acc[r].w = fmaf(a.w, x.w, acc[r].w);
    }
  }
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = (acc[r].x + acc[r].y) + (acc[r].z + acc[r].w);
  warp_sums(s);
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = s[r];
}

// The sums of a step's rows: as many of its kRows rows as lie before the
// rank's last (they are a prefix of the step).
__device__ __forceinline__ void step_dot(int base, int nr, const float* (&rows)[kRows],
                                         const bool (&vec)[kRows], const float* v, int n,
                                         int n4, int lane, float (&out)[kRows]) {
  const int valid = (nr - base + kWarps - 1) / kWarps;
  static_assert(kRows == 4, "step_dot dispatches up to four rows");
  if (valid >= 4) rows_dot<4>(rows, vec, v, n, n4, lane, out);
  else if (valid == 3) rows_dot<3>(rows, vec, v, n, n4, lane, out);
  else if (valid == 2) rows_dot<2>(rows, vec, v, n, n4, lane, out);
  else rows_dot<1>(rows, vec, v, n, n4, lane, out);
}

// The rows li = base + kWarps * r (r < kRows) of a warp's step in the row
// pass: the first nres in shared memory (Ms, stride np), the rest in global
// memory (Ag, stride n).
__device__ __forceinline__ void step_rows(int base, int nres, bool gvec, const float* Ms,
                                          int np, const float* Ag, int n,
                                          const float* (&rows)[kRows], bool (&vec)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int li = base + kWarps * r;
    vec[r] = li < nres || gvec;
    rows[r] = li < nres ? Ms + (size_t)li * np : Ag + (size_t)li * n;
  }
}

// x_c of column j from its (A'y)_j and its c, l, u; adds dx^2 to dxx where
// the rank owns j.
__device__ __forceinline__ void clip_step(const float* x, float* xc, int j, float aty, float cj,
                                          float lj, float uj, float tau, bool own, float& dxx) {
  const float xj = x[j];
  const float v = fminf(fmaxf(xj - tau * (cj - aty), lj), uj);
  xc[j] = v;
  if (own) {
    const float dx = v - xj;
    dxx += dx * dx;
  }
}

// Posts the rank's partial A'y of column quad q4: into its own buffer
// (all-read), or into the shared memory of the quad's owner, in the slot of
// this rank (scatter).
__device__ __forceinline__ void post_partial(const cg::cluster_group& cl, float4* pcol4, int q4,
                                             float4 p, int scatter, int rank, int n4, int C,
                                             int cq) {
  if (!scatter) {
    pcol4[q4] = p;
    return;
  }
  const int o = quad_owner(q4, n4, C);
  cl.map_shared_rank(pcol4, (unsigned)o)[rank * cq + q4 - lo_row(o, n4, C)] = p;
}

__device__ __forceinline__ float lane_of(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// GVEC: every row of A starts 16-byte aligned (n a multiple of 4, A
// aligned), so rows in global memory load 16 bytes at a time too.
template <bool GVEC>
__global__ void __launch_bounds__(kThreads, 1) pdhg_cluster_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, m = a.m, n = a.n;
  const int rank = (int)cl.block_rank();
  const int inst = blockIdx.x / C;
  const int np = pad4(n), n4 = np / 4;
  const int r0 = lo_row(rank, m, C), nr = lo_row(rank + 1, m, C) - r0;
  const int nres = nr < a.n_res ? nr : a.n_res;
  const int rp = pad4((m + C - 1) / C);
  // the rank's column slice: quads split_rows(n4, C)[rank]
  const int q0 = lo_row(rank, n4, C), q1 = lo_row(rank + 1, n4, C);
  const int c0 = 4 * q0, c1 = 4 * q1 < n ? 4 * q1 : n;
  const int cp = 4 * ((n4 + C - 1) / C);
  // column pass: thread (q4, r) = (tid % n4, tid / n4), G row groups
  const int G = n4 >= kThreads ? 1 : kThreads / n4;
  const int r_own = n4 >= kThreads ? 0 : tid / n4;

  // dynamic shared memory (ops/pdhg_cluster.py::pdhg_cluster_smem_bytes)
  float* Ms = smem;                               // n_res rows of np
  float* xb = Ms + (size_t)a.n_res * np;          // x, x_c: 2 x np, replicated
  // this rank's partial A'y (all-read, np floats), or the C ranks'
  // partials of this rank's column quads (scatter, C x cp floats)
  float* pcol = xb + 2 * np;
  float* red = pcol + C * cp;                     // row-group partials
  float* xsl = red + (G > 1 ? G * np : 0);        // running sum of the column slice
  float* yb = xsl + cp;                           // y, y_c of the owned rows
  float* axb = yb + 2 * rp;                       // A x, A x_c
  float* bv = axb + 2 * rp;                       // b
  float* eqv = bv + rp;                           // 1 on '=' rows
  float* ysl = eqv + rp;                          // running sum of the owned rows
  float* sred = ysl + rp;                         // kWarps x 3
  float* sdec = sred + 3 * kWarps;                // the cluster's totals (3)
  float4* inbox4 = reinterpret_cast<float4*>(sdec + 4);   // the ranks' partials
  float4* pcol4 = reinterpret_cast<float4*>(pcol);
  float4* xb4 = reinterpret_cast<float4*>(xb);
  const int cq = cp / 4;                          // quads of a column slice
  float4* red4 = reinterpret_cast<float4*>(red);

  const float* Ag = a.A + ((size_t)inst * m + r0) * n;   // this rank's rows
  const float* cv = a.c + (size_t)inst * n;
  const float* lv = a.l + (size_t)inst * n;
  const float* uv = a.u + (size_t)inst * n;
  float* xs = a.xs + (size_t)inst * n;
  float* ys = a.ys + (size_t)inst * m + r0;
  constexpr bool gvec = GVEC;
  const bool k5 = a.scal_in == nullptr;

#ifdef SCX_PDHG_STAMPS
  long long st[kPhases] = {};
  long long t_last = clock64();
#endif

  // the resident rows, once, padded to np with zeros
  if (gvec) {
    const size_t q4s = (size_t)nres * n4;
    for (size_t k = tid; k < q4s; k += kThreads)
      __pipeline_memcpy_async(Ms + 4 * k, Ag + 4 * k, 16);
  } else {
    for (int li = warp; li < nres; li += kWarps)
      for (int j = lane; j < np; j += 32) {
        if (j < n) __pipeline_memcpy_async(Ms + (size_t)li * np + j, Ag + (size_t)li * n + j, 4);
        else Ms[(size_t)li * np + j] = 0.0f;
      }
  }
  __pipeline_commit();
  for (int j = tid; j < np; j += kThreads) {
    float x0 = 0.0f;
    if (j < n) x0 = k5 ? fminf(fmaxf(0.0f, lv[j]), uv[j]) : a.x_in[j];
    xb[j] = x0;
    xb[np + j] = 0.0f;
  }
  for (int j = c0 + tid; j < c1; j += kThreads) xsl[j - c0] = k5 ? 0.0f : xs[j];
  for (int li = tid; li < rp; li += kThreads) {
    const bool in = li < nr;
    yb[li] = in && !k5 ? a.y_in[r0 + li] : 0.0f;
    yb[rp + li] = 0.0f;
    axb[li] = in && !k5 ? a.ax_in[r0 + li] : 0.0f;
    axb[rp + li] = 0.0f;
    bv[li] = in ? a.b[(size_t)inst * m + r0 + li] : 0.0f;
    eqv[li] = in && a.eq != nullptr ? a.eq[r0 + li] : 1.0f;
    ysl[li] = in && !k5 ? ys[li] : 0.0f;
  }
  float wsum, eta, omega, k, opn;
  if (k5) {
    opn = a.opnorm[inst];
    wsum = 0.0f;
    eta = 0.9f / opn;
    omega = 1.0f;
    k = 0.0f;
  } else {
    wsum = a.scal_in[0];
    eta = a.scal_in[1];
    omega = a.scal_in[2];
    k = a.scal_in[3];
    opn = a.scal_in[4];
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  if (k5)                                   // A x0 of the owned rows
    for (int base = warp; base < nr; base += kWarps * kRows) {
      const float* rows[kRows];
      bool vec[kRows];
      float s[kRows];
      step_rows(base, nres, gvec, Ms, np, Ag, n, rows, vec);
      step_dot(base, nr, rows, vec, xb, n, n4, lane, s);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (lane == r && base + kWarps * r < nr) axb[base + kWarps * r] = s[r];
    }
  // every rank of the cluster runs before one writes into another's shared
  // memory (the scatter's column pass does so before barrier A)
  if (C > 1) cl.sync();
  else __syncthreads();
  SCX_STAMP(0);

  int cur = 0;
  for (int it = 0; it < a.iters; ++it) {
    const float tau = eta / omega, sigma = eta * omega;
    const float* x = xb + cur * np;
    float* xc = xb + (cur ^ 1) * np;
    const float* y = yb + cur * rp;
    float* yc = yb + (cur ^ 1) * rp;
    const float* ax = axb + cur * rp;
    float* axc = axb + (cur ^ 1) * rp;

    // ---- column pass: this rank's partial A'y
    if (r_own < G)
      for (int q4 = tid - r_own * n4; q4 < n4; q4 += kThreads) {
        // the loads of the group's first kPrefetch rows in global memory go
        // out before the resident rows are read; the sum still runs over
        // the rows in order
        const int lg = r_own < nres ? r_own + G * ((nres - r_own + G - 1) / G) : r_own;
        float4 pre[kPrefetch];
        if (lg < nr)
#pragma unroll
          for (int t = 0; t < kPrefetch; ++t) {
            const int li = lg + t * G < nr ? lg + t * G : nr - 1;
            pre[t] = load4(Ag + (size_t)li * n, 4 * q4, n, gvec);
          }
        float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
        for (int li = r_own; li < nres; li += G)
          p = fma4(*reinterpret_cast<const float4*>(Ms + (size_t)li * np + 4 * q4), y[li], p);
#pragma unroll
        for (int t = 0; t < kPrefetch; ++t)
          if (lg + t * G < nr) p = fma4(pre[t], y[lg + t * G], p);
#pragma unroll 4
        for (int li = lg + kPrefetch * G; li < nr; li += G)
          p = fma4(load4(Ag + (size_t)li * n, 4 * q4, n, gvec), y[li], p);
        if (G == 1) post_partial(cl, pcol4, q4, p, a.scatter, rank, n4, C, cq);
        else red4[r_own * n4 + q4] = p;
      }
    if (G > 1) {
      __syncthreads();
      for (int q4 = tid; q4 < n4; q4 += kThreads) {
        float4 p = red4[q4];
        for (int r = 1; r < G; ++r) p = add4(p, red4[r * n4 + q4]);
        post_partial(cl, pcol4, q4, p, a.scatter, rank, n4, C, cq);
      }
    }
    SCX_STAMP(1);
    if (C > 1) cl.sync();                        // A: partials posted
    else __syncthreads();
    SCX_STAMP(2);

    // ---- combine: A'y in rank order, then x_c; all-read: every quad from
    // the ranks' partials, scatter: the rank's quads from its own shared
    // memory, each then stored into the other ranks' x_c
    float p_dxx = 0.0f;
    float4* xc4 = xb4 + (cur ^ 1) * n4;
    for (int q4 = a.scatter ? q0 + tid : tid; q4 < (a.scatter ? q1 : n4); q4 += kThreads) {
      float4 s;
      if (a.scatter) {
        s = pcol4[q4 - q0];
        for (int q = 1; q < C; ++q) s = add4(s, pcol4[q * cq + q4 - q0]);
      } else {
        s = cl.map_shared_rank(pcol4, 0u)[q4];
        for (int q = 1; q < C; ++q) s = add4(s, cl.map_shared_rank(pcol4, (unsigned)q)[q4]);
      }
      const int j = 4 * q4;
      const float4 cj = load4(cv, j, n, false), lj = load4(lv, j, n, false),
                   uj = load4(uv, j, n, false);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + e < n)
          clip_step(x, xc, j + e, lane_of(s, e), lane_of(cj, e), lane_of(lj, e), lane_of(uj, e),
                    tau, j + e >= c0 && j + e < c1, p_dxx);
      if (a.scatter) {
        const float4 v = xc4[q4];
        for (int d = 1; d < C; ++d) cl.map_shared_rank(xc4, (unsigned)((rank + d) % C))[q4] = v;
      }
    }
    SCX_STAMP(3);
    if (a.scatter) {
      cl.sync();                                 // A2: x_c quads delivered
      SCX_STAMP(4);
    }
    __syncthreads();

    // ---- row pass: A x_c, then y_c and the partials of the owned rows,
    // kRows rows per warp at once; lane r finishes row r
    float p_curv = 0.0f, p_dyy = 0.0f;
    for (int base = warp; base < nr; base += kWarps * kRows) {
      const float* rows[kRows];
      bool vec[kRows];
      float s[kRows];
      step_rows(base, nres, gvec, Ms, np, Ag, n, rows, vec);
      step_dot(base, nr, rows, vec, xc, n, n4, lane, s);
      const int li = base + kWarps * lane;
      if (lane < kRows && li < nr) {
        float sr = s[0];
#pragma unroll
        for (int r = 1; r < kRows; ++r)
          if (lane == r) sr = s[r];
        const float axo = ax[li], yo = y[li];
        const float yt = yo + sigma * (bv[li] - (2.0f * sr - axo));
        const float yn = eqv[li] > 0.0f ? yt : fminf(yt, 0.0f);
        axc[li] = sr;
        yc[li] = yn;
        const float dy = yn - yo;
        p_curv += dy * (sr - axo);
        p_dyy += dy * dy;
      }
    }
    float part[3] = {p_curv, p_dxx, p_dyy};
    warp_sums(part);
    if (lane == 0) {
      sred[3 * warp + 0] = part[0];
      sred[3 * warp + 1] = part[1];
      sred[3 * warp + 2] = part[2];
    }
    __syncthreads();
    if (warp == 0) {                             // the warps' sums, in a fixed order
      float v[3] = {0.0f, 0.0f, 0.0f};
      if (lane < kWarps) {
        v[0] = sred[3 * lane + 0];
        v[1] = sred[3 * lane + 1];
        v[2] = sred[3 * lane + 2];
      }
      warp_sums(v);
      if (C > 1) {                               // lane q delivers them to rank q
        if (lane < C)
          cl.map_shared_rank(inbox4, (unsigned)lane)[rank] = make_float4(v[0], v[1], v[2], 0.0f);
      } else if (lane == 0) {                    // one rank: its sums are the totals
        sdec[0] = v[0];
        sdec[1] = v[1];
        sdec[2] = v[2];
      }
    }
    SCX_STAMP(5);
    if (C > 1) cl.sync();                        // B: scalar partials delivered
    SCX_STAMP(6);

    // ---- decision, identical in every rank: warp 0 adds the C ranks'
    // partials in a fixed order
    if (C > 1 && warp == 0) {
      float tot[3] = {0.0f, 0.0f, 0.0f};
      if (lane < C) {
        const float4 sp = inbox4[lane];
        tot[0] = sp.x;
        tot[1] = sp.y;
        tot[2] = sp.z;
      }
      warp_sums(tot);
      if (lane == 0) {
        sdec[0] = tot[0];
        sdec[1] = tot[1];
        sdec[2] = tot[2];
      }
    }
    __syncthreads();
    const float tot[3] = {sdec[0], sdec[1], sdec[2]};
    const float curv = fabsf(tot[0]);
    const float nz = omega * tot[1] + tot[2] / omega;
    const float eta_bar = curv > 0.0f ? nz / (2.0f * curv) : 1e10f / opn;
    const int accept = eta <= eta_bar;
    const float logk = logf(k + 2.0f);
    float en = fminf((1.0f - expf(-0.3f * logk)) * eta_bar, (1.0f + expf(-0.6f * logk)) * eta);
    en = fminf(fmaxf(en, 1e-10f / opn), 1e10f / opn);
    const float wt = accept ? eta : 0.0f;
    cur ^= accept;
    wsum += wt;
    eta = en;
    k += 1.0f;

    // running sums over the owned column slice and rows
    const float* xn = xb + cur * np;
    const float* yn = yb + cur * rp;
    for (int j = c0 + tid; j < c1; j += kThreads) xsl[j - c0] += wt * xn[j];
    for (int li = tid; li < nr; li += kThreads) ysl[li] += wt * yn[li];
    SCX_STAMP(7);
  }

  // ---- outputs: the owned column slice and rows
  const float* xn = xb + cur * np;
  const float safe = wsum > 0.0f ? wsum : 1.0f;
  for (int j = c0 + tid; j < c1; j += kThreads) {
    a.x_out[(size_t)inst * n + j] = xn[j];
    xs[j] = k5 ? xsl[j - c0] / safe : xsl[j - c0];
  }
  for (int li = tid; li < nr; li += kThreads) {
    a.y_out[(size_t)inst * m + r0 + li] = yb[cur * rp + li];
    if (a.ax_out != nullptr) a.ax_out[r0 + li] = axb[cur * rp + li];
    ys[li] = k5 ? ysl[li] / safe : ysl[li];
  }
  if (a.scal_out != nullptr && rank == 0 && tid == 0) {
    a.scal_out[0] = wsum;
    a.scal_out[1] = eta;
    a.scal_out[2] = omega;
    a.scal_out[3] = k;
    a.scal_out[4] = opn;
  }
  SCX_STAMP(8);
#ifdef SCX_PDHG_STAMPS
  if (inst == 0 && rank == 0 && tid == 0)
    for (int q = 0; q < kPhases; ++q) scx_pdhg_stamp_totals[q] = st[q];
#endif
  cl.sync();         // no rank leaves while another may still read its shared memory
}

// ---------------------------------------------------------------- K4
// halpern_cluster_kernel replaces ops/pdhg_pallas.py::_halpern_chunk_kernel
// (K4): `chunk` iterations of reflected-Halpern PDHG on one LP with '<'
// rows, a fixed step and the primal weight omega (tau = step / omega,
// sigma = step * omega), around anchors xa, ya, A xa that it only reads;
// with lam = (k + 1) / (k + 2):
//   x_t = clip(x - tau (c - A'y), l, u),  y_t = y + sigma (b - (2 A x_t - A x)),
//   '<' rows clamped to y_t <= 0,
//   x <- lam (2 x_t - x) + (1 - lam) xa, y and A x alike, k <- k + 1.
// It is pdhg_cluster_kernel's iteration without the step rule: no accept
// decision, no scalar reductions, no running sums.  Same rows per rank,
// residency, column pass and row pass, and the scatter combine at every C
// (forced runs on an H100 never put the all-read ahead for this kernel);
// what differs:
//   vectors  y, A x, b, the '=' flags, ya, A xa live only in the rank that
//            owns their rows, updated in place by the row pass; x, xa, c,
//            l, u of the rank's column slice only, in shared memory; x_t is
//            replicated;
//   barriers two cluster barriers per iteration, from the exchanges: A
//            (partials posted) and A2 (x_t quads delivered).  A rank pushes
//            into an owner's partial buffer only after A2, and the owner
//            read that buffer before arriving at A2; it pushes x_t into the
//            other ranks only after the next A, and they read x_t in their
//            row pass, before arriving there.  A2 is split: arrive after
//            the pushes, the x update of the owned quads, then wait.  A
//            block barrier orders y before the next column pass (block
//            barriers for A and A2 where C = 1).
// A'y is summed in rank order as in pdhg_cluster_kernel, so repeated
// launches are bit-identical and at a fixed C the residency of the rows
// does not change a bit.
struct HalpernArgs {
  const float* A;        // (m, n)
  const float* b;        // (m)
  const float* c;        // (n)
  const float* l;
  const float* u;
  const float* eq;       // (m): 1 on '=' rows
  const float* x_in;     // (n), (m), (m): the state
  const float* y_in;
  const float* ax_in;
  const float* xa;       // (n), (m), (m): the anchors
  const float* ya;
  const float* axa;
  const float* scal_in;  // omega, k, step
  float* x_out;          // (n), (m), (m)
  float* y_out;
  float* ax_out;
  float* scal_out;       // omega, k + iters, step
  int m, n, C, n_res, iters;
};

// x_t of a column quad from its x, (A'y), c, l, u (0 on padded columns,
// where all five are 0).
__device__ __forceinline__ float4 clip_step4(float4 x, float4 s, float4 c, float4 l, float4 u,
                                             float tau) {
  return make_float4(fminf(fmaxf(x.x - tau * (c.x - s.x), l.x), u.x),
                     fminf(fmaxf(x.y - tau * (c.y - s.y), l.y), u.y),
                     fminf(fmaxf(x.z - tau * (c.z - s.z), l.z), u.z),
                     fminf(fmaxf(x.w - tau * (c.w - s.w), l.w), u.w));
}

// The Halpern step of a value z with its PDHG image t and anchor za.
__device__ __forceinline__ float halpern(float lam, float t, float z, float za) {
  return lam * (2.0f * t - z) + (1.0f - lam) * za;
}

__device__ __forceinline__ float4 halpern4(float lam, float4 t, float4 z, float4 za) {
  return make_float4(halpern(lam, t.x, z.x, za.x), halpern(lam, t.y, z.y, za.y),
                     halpern(lam, t.z, z.z, za.z), halpern(lam, t.w, z.w, za.w));
}

template <bool GVEC>
__global__ void __launch_bounds__(kThreads, 1) halpern_cluster_kernel(const HalpernArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, m = a.m, n = a.n;
  const int rank = (int)cl.block_rank();
  const int np = pad4(n), n4 = np / 4;
  const int r0 = lo_row(rank, m, C), nr = lo_row(rank + 1, m, C) - r0;
  const int nres = nr < a.n_res ? nr : a.n_res;
  const int rp = pad4((m + C - 1) / C);
  // the rank's column slice: quads split_rows(n4, C)[rank]
  const int q0 = lo_row(rank, n4, C), q1 = lo_row(rank + 1, n4, C);
  const int c0 = 4 * q0, c1 = 4 * q1 < n ? 4 * q1 : n;
  const int cp = 4 * ((n4 + C - 1) / C), cq = cp / 4;
  // column pass: thread (q4, r) = (tid % n4, tid / n4), G row groups
  const int G = n4 >= kThreads ? 1 : kThreads / n4;
  const int r_own = n4 >= kThreads ? 0 : tid / n4;

  // dynamic shared memory (ops/pdhg_cluster.py::halpern_cluster_smem_bytes)
  float* Ms = smem;                                 // n_res rows of np
  float* xt = Ms + (size_t)a.n_res * np;            // x_t, replicated
  float* pcol = xt + np;                            // the C ranks' partials of
                                                    // this rank's column quads
  float* red = pcol + C * cp;                       // row-group partials
  float* xv = red + (G > 1 ? G * np : 0);           // x, xa, c, l, u of the
                                                    // rank's column slice
  float* yv = xv + 5 * cp;                          // y of the owned rows
  float* axv = yv + rp;                             // A x
  float* bv = axv + rp;                             // b
  float* eqv = bv + rp;                             // 1 on '=' rows
  float* yav = eqv + rp;                            // ya
  float* axav = yav + rp;                           // A xa
  float4* pcol4 = reinterpret_cast<float4*>(pcol);
  float4* red4 = reinterpret_cast<float4*>(red);
  float4* xt4 = reinterpret_cast<float4*>(xt);
  float4* xv4 = reinterpret_cast<float4*>(xv);

  const float* Ag = a.A + (size_t)r0 * n;           // this rank's rows
  constexpr bool gvec = GVEC;

#ifdef SCX_PDHG_STAMPS
  long long st[kHalpernPhases] = {};
  long long t_last = clock64();
#endif

  // the resident rows, once, padded to np with zeros
  if (gvec) {
    const size_t q4s = (size_t)nres * n4;
    for (size_t k = tid; k < q4s; k += kThreads)
      __pipeline_memcpy_async(Ms + 4 * k, Ag + 4 * k, 16);
  } else {
    for (int li = warp; li < nres; li += kWarps)
      for (int j = lane; j < np; j += 32) {
        if (j < n) __pipeline_memcpy_async(Ms + (size_t)li * np + j, Ag + (size_t)li * n + j, 4);
        else Ms[(size_t)li * np + j] = 0.0f;
      }
  }
  __pipeline_commit();
  for (int j = tid; j < np; j += kThreads) xt[j] = 0.0f;
  for (int t = tid; t < cp; t += kThreads) {
    const int j = c0 + t;
    const bool in = j < c1;
    xv[t] = in ? a.x_in[j] : 0.0f;
    xv[cp + t] = in ? a.xa[j] : 0.0f;
    xv[2 * cp + t] = in ? a.c[j] : 0.0f;
    xv[3 * cp + t] = in ? a.l[j] : 0.0f;
    xv[4 * cp + t] = in ? a.u[j] : 0.0f;
  }
  for (int li = tid; li < rp; li += kThreads) {
    const bool in = li < nr;
    const int i = r0 + li;
    yv[li] = in ? a.y_in[i] : 0.0f;
    axv[li] = in ? a.ax_in[i] : 0.0f;
    bv[li] = in ? a.b[i] : 0.0f;
    eqv[li] = in ? a.eq[i] : 1.0f;
    yav[li] = in ? a.ya[i] : 0.0f;
    axav[li] = in ? a.axa[i] : 0.0f;
  }
  const float omega = a.scal_in[0], step = a.scal_in[2];
  const float tau = step / omega, sigma = step * omega;
  float k = a.scal_in[1];
  __pipeline_wait_prior(0);
  // every rank of the cluster runs before one writes into another's shared
  // memory (the scatter's column pass does so before barrier A)
  if (C > 1) cl.sync();
  else __syncthreads();
  SCX_STAMP(0);

  for (int it = 0; it < a.iters; ++it) {
    const float lam = (k + 1.0f) / (k + 2.0f);

    // ---- column pass: this rank's partial A'y, pushed to the quads'
    // owners; pdhg_cluster_kernel's loop written out again: one inline
    // function for both moved that kernel's spills and time (PERF.md)
    if (r_own < G)
      for (int q4 = tid - r_own * n4; q4 < n4; q4 += kThreads) {
        const int lg = r_own < nres ? r_own + G * ((nres - r_own + G - 1) / G) : r_own;
        float4 pre[kPrefetch];
        if (lg < nr)
#pragma unroll
          for (int t = 0; t < kPrefetch; ++t) {
            const int li = lg + t * G < nr ? lg + t * G : nr - 1;
            pre[t] = load4(Ag + (size_t)li * n, 4 * q4, n, gvec);
          }
        float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
        for (int li = r_own; li < nres; li += G)
          p = fma4(*reinterpret_cast<const float4*>(Ms + (size_t)li * np + 4 * q4), yv[li], p);
#pragma unroll
        for (int t = 0; t < kPrefetch; ++t)
          if (lg + t * G < nr) p = fma4(pre[t], yv[lg + t * G], p);
#pragma unroll 4
        for (int li = lg + kPrefetch * G; li < nr; li += G)
          p = fma4(load4(Ag + (size_t)li * n, 4 * q4, n, gvec), yv[li], p);
        if (G == 1) post_partial(cl, pcol4, q4, p, 1, rank, n4, C, cq);
        else red4[r_own * n4 + q4] = p;
      }
    if (G > 1) {
      __syncthreads();
      for (int q4 = tid; q4 < n4; q4 += kThreads) {
        float4 p = red4[q4];
        for (int r = 1; r < G; ++r) p = add4(p, red4[r * n4 + q4]);
        post_partial(cl, pcol4, q4, p, 1, rank, n4, C, cq);
      }
    }
    SCX_STAMP(1);
    if (C > 1) cl.sync();                        // A: partials posted
    else __syncthreads();
    SCX_STAMP(2);

    // ---- combine: the rank's quads, A'y in rank order from its own shared
    // memory, x_t stored into every rank, then the Halpern step of x
    for (int q4 = q0 + tid; q4 < q1; q4 += kThreads) {
      const int t4 = q4 - q0;
      float4 s = pcol4[t4];
      for (int q = 1; q < C; ++q) s = add4(s, pcol4[q * cq + t4]);
      const float4 v = clip_step4(xv4[t4], s, xv4[2 * cq + t4], xv4[3 * cq + t4],
                                  xv4[4 * cq + t4], tau);
      xt4[q4] = v;
      for (int d = 1; d < C; ++d) cl.map_shared_rank(xt4, (unsigned)((rank + d) % C))[q4] = v;
    }
    SCX_STAMP(3);
    if (C > 1) cl.barrier_arrive();              // A2: x_t quads delivered
    for (int q4 = q0 + tid; q4 < q1; q4 += kThreads) {
      const int t4 = q4 - q0;
      xv4[t4] = halpern4(lam, xt4[q4], xv4[t4], xv4[cq + t4]);
    }
    if (C > 1) cl.barrier_wait();
    else __syncthreads();
    SCX_STAMP(4);

    // ---- row pass: A x_t, y_t, and the Halpern step of y and A x of the
    // owned rows, kRows rows per warp at once; lane r finishes row r
    for (int base = warp; base < nr; base += kWarps * kRows) {
      const float* rows[kRows];
      bool vec[kRows];
      float s[kRows];
      step_rows(base, nres, gvec, Ms, np, Ag, n, rows, vec);
      step_dot(base, nr, rows, vec, xt, n, n4, lane, s);
      const int li = base + kWarps * lane;
      if (lane < kRows && li < nr) {
        float sr = s[0];
#pragma unroll
        for (int r = 1; r < kRows; ++r)
          if (lane == r) sr = s[r];
        const float axo = axv[li], yo = yv[li];
        const float yt0 = yo + sigma * (bv[li] - (2.0f * sr - axo));
        const float yt = eqv[li] > 0.0f ? yt0 : fminf(yt0, 0.0f);
        yv[li] = halpern(lam, yt, yo, yav[li]);
        axv[li] = halpern(lam, sr, axo, axav[li]);
      }
    }
    SCX_STAMP(5);
    __syncthreads();                             // y before the next column pass
    k += 1.0f;
    SCX_STAMP(6);
  }

  // ---- outputs: the owned column slice and rows
  for (int j = c0 + tid; j < c1; j += kThreads) a.x_out[j] = xv[j - c0];
  for (int li = tid; li < nr; li += kThreads) {
    a.y_out[r0 + li] = yv[li];
    a.ax_out[r0 + li] = axv[li];
  }
  if (rank == 0 && tid == 0) {
    a.scal_out[0] = omega;
    a.scal_out[1] = k;
    a.scal_out[2] = step;
  }
  SCX_STAMP(7);
#ifdef SCX_PDHG_STAMPS
  if (rank == 0 && tid == 0)
    for (int q = 0; q < kHalpernPhases; ++q) scx_halpern_stamp_totals[q] = st[q];
#endif
  cl.sync();         // no rank leaves while another may still read its shared memory
}

// Bytes of dynamic shared memory of one block
// (ops/pdhg_cluster.py::pdhg_cluster_smem_bytes).
size_t smem_bytes(int m, int n, int C, int n_res) {
  const size_t np = ((size_t)n + 3) & ~(size_t)3, n4 = np / 4;
  const size_t G = n4 >= (size_t)kThreads ? 1 : kThreads / n4;
  const size_t rp = ((size_t)(m + C - 1) / C + 3) & ~(size_t)3;
  const size_t cp = 4 * ((n4 + C - 1) / C);
  const size_t floats = (size_t)n_res * np + 2 * np + C * cp + (G > 1 ? G * np : 0) + cp +
                        7 * rp + kScratch;
  return 4 * floats;
}

// Bytes of dynamic shared memory of one block of the Halpern kernel
// (ops/pdhg_cluster.py::halpern_cluster_smem_bytes).
size_t halpern_smem_bytes(int m, int n, int C, int n_res) {
  const size_t np = ((size_t)n + 3) & ~(size_t)3, n4 = np / 4;
  const size_t G = n4 >= (size_t)kThreads ? 1 : kThreads / n4;
  const size_t rp = ((size_t)(m + C - 1) / C + 3) & ~(size_t)3;
  const size_t cp = 4 * ((n4 + C - 1) / C);
  const size_t floats = (size_t)n_res * np + np + C * cp + (G > 1 ? G * np : 0) + 5 * cp +
                        6 * rp;
  return 4 * floats;
}

using Kernel = void (*)(Args);
using HalpernKernel = void (*)(HalpernArgs);

Kernel kernel_for(bool gvec) {
  return gvec ? pdhg_cluster_kernel<true> : pdhg_cluster_kernel<false>;
}

HalpernKernel halpern_kernel_for(bool gvec) {
  return gvec ? halpern_cluster_kernel<true> : halpern_cluster_kernel<false>;
}

// Lets the kernel take `smem` bytes and, above 8, a non-portable cluster.
template <class K>
cudaError_t prepare(K k, size_t smem, int C) {
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

// One cluster launch of kernel k with `smem` bytes per block on the stream;
// returns the CUDA error code.
template <class K, class A>
int launch_cluster(K k, const A& a, int B, size_t smem, void* stream_ptr) {
  cudaError_t e = prepare(k, smem, a.C);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config(B, a.C, smem, static_cast<cudaStream_t>(stream_ptr), &attr);
  e = cudaLaunchKernelEx(&cfg, k, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Rows of A in global memory load 16 bytes at a time where n is a multiple
// of 4 and A is 16-byte aligned.
bool global_vec(const float* A, int n) {
  return (n & 3) == 0 && (reinterpret_cast<uintptr_t>(A) & 15u) == 0;
}

int launch(const Args& a, int B, void* stream_ptr) {
  // the decision's inbox holds 16 ranks' partials
  if (a.C < 1 || a.C > 16) return (int)cudaErrorInvalidValue;
  return launch_cluster(kernel_for(global_vec(a.A, a.n)), a, B,
                        smem_bytes(a.m, a.n, a.C, a.n_res), stream_ptr);
}

// How many clusters of C blocks with `smem` bytes each the card can hold at
// once (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
template <class K>
int max_clusters(K k, int B, int C, size_t smem) {
  cudaError_t e = prepare(k, smem, C);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(B, C, smem, nullptr, &attr);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, (const void*)k, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return count;
}

}  // namespace

extern "C" int scx_pdhg_cluster_smem_bytes(int m, int n, int C, int n_res) {
  return (int)smem_bytes(m, n, C, n_res);
}

// How many clusters of this launch the card can hold at once, or minus the
// CUDA error.
extern "C" int scx_pdhg_cluster_max_clusters(int B, int m, int n, int C, int n_res) {
  return max_clusters(kernel_for((n & 3) == 0), B, C, smem_bytes(m, n, C, n_res));
}

extern "C" int scx_halpern_cluster_smem_bytes(int m, int n, int C, int n_res) {
  return (int)halpern_smem_bytes(m, n, C, n_res);
}

// The same for the Halpern kernel.
extern "C" int scx_halpern_cluster_max_clusters(int B, int m, int n, int C, int n_res) {
  return max_clusters(halpern_kernel_for((n & 3) == 0), B, C, halpern_smem_bytes(m, n, C, n_res));
}

// K5: `iters` iterations for each of B equality LPs from x0 = clip(0, l, u),
// y0 = 0, one cluster launch of C blocks per instance on `stream`.  A (B, m,
// n), b (B, m), c, l, u (B, n), opnorms (B); outputs x, x_avg (B, n), y,
// y_avg (B, m).  Returns the launch's CUDA error code.
extern "C" int scx_pdhg_batched(const float* A, const float* b, const float* c, const float* l,
                                const float* u, const float* opnorms, float* x, float* y,
                                float* xa, float* ya, int B, int m, int n, int iters, int C,
                                int n_res, int scatter, void* stream_ptr) {
  const Args a = {A,  b,  c,       l,  u,  nullptr, opnorms, nullptr, nullptr, nullptr, nullptr,
                  x,  y,  nullptr, xa, ya, nullptr, m,       n,       C,       n_res,   iters,
                  scatter};
  return launch(a, B, stream_ptr);
}

// K3: `chunk` iterations of one LP from the state x (n), y, ax (m); xs (n),
// ys (m) updated in place; scal_in / scal_out: [wsum, eta, omega, k,
// opnorm]; eq (m) is 1 on '=' rows.  Returns the launch's CUDA error code.
extern "C" int scx_pdhg_chunk(const float* A, const float* b, const float* c, const float* l,
                              const float* u, const float* eq, const float* x_in,
                              const float* y_in, const float* ax_in, float* xs, float* ys,
                              const float* scal_in, float* scal_out, float* x_out, float* y_out,
                              float* ax_out, int m, int n, int chunk, int C, int n_res,
                              int scatter, void* stream_ptr) {
  const Args a = {A,     b,     c,      l,  u,  eq,       nullptr, x_in, y_in, ax_in, scal_in,
                  x_out, y_out, ax_out, xs, ys, scal_out, m,       n,    C,    n_res, chunk,
                  scatter};
  return launch(a, 1, stream_ptr);
}

// K4: `chunk` Halpern iterations of one LP from the state x_in (n), y_in,
// ax_in (m) around the anchors xa (n), ya, axa (m), into x_out, y_out,
// ax_out (which must not alias the inputs); scal_in / scal_out: [omega, k,
// step]; eq (m) is 1 on '=' rows.  Returns the launch's CUDA error code.
extern "C" int scx_halpern_chunk(const float* A, const float* b, const float* c, const float* l,
                                 const float* u, const float* eq, const float* x_in,
                                 const float* y_in, const float* ax_in, const float* xa,
                                 const float* ya, const float* axa, const float* scal_in,
                                 float* scal_out, float* x_out, float* y_out, float* ax_out,
                                 int m, int n, int chunk, int C, int n_res, void* stream_ptr) {
  if (C < 1 || C > 16) return (int)cudaErrorInvalidValue;
  const HalpernArgs a = {A,       b,        c,     l,     u,      eq,       x_in, y_in,
                         ax_in,   xa,       ya,    axa,   scal_in, x_out,   y_out, ax_out,
                         scal_out, m,       n,     C,     n_res,  chunk};
  return launch_cluster(halpern_kernel_for(global_vec(A, n)), a, 1,
                        halpern_smem_bytes(m, n, C, n_res), stream_ptr);
}

#ifdef SCX_PDHG_STAMPS
// The last launch's clock64 totals per phase (rank 0 of instance 0).
extern "C" int scx_pdhg_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, scx_pdhg_stamp_totals, sizeof(long long) * kPhases);
}

// The same for the last Halpern launch (rank 0).
extern "C" int scx_halpern_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, scx_halpern_stamp_totals,
                                   sizeof(long long) * kHalpernPhases);
}
#endif
