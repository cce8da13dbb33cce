// Warm-startable primal network simplex — native core.
//
// Same algorithm as the numpy implementation in
// smart_crossover_tpu/solvers/network_simplex.py (which doubles as its test
// oracle), with the classic efficiency upgrades: altering-candidate-list
// pricing (a block-scan major refill plus cheap minor re-pricing of a short
// hot list), stamped alternating cycle walks (no depth maintenance), and
// min-side constant-delta potential shifts chosen via maintained subtree
// sizes — the complement is shifted by -delta when the cut component is the
// larger side, which leaves all reduced costs unchanged.
//
// C ABI (ctypes):
//   scx_network_simplex(...) -> status  0=OPTIMAL 1=INFEASIBLE 2=UNBOUNDED
//                                       3=ITER_LIMIT 4=ERROR
#include <cstdint>
#include <cmath>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

using i64 = int64_t;
using i32 = int32_t;

constexpr double INF = std::numeric_limits<double>::infinity();

enum Status : int8_t { BASIC = 0, AT_LOWER = -1, AT_UPPER = -2 };

struct Solver {
  i64 m, n, ntot;
  i32 root;
  double tol;
  std::vector<i64> tails, heads;
  std::vector<double> cost, cap, b;
  std::vector<double> x;
  std::vector<int8_t> st;
  // tree
  std::vector<i64> parent, parent_arc;
  std::vector<i64> sz;           // subtree sizes (for min-side updates)
  std::vector<i64> stamp, ppos;  // per-pivot cycle-walk visit marks
  std::vector<int8_t> pside;
  std::vector<double> y;
  // children adjacency as first-child / next-sibling
  std::vector<i64> first_child, next_sib, prev_sib;  // node lists

  void child_link(i64 p, i64 c) {
    next_sib[c] = first_child[p];
    prev_sib[c] = -1;
    if (first_child[p] >= 0) prev_sib[first_child[p]] = c;
    first_child[p] = c;
  }
  void child_unlink(i64 p, i64 c) {
    if (prev_sib[c] >= 0) next_sib[prev_sib[c]] = next_sib[c];
    else first_child[p] = next_sib[c];
    if (next_sib[c] >= 0) prev_sib[next_sib[c]] = prev_sib[c];
    next_sib[c] = prev_sib[c] = -1;
  }

  // ---- union-find for warm-start forest ----
  std::vector<i64> uf;
  i64 find(i64 a) {
    while (uf[a] != a) { uf[a] = uf[uf[a]]; a = uf[a]; }
    return a;
  }

  // Build spanning tree from st[]==BASIC arcs, complete with artificials,
  // compute tree flows; returns false if a tree arc violates its bounds.
  bool rebuild_tree() {
    uf.assign(m, 0);
    for (i64 v = 0; v < m; ++v) uf[v] = v;
    std::vector<std::vector<std::pair<i64, i64>>> adj(m);  // (nbr, arc)
    for (i64 a = 0; a < ntot; ++a) {
      if (st[a] != BASIC) continue;
      i64 t = tails[a], h = heads[a];
      i64 rt = find(t), rh = find(h);
      if (rt == rh) { st[a] = AT_LOWER; x[a] = 0.0; continue; }
      uf[rt] = rh;
      adj[t].push_back({h, a});
      adj[h].push_back({t, a});
    }
    i64 rroot = find(root);
    for (i64 v = 0; v < m; ++v) {
      if (find(v) != rroot) {
        i64 a = n + 2 * v;  // v -> root artificial
        st[a] = BASIC;
        uf[find(v)] = rroot;
        adj[v].push_back({root, a});
        adj[root].push_back({v, a});
      }
    }
    // BFS from root
    std::vector<i64> order;
    order.reserve(m);
    std::vector<char> seen(m, 0);
    parent.assign(m, -1);
    parent_arc.assign(m, -1);
    std::fill(first_child.begin(), first_child.end(), -1);
    std::fill(next_sib.begin(), next_sib.end(), -1);
    std::fill(prev_sib.begin(), prev_sib.end(), -1);
    order.push_back(root);
    seen[root] = 1;
    for (size_t qi = 0; qi < order.size(); ++qi) {
      i64 v = order[qi];
      for (auto [w, a] : adj[v]) {
        if (!seen[w]) {
          seen[w] = 1;
          parent[w] = v;
          parent_arc[w] = a;
          child_link(v, w);
          order.push_back(w);
        }
      }
    }
    if ((i64)order.size() != m) return false;  // should not happen

    // residuals r = b - N x_nonbasic
    std::vector<double> r(b.begin(), b.end());
    for (i64 a = 0; a < n; ++a) {
      if (st[a] == AT_UPPER) {
        r[tails[a]] += x[a];
        r[heads[a]] -= x[a];
      }
    }
    // reverse-BFS accumulation
    bool ok = true;
    for (i64 idx = m - 1; idx >= 1; --idx) {
      i64 v = order[idx];
      i64 p = parent[v];
      i64 a = parent_arc[v];
      if (heads[a] == v) x[a] = r[v];
      else x[a] = -r[v];
      r[p] += r[v];
    }
    // flip negative artificials to the opposite orientation
    for (i64 v = 0; v < m; ++v) {
      if (v == root) continue;
      i64 a = parent_arc[v];
      if (a >= n && x[a] < 0) {
        i64 base = (a - n) / 2;
        i64 other = n + 2 * base + (1 - (a - n) % 2);
        double xa = -x[a];
        st[a] = AT_LOWER;
        x[a] = 0.0;
        st[other] = BASIC;
        x[other] = xa;
        parent_arc[v] = other;
        a = other;
      }
      if (x[a] < -tol || x[a] > cap[a] + tol) ok = false;
    }
    return ok;
  }

  void repair_infeasible() {
    for (i64 round = 0; round < m + n; ++round) {
      bool bad = false;
      for (i64 v = 0; v < m; ++v) {
        if (v == root) continue;
        i64 a = parent_arc[v];
        if (a < n && (x[a] < -tol || x[a] > cap[a] + tol)) {
          if (x[a] > cap[a] + tol) { st[a] = AT_UPPER; x[a] = cap[a]; }
          else { st[a] = AT_LOWER; x[a] = 0.0; }
          bad = true;
        }
      }
      if (!bad) return;
      if (rebuild_tree()) return;
    }
  }

  void compute_potentials() {
    // preorder from root via children lists, then reverse-accumulate sizes
    y[root] = 0.0;
    std::vector<i64> order;
    order.reserve(m);
    order.push_back(root);
    for (size_t qi = 0; qi < order.size(); ++qi) {
      i64 v = order[qi];
      for (i64 c = first_child[v]; c >= 0; c = next_sib[c]) {
        i64 a = parent_arc[c];
        y[c] = (heads[a] == c) ? y[v] + cost[a] : y[v] - cost[a];
        order.push_back(c);
      }
    }
    sz.assign(m, 1);
    for (i64 idx = (i64)order.size() - 1; idx >= 1; --idx)
      sz[parent[order[idx]]] += sz[order[idx]];
  }

  int run(i64 max_iter, i64 *iters_out) {
    i64 it = 0;
    i64 degen_run = 0;
    i64 block_start = 0;
    // altering candidate list (LEMON-style): a major scan gathers up to
    // `block` violating arcs, keeps the `head_len` strongest; minor
    // iterations re-price only that short list until it runs dry.  The
    // large pool / small head split was tuned on 240k-arc transshipment
    // runs (pivot counts drop ~3x vs small blocks) without hurting dense
    // OT instances; override with SCX_NS_BLOCK / SCX_NS_HEAD.
    i64 block = std::max<i64>(64, (i64)(std::sqrt((double)ntot) * 32));
    if (const char *bs = std::getenv("SCX_NS_BLOCK"))
      if (i64 v = std::atoll(bs); v > 0) block = v;
    i64 head_len = std::max<i64>(16, block / 32);
    if (const char *hs = std::getenv("SCX_NS_HEAD"))
      if (i64 v = std::atoll(hs); v > 0) head_len = v;
    std::vector<i64> cand;
    std::vector<std::pair<double, i64>> candp;
    cand.reserve((size_t)block);
    candp.reserve((size_t)block);
    int result = 0;  // OPTIMAL
    std::vector<i64> cyc_arcs;
    std::vector<int> cyc_dir;
    std::vector<i64> tpath, hpath, stack, rev;
    cyc_arcs.reserve(256);
    cyc_dir.reserve(256);
    stack.reserve(256);
    rev.reserve(256);
    stamp.assign(m, -1);
    ppos.assign(m, 0);
    pside.assign(m, 0);

    auto viol = [&](i64 a) -> double {
      double rc = cost[a] - y[heads[a]] + y[tails[a]];
      if (st[a] == AT_LOWER && rc < -tol) return -rc;
      if (st[a] == AT_UPPER && rc > tol) return rc;
      return 0.0;
    };

    while (true) {
      if (it >= max_iter) { result = 3; break; }
      i64 e = -1;
      double best = tol;
      bool bland = degen_run > 2 * m + 50;
      if (bland) {
        for (i64 a = 0; a < ntot; ++a) {
          double rc = cost[a] - y[heads[a]] + y[tails[a]];
          if ((st[a] == AT_LOWER && rc < -tol) ||
              (st[a] == AT_UPPER && rc > tol)) { e = a; break; }
        }
      } else {
        // ---- minor: re-price the candidate list under current potentials
        size_t w = 0;
        for (size_t k = 0; k < cand.size(); ++k) {
          i64 a = cand[k];
          double v = viol(a);
          if (v > tol) {
            cand[w++] = a;
            if (v > best) { best = v; e = a; }
          }
        }
        cand.resize(w);
        if (e < 0) {
          // ---- major: block scan to refill the list
          candp.clear();
          i64 scanned = 0;
          i64 pos = block_start;
          // scan until the list is full, but cap the effort once at least
          // one candidate exists — when violations are sparse this degrades
          // gracefully toward block Dantzig instead of paying a full
          // arc-set scan per refill; an empty list keeps scanning so the
          // optimality proof stays exact
          const i64 scan_cap = 8 * block;
          while (scanned < ntot && (i64)candp.size() < block &&
                 (candp.empty() || scanned < scan_cap)) {
            i64 end = std::min(pos + block, ntot);
            for (i64 a = pos; a < end; ++a) {
              double v = viol(a);
              if (v > tol) candp.push_back({v, a});
            }
            scanned += end - pos;
            pos = (end >= ntot) ? 0 : end;
          }
          block_start = pos;
          if ((i64)candp.size() > head_len) {
            std::nth_element(candp.begin(), candp.begin() + head_len,
                             candp.end(),
                             [](const std::pair<double, i64> &pa,
                                const std::pair<double, i64> &pb) {
                               return pa.first > pb.first;
                             });
            candp.resize((size_t)head_len);
          }
          cand.clear();
          for (const auto &pr : candp) {
            cand.push_back(pr.second);
            if (pr.first > best) { best = pr.first; e = pr.second; }
          }
        }
      }
      if (e < 0) break;  // optimal
      ++it;
      int dir = (st[e] == AT_LOWER) ? 1 : -1;

      // ---- cycle via alternating stamped parent walks ----
      // Walk up from both endpoints one step at a time, marking visited
      // nodes with this pivot's stamp; the first node reached twice is the
      // cycle apex, and the first visitor's overshoot past it is trimmed
      // using the recorded path positions.  O(cycle length), no depths.
      cyc_arcs.clear();
      cyc_dir.clear();
      tpath.clear();
      hpath.clear();
      i64 apex = -1;
      {
        i64 cur[2] = {tails[e], heads[e]};
        std::vector<i64> *paths[2] = {&tpath, &hpath};
        int s = 0;
        while (apex < 0) {
          i64 v = cur[s];
          if (v < 0) { s ^= 1; continue; }
          if (stamp[v] == it) {
            apex = v;
            paths[pside[v]]->resize((size_t)ppos[v]);
            break;
          }
          stamp[v] = it;
          pside[v] = (int8_t)s;
          ppos[v] = (i64)paths[s]->size();
          paths[s]->push_back(v);
          cur[s] = parent[v];
          s ^= 1;
        }
      }
      for (i64 v : hpath) {
        i64 a = parent_arc[v];
        int d = (tails[a] == v) ? 1 : -1;
        cyc_arcs.push_back(a);
        cyc_dir.push_back(d * dir);
      }
      for (i64 v : tpath) {
        i64 a = parent_arc[v];
        int d = (heads[a] == v) ? 1 : -1;
        cyc_arcs.push_back(a);
        cyc_dir.push_back(d * dir);
      }

      // ---- ratio test ----
      double theta = std::isfinite(cap[e]) ? cap[e] : INF;
      i64 leaving = e;
      size_t leave_k = (size_t)-1;
      int8_t leave_to = (dir == 1) ? AT_UPPER : AT_LOWER;
      for (size_t k = 0; k < cyc_arcs.size(); ++k) {
        i64 a = cyc_arcs[k];
        double room = (cyc_dir[k] == 1) ? cap[a] - x[a] : x[a];
        if (room < theta - 1e-15) {
          theta = room;
          leaving = a;
          leave_k = k;
          leave_to = (cyc_dir[k] == 1) ? AT_UPPER : AT_LOWER;
        }
      }
      if (!std::isfinite(theta)) { result = 2; break; }  // UNBOUNDED
      if (theta < 0) theta = 0;
      degen_run = (theta <= tol) ? degen_run + 1 : 0;

      x[e] += dir * theta;
      for (size_t k = 0; k < cyc_arcs.size(); ++k)
        x[cyc_arcs[k]] += cyc_dir[k] * theta;

      if (leaving == e) { st[e] = leave_to; continue; }

      // ---- basis exchange ----
      st[e] = BASIC;
      st[leaving] = leave_to;
      x[leaving] = (leave_to == AT_UPPER) ? cap[leaving] : 0.0;

      i64 lt = tails[leaving], lh = heads[leaving];
      i64 child = (parent_arc[lt] == leaving) ? lt : lh;
      // the cut subtree (old subtree of `child`) contains the entering arc's
      // endpoint on the same cycle side as the leaving arc (cyc_arcs order:
      // head-side entries first, then tail-side)
      i64 et = tails[e], eh = heads[e];
      i64 join = (leave_k < hpath.size()) ? eh : et;
      i64 out_end = et + eh - join;
      i64 old_par_child = parent[child];
      i64 moved = sz[child];  // size of the cut component

      // reverse parent pointers along join -> ... -> child
      rev.clear();
      i64 prev = out_end, prev_arc = e;
      i64 v = join;
      while (true) {
        rev.push_back(v);
        i64 nxt = parent[v];
        i64 nxt_arc = parent_arc[v];
        // unlink v from old parent, link to new
        if (nxt >= 0) child_unlink(nxt, v);
        parent[v] = prev;
        parent_arc[v] = prev_arc;
        child_link(prev, v);
        if (v == child) break;
        // v's old parent becomes its child in the reversed orientation:
        prev = v;
        prev_arc = nxt_arc;
        v = nxt;
      }

      // subtree sizes: recompute along the reversed path (deepest node
      // `child` first — its off-path children kept valid sizes), then apply
      // the moved-component size along the complement's two cycle legs,
      // which meet exactly at the apex.
      for (i64 k2 = (i64)rev.size() - 1; k2 >= 0; --k2) {
        i64 w = rev[k2];
        i64 ssum = 1;
        for (i64 c = first_child[w]; c >= 0; c = next_sib[c]) ssum += sz[c];
        sz[w] = ssum;
      }
      for (i64 w = old_par_child; w != apex; w = parent[w]) sz[w] -= moved;
      for (i64 w = out_end; w != apex; w = parent[w]) sz[w] += moved;

      // potential shift: all nodes of the cut subtree move by a constant
      // delta = rc_e oriented so the entering arc's rc becomes 0.
      // Entering arc connects out_end (potential unchanged) and join (inside
      // the cut subtree); shift the whole subtree by the constant delta that
      // zeroes the entering arc's reduced cost.
      double rc_e = cost[e] - y[heads[e]] + y[tails[e]];
      double delta = (join == heads[e]) ? rc_e : -rc_e;
      // min-side potential shift: a uniform shift of all y leaves every
      // reduced cost unchanged, so instead of always adding delta over the
      // cut component (join's subtree in the NEW tree) we may equivalently
      // subtract delta over the complement — walk whichever is smaller.
      stack.clear();
      if (2 * moved <= m) {
        stack.push_back(join);
        while (!stack.empty()) {
          i64 w = stack.back();
          stack.pop_back();
          y[w] += delta;
          for (i64 c = first_child[w]; c >= 0; c = next_sib[c])
            stack.push_back(c);
        }
      } else {
        stack.push_back(root);
        while (!stack.empty()) {
          i64 w = stack.back();
          stack.pop_back();
          y[w] -= delta;
          for (i64 c = first_child[w]; c >= 0; c = next_sib[c])
            if (c != join) stack.push_back(c);
        }
      }
    }
    *iters_out = it;
    return result;
  }
};

}  // namespace

extern "C" int scx_network_simplex(
    i64 m, i64 n,
    const i64 *tails, const i64 *heads,
    const double *cost, const double *cap, const double *b,
    const i32 *warm_vbasis, i32 root,
    i64 max_iter, double tol,
    double *x_out, double *y_out, i32 *vbasis_out, i64 *iters_out) {
  Solver S;
  S.m = m;
  S.n = n;
  S.ntot = n + 2 * m;
  S.root = (root >= 0 && root < m) ? root : (i32)(m - 1);
  S.tol = tol;
  double cmax = 1.0;
  for (i64 a = 0; a < n; ++a) cmax = std::max(cmax, std::fabs(cost[a]));
  const double BIG = (cmax + 1.0) * (double)m;

  S.tails.assign(S.ntot, 0);
  S.heads.assign(S.ntot, 0);
  S.cost.assign(S.ntot, BIG);
  S.cap.assign(S.ntot, INF);
  std::memcpy(S.tails.data(), tails, n * sizeof(i64));
  std::memcpy(S.heads.data(), heads, n * sizeof(i64));
  for (i64 a = 0; a < n; ++a) { S.cost[a] = cost[a]; S.cap[a] = cap[a]; }
  for (i64 v = 0; v < m; ++v) {
    S.tails[n + 2 * v] = v;       S.heads[n + 2 * v] = S.root;
    S.tails[n + 2 * v + 1] = S.root; S.heads[n + 2 * v + 1] = v;
  }
  S.b.assign(b, b + m);
  S.x.assign(S.ntot, 0.0);
  S.st.assign(S.ntot, AT_LOWER);
  if (warm_vbasis) {
    for (i64 a = 0; a < n; ++a) {
      if (warm_vbasis[a] == 0) S.st[a] = BASIC;
      else if (warm_vbasis[a] == -2 && std::isfinite(cap[a])) {
        S.st[a] = AT_UPPER;
        S.x[a] = cap[a];
      }
    }
  }
  S.parent.assign(m, -1);
  S.parent_arc.assign(m, -1);
  S.y.assign(m, 0.0);
  S.first_child.assign(m, -1);
  S.next_sib.assign(m, -1);
  S.prev_sib.assign(m, -1);

  if (!S.rebuild_tree()) S.repair_infeasible();
  S.compute_potentials();

  i64 iters = 0;
  int result = S.run(max_iter, &iters);

  // INFEASIBLE if artificial flow remains
  if (result == 0) {
    double art = 0.0;
    for (i64 a = n; a < S.ntot; ++a) art += std::fabs(S.x[a]);
    if (art > std::max(tol * m, 1e-6)) result = 1;
  }
  std::memcpy(x_out, S.x.data(), n * sizeof(double));
  std::memcpy(y_out, S.y.data(), m * sizeof(double));
  for (i64 a = 0; a < n; ++a) {
    if (S.st[a] == BASIC) vbasis_out[a] = 0;
    else if (S.st[a] == AT_UPPER) vbasis_out[a] = -2;
    else vbasis_out[a] = -1;
  }
  *iters_out = iters;
  return result;
}
