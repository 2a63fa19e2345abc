// Native plan-builder kernels — the host-side heavy lifting of plan
// construction (CSR build, per-row column sort, symmetrize+dedup) in
// parallel C++. The analog of the reference's C++ graph/plan
// machinery (oneflow/core/graph compilation, oneflow/user/data readers):
// device compute is XLA's job, but 10^8-edge plan building is host work
// the Python layer should not do with O(n log n) single-threaded sorts.
//
// Exposed via ctypes (see of_spmm/native.py); built with
// g++ -O3 -march=native -fopenmp (see csrc/build.py). No pybind11 — the
// interfaces are flat arrays, exactly what numpy hands over.

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
static int omp_get_thread_num() { return 0; }
#endif

extern "C" {

// COO (rows, cols, vals) -> CSR (indptr, sorted cols+vals per row).
// rows/cols: int32, vals: float32. indptr must hold n+1 int64.
// out_cols/out_vals are nnz-sized. Returns 0 on success.
int coo_to_csr(int64_t n_rows, int64_t nnz, const int32_t* rows,
               const int32_t* cols, const float* vals, int64_t* indptr,
               int32_t* out_cols, float* out_vals) {
  // 1) histogram rows (parallel, per-thread local counts)
  std::memset(indptr, 0, sizeof(int64_t) * (n_rows + 1));
  int nt = omp_get_max_threads();
  std::vector<std::vector<int64_t>> local(nt);
#pragma omp parallel
  {
    int t = omp_get_thread_num();
    local[t].assign(n_rows, 0);
    auto& h = local[t];
#pragma omp for schedule(static)
    for (int64_t i = 0; i < nnz; ++i) h[rows[i]]++;
  }
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t s = 0;
    for (int t = 0; t < nt; ++t) s += local[t][r];
    indptr[r + 1] = s;
  }
  for (int64_t r = 0; r < n_rows; ++r) indptr[r + 1] += indptr[r];

  // 2) scatter into row slots (per-thread cursors from exclusive scan of
  //    local histograms so threads write disjoint ranges per row)
  std::vector<std::vector<int64_t>> cursor(nt);
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t base = indptr[r];
    for (int t = 0; t < nt; ++t) {
      int64_t c = local[t][r];
      local[t][r] = base;  // reuse as cursor
      base += c;
    }
  }
#pragma omp parallel
  {
    int t = omp_get_thread_num();
    auto& cur = local[t];
#pragma omp for schedule(static)
    for (int64_t i = 0; i < nnz; ++i) {
      int64_t p = cur[rows[i]]++;
      out_cols[p] = cols[i];
      out_vals[p] = vals ? vals[i] : 1.0f;
    }
  }

  // 3) sort within each row by column (parallel over rows)
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t lo = indptr[r], hi = indptr[r + 1];
    int64_t len = hi - lo;
    if (len <= 1) continue;
    // small rows: insertion-ish via index sort on pairs
    std::vector<std::pair<int32_t, float>> buf(len);
    for (int64_t i = 0; i < len; ++i)
      buf[i] = {out_cols[lo + i], out_vals[lo + i]};
    // stable: duplicate (row,col) entries keep input order (matches
    // numpy lexsort, which plan determinism tests rely on)
    std::stable_sort(buf.begin(), buf.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    for (int64_t i = 0; i < len; ++i) {
      out_cols[lo + i] = buf[i].first;
      out_vals[lo + i] = buf[i].second;
    }
  }
  return 0;
}

// Symmetrize + dedup a directed edge list: out = unique(E ∪ E^T), with
// self-loops preserved as given (deduped). Two-phase: call with
// out_src == nullptr to get the output count in *out_count, then call
// again with allocated buffers. Deterministic output order (sorted by
// (src, dst)). Returns 0 on success.
int symmetrize_dedup(int64_t n, int64_t nnz, const int32_t* src,
                     const int32_t* dst, int32_t* out_src, int32_t* out_dst,
                     int64_t* out_count) {
  // build keys for both directions
  std::vector<int64_t> keys(2 * nnz);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nnz; ++i) {
    keys[i] = (int64_t)src[i] * n + dst[i];
    keys[nnz + i] = (int64_t)dst[i] * n + src[i];
  }
#if defined(_OPENMP) && defined(__GLIBCXX__)
  std::sort(keys.begin(), keys.end());
#else
  std::sort(keys.begin(), keys.end());
#endif
  int64_t m = keys.empty() ? 0 : 1;
  for (int64_t i = 1; i < (int64_t)keys.size(); ++i)
    if (keys[i] != keys[i - 1]) ++m;
  *out_count = m;
  if (!out_src) return 0;
  int64_t w = 0;
  for (int64_t i = 0; i < (int64_t)keys.size(); ++i) {
    if (i == 0 || keys[i] != keys[i - 1]) {
      out_src[w] = (int32_t)(keys[i] / n);
      out_dst[w] = (int32_t)(keys[i] % n);
      ++w;
    }
  }
  return 0;
}

// Transpose a CSR pattern: (indptr, cols, vals) of A -> CSR of A^T.
// out_indptr: (n_cols+1) int64; out_cols/out_vals: nnz.
int csr_transpose(int64_t n_rows, int64_t n_cols, int64_t nnz,
                  const int64_t* indptr, const int32_t* cols,
                  const float* vals, int64_t* out_indptr, int32_t* out_cols,
                  float* out_vals) {
  std::memset(out_indptr, 0, sizeof(int64_t) * (n_cols + 1));
  for (int64_t i = 0; i < nnz; ++i) out_indptr[cols[i] + 1]++;
  for (int64_t c = 0; c < n_cols; ++c) out_indptr[c + 1] += out_indptr[c];
  std::vector<int64_t> cur(out_indptr, out_indptr + n_cols);
  for (int64_t r = 0; r < n_rows; ++r) {
    for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
      int64_t p = cur[cols[i]]++;
      out_cols[p] = (int32_t)r;  // ascending rows per column by construction
      out_vals[p] = vals ? vals[i] : 1.0f;
    }
  }
  return 0;
}

// SpGEMM C = A @ B, two-phase (count, then fill) with per-thread sparse
// accumulators (SPA: value array + row-stamp array over B's column space,
// the classic Gustavson formulation). Row-parallel; output columns sorted
// per row (deterministic). The reference has no SpGEMM at all (SURVEY.md
// §2.4) — this is new capability, host-side because output nnz is
// data-dependent (plan-time op; device math stays static-shape).
int spgemm_count(int64_t n_rows, int64_t n_cols_b, const int64_t* a_indptr,
                 const int32_t* a_cols, const int64_t* b_indptr,
                 const int32_t* b_cols, int64_t* out_counts) {
#pragma omp parallel
  {
    std::vector<int64_t> stamp(n_cols_b, -1);
#pragma omp for schedule(dynamic, 256)
    for (int64_t i = 0; i < n_rows; ++i) {
      int64_t cnt = 0;
      for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
        int32_t k = a_cols[p];
        for (int64_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
          int32_t j = b_cols[q];
          if (stamp[j] != i) {
            stamp[j] = i;
            ++cnt;
          }
        }
      }
      out_counts[i] = cnt;
    }
  }
  return 0;
}

int spgemm_fill(int64_t n_rows, int64_t n_cols_b, const int64_t* a_indptr,
                const int32_t* a_cols, const float* a_vals,
                const int64_t* b_indptr, const int32_t* b_cols,
                const float* b_vals, const int64_t* out_indptr,
                int32_t* out_cols, float* out_vals) {
#pragma omp parallel
  {
    std::vector<int64_t> stamp(n_cols_b, -1);
    std::vector<float> acc(n_cols_b, 0.0f);
    std::vector<int32_t> touched;
#pragma omp for schedule(dynamic, 256)
    for (int64_t i = 0; i < n_rows; ++i) {
      touched.clear();
      for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
        int32_t k = a_cols[p];
        float va = a_vals[p];
        for (int64_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
          int32_t j = b_cols[q];
          if (stamp[j] != i) {
            stamp[j] = i;
            acc[j] = va * b_vals[q];
            touched.push_back(j);
          } else {
            acc[j] += va * b_vals[q];
          }
        }
      }
      std::sort(touched.begin(), touched.end());
      int64_t w = out_indptr[i];
      for (int32_t j : touched) {
        out_cols[w] = j;
        out_vals[w] = acc[j];
        ++w;
      }
    }
  }
  return 0;
}

// Expansion-plan pass 1 (sparse/expansion.py): per row tile of R rows,
// sort the tile's nonzeros by column, dedup into the tile's unique column
// list, and emit per-lane (uniq rank, row-in-tile, value) in sorted order.
// Outputs are tile-concatenated; uniq_ptr has n_tiles+1 entries. uniq_cols
// must be nnz-sized (worst case: no duplicates). Parallel over tiles.
int expansion_pass1(int64_t n_rows, int64_t nnz, const int64_t* indptr,
                    const int32_t* cols, const float* vals, int64_t R,
                    int32_t* lane_inv, int32_t* lane_row, float* lane_val,
                    int32_t* uniq_cols, int64_t* uniq_ptr) {
  (void)nnz;
  int64_t n_tiles = (n_rows + R - 1) / R;
  if (n_tiles < 1) n_tiles = 1;
  std::vector<int64_t> uniq_cnt(n_tiles, 0);
#pragma omp parallel
  {
    std::vector<std::pair<int32_t, int32_t>> buf;  // (col, lane-in-tile)
#pragma omp for schedule(dynamic, 1)
    for (int64_t t = 0; t < n_tiles; ++t) {
      int64_t r0 = t * R;
      int64_t r1 = std::min(r0 + R, n_rows);
      int64_t lo = indptr[r0], hi = indptr[r1];
      int64_t m = hi - lo;
      buf.resize(m);
      for (int64_t r = r0; r < r1; ++r) {
        for (int64_t e = indptr[r]; e < indptr[r + 1]; ++e) {
          buf[e - lo] = {cols[e], (int32_t)(e - lo)};
        }
      }
      std::stable_sort(buf.begin(), buf.end(),
                       [](const auto& a, const auto& b) {
                         return a.first < b.first;
                       });
      // rows-in-tile per original lane position
      int64_t u = -1;
      int32_t prev = -1;
      for (int64_t i = 0; i < m; ++i) {
        int64_t orig = lo + buf[i].second;
        // recover the row of the original lane by binary search on indptr
        // segment [r0, r1): rows are short; walk via upper_bound.
        const int64_t* rb = indptr + r0;
        int64_t row =
            (std::upper_bound(rb, indptr + r1 + 1, orig) - rb) - 1;
        lane_row[lo + i] = (int32_t)row;
        lane_val[lo + i] = vals[orig];
        if (buf[i].first != prev) {
          ++u;
          prev = buf[i].first;
          uniq_cols[lo + u] = prev;  // staged at tile's lane base, compact later
        }
        lane_inv[lo + i] = (int32_t)u;
      }
      uniq_cnt[t] = u + 1;
    }
  }
  uniq_ptr[0] = 0;
  for (int64_t t = 0; t < n_tiles; ++t) uniq_ptr[t + 1] = uniq_ptr[t] + uniq_cnt[t];
  // compact uniq_cols from per-tile lane bases to uniq_ptr layout
  for (int64_t t = 0; t < n_tiles; ++t) {
    int64_t lo = indptr[std::min(t * R, n_rows)];
    std::memmove(uniq_cols + uniq_ptr[t], uniq_cols + lo,
                 sizeof(int32_t) * uniq_cnt[t]);
  }
  return 0;
}

// Multilevel heavy-edge-matching order (sparse/reorder.py
// matching_order, native): coarsen by mutual heaviest-neighbor matching
// until <= coarse_n supernodes, BFS-order the coarse graph, expand the
// ordering back down the contraction forest. out_order: n int64
// (old_from_new). Returns 0 on success.
int hem_order(int64_t n, const int64_t* indptr, const int32_t* cols,
              const float* vals, int64_t coarse_n, int64_t max_levels,
              int64_t* out_order) {
  // working CSR copy (weights in double: contracted sums)
  std::vector<int64_t> ip(indptr, indptr + n + 1);
  int64_t nnz0 = ip[n];
  std::vector<int32_t> cc(cols, cols + nnz0);
  std::vector<double> ww(nnz0);
  // level-0 edge weights: Jaccard common-neighbor similarity. The
  // degree-normalized values favor low-degree ENDPOINTS regardless of
  // community (an inter-community edge between two leaves outweighs
  // intra edges to mid-degree vertices), which poisons the first
  // contraction; shared-neighborhood counts are the community signal.
  // HUB CAP: the exact pass costs sum(deg^2) — ~100G probes on
  // ogbn-products' 17K-degree hubs. Edges with a > cap endpoint get a
  // tiny degree-based weight instead: hub edges are not
  // community-discriminative, and down-weighting them keeps hubs
  // unmatched until the contracted parallel-edge sums take over.
  const int64_t kJacCap = 256;
#pragma omp parallel
  {
    std::vector<int64_t> stamp(n, -1);
#pragma omp for schedule(dynamic, 256)
    for (int64_t u = 0; u < n; ++u) {
      int64_t du = ip[u + 1] - ip[u];
      if (du <= kJacCap)
        for (int64_t e = ip[u]; e < ip[u + 1]; ++e) stamp[cc[e]] = u;
      for (int64_t e = ip[u]; e < ip[u + 1]; ++e) {
        int32_t v = cc[e];
        if (v == (int32_t)u) {
          ww[e] = 0.0;
          continue;
        }
        int64_t dv = indptr[v + 1] - indptr[v];
        if (du > kJacCap || dv > kJacCap) {
          ww[e] = 1e-6 / (double)(du + dv);
          continue;
        }
        int64_t cn = 0;
        for (int64_t q = indptr[v]; q < indptr[v + 1]; ++q)
          if (stamp[cols[q]] == u) ++cn;
        ww[e] = (1.0 + cn) / (double)(du + dv - cn + 1);
      }
    }
  }

  struct Level {
    std::vector<int32_t> c1, c2;  // per new id: children (c2 = -1)
  };
  std::vector<Level> levels;
  int64_t cur = n;
  for (int64_t pass = 0; pass < max_levels && cur > coarse_n; ++pass) {
    // GREEDY heavy-edge matching, periphery (low degree) first: each
    // unmatched vertex takes its heaviest still-unmatched neighbor.
    // (Mutual-only matching stalls at ~1%/level here: every low-degree
    // vertex points at the same attractors, so almost no pair is
    // reciprocal — measured 238K -> 219K over 48 levels.)
    std::vector<int64_t> vorder(cur);
    for (int64_t u = 0; u < cur; ++u) vorder[u] = u;
    std::stable_sort(vorder.begin(), vorder.end(),
                     [&](int64_t a, int64_t b) {
                       return ip[a + 1] - ip[a] < ip[b + 1] - ip[b];
                     });
    std::vector<int32_t> mate(cur, -1);
    for (int64_t vi = 0; vi < cur; ++vi) {
      int64_t u = vorder[vi];
      if (mate[u] >= 0) continue;
      double best = -1.0;
      int32_t bn = -1;
      for (int64_t e = ip[u]; e < ip[u + 1]; ++e) {
        int32_t v = cc[e];
        if (v == (int32_t)u || mate[v] >= 0) continue;
        if (ww[e] > best || (ww[e] == best && v < bn)) {
          best = ww[e];
          bn = v;
        }
      }
      if (bn >= 0) {
        mate[u] = bn;
        mate[bn] = (int32_t)u;
      }
    }
    // parent = min(u, mate)
    std::vector<int32_t> newid(cur);
    int64_t nxt = 0;
    for (int64_t u = 0; u < cur; ++u) {
      int32_t m = mate[u];
      if (m >= 0 && m < (int32_t)u) {
        newid[u] = newid[m];  // second child of an existing pair
      } else {
        newid[u] = (int32_t)nxt++;
      }
    }
    if (nxt >= cur) break;  // no progress
    Level lv;
    lv.c1.assign(nxt, -1);
    lv.c2.assign(nxt, -1);
    for (int64_t u = 0; u < cur; ++u) {
      int32_t id = newid[u];
      if (lv.c1[id] < 0)
        lv.c1[id] = (int32_t)u;
      else
        lv.c2[id] = (int32_t)u;
    }
    // contract: per new node, merge + dedup children's adjacency
    std::vector<int64_t> nip(nxt + 1, 0);
#pragma omp parallel for schedule(dynamic, 1024)
    for (int64_t w = 0; w < nxt; ++w) {
      int64_t deg = ip[lv.c1[w] + 1] - ip[lv.c1[w]];
      if (lv.c2[w] >= 0) deg += ip[lv.c2[w] + 1] - ip[lv.c2[w]];
      nip[w + 1] = deg;  // upper bound before dedup
    }
    for (int64_t w = 0; w < nxt; ++w) nip[w + 1] += nip[w];
    std::vector<int32_t> ncc(nip[nxt]);
    std::vector<double> nww(nip[nxt]);
    std::vector<int64_t> nlen(nxt, 0);
#pragma omp parallel
    {
      std::vector<std::pair<int32_t, double>> buf;
#pragma omp for schedule(dynamic, 1024)
      for (int64_t w = 0; w < nxt; ++w) {
        buf.clear();
        for (int k = 0; k < 2; ++k) {
          int32_t ch = k == 0 ? lv.c1[w] : lv.c2[w];
          if (ch < 0) continue;
          for (int64_t e = ip[ch]; e < ip[ch + 1]; ++e) {
            int32_t v = newid[cc[e]];
            if (v == (int32_t)w) continue;  // internal edge
            buf.push_back({v, ww[e]});
          }
        }
        std::sort(buf.begin(), buf.end(),
                  [](const auto& a, const auto& b) {
                    return a.first < b.first;
                  });
        int64_t o = nip[w];
        int64_t cnt = 0;
        for (size_t i = 0; i < buf.size(); ++i) {
          if (cnt && ncc[o + cnt - 1] == buf[i].first) {
            nww[o + cnt - 1] += buf[i].second;
          } else {
            ncc[o + cnt] = buf[i].first;
            nww[o + cnt] = buf[i].second;
            ++cnt;
          }
        }
        nlen[w] = cnt;
      }
    }
    // compact to a tight CSR
    std::vector<int64_t> cip(nxt + 1, 0);
    for (int64_t w = 0; w < nxt; ++w) cip[w + 1] = cip[w] + nlen[w];
    std::vector<int32_t> ccc(cip[nxt]);
    std::vector<double> cww(cip[nxt]);
#pragma omp parallel for schedule(static)
    for (int64_t w = 0; w < nxt; ++w) {
      std::memcpy(ccc.data() + cip[w], ncc.data() + nip[w],
                  sizeof(int32_t) * nlen[w]);
      std::memcpy(cww.data() + cip[w], nww.data() + nip[w],
                  sizeof(double) * nlen[w]);
    }
    ip.swap(cip);
    cc.swap(ccc);
    ww.swap(cww);
    levels.push_back(std::move(lv));
    cur = nxt;
    if (getenv("OFS_HEM_DEBUG"))
      fprintf(stderr, "hem level %d: n=%lld nnz=%lld\n", pass,
              (long long)cur, (long long)ip[cur]);
  }

  // coarse order: greedy heavy-edge chain (nearest-neighbor walk on
  // contracted weights). The coarse graph is near-complete, so BFS
  // shells are meaningless; the chain keeps sibling communities
  // adjacent, which is what the range windows consume.
  std::vector<int64_t> order(cur);
  {
    std::vector<char> vis(cur, 0);
    int64_t pos = 0;
    int64_t u = 0;
    // start from the heaviest vertex (total weight)
    {
      double best = -1.0;
      for (int64_t v = 0; v < cur; ++v) {
        double s = 0;
        for (int64_t e = ip[v]; e < ip[v + 1]; ++e) s += ww[e];
        if (s > best) {
          best = s;
          u = v;
        }
      }
    }
    while (pos < cur) {
      vis[u] = 1;
      order[pos++] = u;
      if (pos >= cur) break;
      double best = -1.0;
      int64_t nxt = -1;
      for (int64_t e = ip[u]; e < ip[u + 1]; ++e) {
        int32_t v = cc[e];
        if (!vis[v] && ww[e] > best) {
          best = ww[e];
          nxt = v;
        }
      }
      if (nxt < 0) {
        // dead end: heaviest unvisited edge from ANY visited vertex
        // (fallback: first unvisited)
        for (int64_t v = 0; v < cur && nxt < 0; ++v)
          if (!vis[v]) nxt = v;
      }
      u = nxt;
    }
  }

  // expand down the contraction forest
  std::vector<int64_t> cur_order(order);
  for (int64_t li = (int64_t)levels.size() - 1; li >= 0; --li) {
    const Level& lv = levels[li];
    std::vector<int64_t> nxt_order;
    nxt_order.reserve(cur_order.size() * 2);
    for (int64_t id : cur_order) {
      nxt_order.push_back(lv.c1[id]);
      if (lv.c2[id] >= 0) nxt_order.push_back(lv.c2[id]);
    }
    cur_order.swap(nxt_order);
  }
  std::memcpy(out_order, cur_order.data(), sizeof(int64_t) * n);
  return 0;
}

}  // extern "C"
