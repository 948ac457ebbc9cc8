// Native k-hop extraction kernels (C++17, no external deps).
//
// The port's own copy of kpgnn_tpu/prep/_native/khop_native.cpp, built by
// kpgnn_tpu_torch/prep/native.py.  The preprocessing hot loops —
// adjacency-power chains, SPD masking, and the per-node
// peripheral-subgraph statistics — re-implemented in C++ for the
// host-side (CPU) preprocessing stage.  The reference spends
// minutes-to-hours here in Python/networkx (reference:
// data_utils.py:110-241); this module is the same math as
// kpgnn_tpu_torch/prep/khop.py, held bit-exact against the JAX package's
// prep in tests/test_torch_prep_runner.py.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// All matrices are dense row-major int64.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// out[k] = A^(k+1) with zeroed diagonal, k = 0..K-1.
// adj: n*n, out: K*n*n.
void adjacency_powers(const int64_t* adj, int64_t n, int64_t K,
                      int64_t* out) {
  std::vector<int64_t> prev(adj, adj + n * n);  // un-zeroed chain
  // k = 0
  std::memcpy(out, adj, sizeof(int64_t) * n * n);
  for (int64_t i = 0; i < n; ++i) out[i * n + i] = 0;
  std::vector<int64_t> next(n * n);
  for (int64_t k = 1; k < K; ++k) {
    // next = prev @ adj  (ikj loop order for locality)
    std::fill(next.begin(), next.end(), 0);
    for (int64_t i = 0; i < n; ++i) {
      const int64_t* prow = prev.data() + i * n;
      int64_t* nrow = next.data() + i * n;
      for (int64_t t = 0; t < n; ++t) {
        int64_t p = prow[t];
        if (p == 0) continue;
        const int64_t* arow = adj + t * n;
        for (int64_t j = 0; j < n; ++j) nrow[j] += p * arow[j];
      }
    }
    int64_t* orow = out + k * n * n;
    std::memcpy(orow, next.data(), sizeof(int64_t) * n * n);
    for (int64_t i = 0; i < n; ++i) orow[i * n + i] = 0;
    prev.swap(next);
  }
}

// SPD masking in place over powers (K*n*n): hop k keeps only entries not
// seen at hops < k; writes the binarized union into union_out (n*n).
void spd_mask(int64_t* powers, int64_t n, int64_t K, int64_t* union_out) {
  std::vector<uint8_t> seen(n * n);
  for (int64_t i = 0; i < n * n; ++i) seen[i] = powers[i] > 0;
  for (int64_t k = 1; k < K; ++k) {
    int64_t* m = powers + k * n * n;
    for (int64_t i = 0; i < n * n; ++i) {
      if (seen[i]) m[i] = 0;
      else if (m[i] > 0) seen[i] = 1;
    }
  }
  for (int64_t i = 0; i < n * n; ++i) union_out[i] = seen[i] ? 1 : 0;
}

// Binarized union of all hops (GD kernel) into union_out.
void gd_union(const int64_t* powers, int64_t n, int64_t K,
              int64_t* union_out) {
  std::fill(union_out, union_out + n * n, 0);
  for (int64_t k = 0; k < K; ++k) {
    const int64_t* m = powers + k * n * n;
    for (int64_t i = 0; i < n * n; ++i)
      if (m[i] > 0) union_out[i] = 1;
  }
}

// BFS all-pairs shortest path lengths on a directed boolean graph, capped
// at max_len; 0 for self/unreachable/beyond-cap.  adj_bool/dist: n*n.
void bfs_apsp(const uint8_t* adj_bool, int64_t n, int64_t max_len,
              int32_t* dist) {
  std::fill(dist, dist + n * n, 0);
  std::vector<int64_t> queue(n);
  for (int64_t s = 0; s < n; ++s) {
    int64_t head = 0, tail = 0;
    queue[tail++] = s;
    int32_t* drow = dist + s * n;
    std::vector<uint8_t> vis(n, 0);
    vis[s] = 1;
    while (head < tail) {
      int64_t u = queue[head++];
      int32_t du = drow[u];
      if (du >= max_len) continue;
      const uint8_t* arow = adj_bool + u * n;
      for (int64_t v = 0; v < n; ++v) {
        if (arow[v] && !vis[v]) {
          vis[v] = 1;
          drow[v] = du + 1;
          queue[tail++] = v;
        }
      }
    }
  }
}

// Peripheral statistics for one hop (reference: data_utils.py:165-221).
// attr_adj: n*n edge-attr codes; hop_adj: n*n (this hop's matrix);
// edge_mat: n*T*2 out; config_mat: n*(H+1) out.
void peripheral_hop(const int64_t* attr_adj, const int64_t* hop_adj,
                    int64_t n, int64_t max_hop_num, int64_t max_edge_type,
                    int64_t max_edge_count, int64_t max_distance_count,
                    int64_t* edge_mat, int64_t* config_mat) {
  const int64_t T = max_edge_type, H = max_hop_num;
  std::fill(edge_mat, edge_mat + n * T * 2, 0);
  std::fill(config_mat, config_mat + n * (H + 1), 0);

  std::vector<int64_t> nbr;
  for (int64_t i = 0; i < n; ++i) {
    nbr.clear();
    const int64_t* hrow = hop_adj + i * n;
    for (int64_t j = 0; j < n; ++j)
      if (hrow[j] > 0) nbr.push_back(j);
    const int64_t m = (int64_t)nbr.size();
    if (m < 2) continue;

    // induced subgraph on nbr
    std::vector<int64_t> sub(m * m);
    int64_t max_val = 0;
    bool any_edge = false;
    for (int64_t a = 0; a < m; ++a)
      for (int64_t b = 0; b < m; ++b) {
        int64_t v = attr_adj[nbr[a] * n + nbr[b]];
        sub[a * m + b] = v;
        if (v > 0) any_edge = true;
        max_val = std::max(max_val, v);
      }
    if (!any_edge) continue;

    // edge-type histogram over codes >= 2, top-T by count (stable:
    // ties resolve to the smaller type index)
    std::vector<int64_t> counts(std::max(max_val + 1, T + 2), 0);
    for (int64_t a = 0; a < m * m; ++a)
      if (sub[a] > 0) counts[sub[a]]++;
    const int64_t nvals = (int64_t)counts.size() - 2;
    std::vector<int64_t> order(nvals);
    for (int64_t v = 0; v < nvals; ++v) order[v] = v;
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) {
                       return counts[a + 2] > counts[b + 2];
                     });
    for (int64_t t = 0; t < T && t < nvals; ++t) {
      edge_mat[(i * T + t) * 2 + 0] = order[t];
      edge_mat[(i * T + t) * 2 + 1] =
          std::min(counts[order[t] + 2], max_edge_count);
    }

    // BFS APSP inside the subgraph, capped at H
    std::vector<uint8_t> sub_bool(m * m);
    for (int64_t a = 0; a < m * m; ++a) sub_bool[a] = sub[a] > 0;
    std::vector<int32_t> dist(m * m);
    bfs_apsp(sub_bool.data(), m, H, dist.data());

    // distance histogram; slot 0 <- total weight of edges between
    // equidistant node pairs
    std::vector<int64_t> hist(H + 1, 0);
    for (int64_t a = 0; a < m * m; ++a) hist[dist[a]]++;
    int64_t equi = 0;
    std::vector<int64_t> at_h;
    for (int64_t j = 0; j < m; ++j) {
      const int32_t* drow = dist.data() + j * m;
      for (int64_t h = 1; h <= H; ++h) {
        at_h.clear();
        for (int64_t v = 0; v < m; ++v)
          if (drow[v] == h) at_h.push_back(v);
        if (at_h.size() < 2) continue;
        for (int64_t a : at_h)
          for (int64_t b : at_h) equi += sub[a * m + b];
      }
    }
    hist[0] = equi;
    for (int64_t h = 0; h <= H; ++h)
      config_mat[i * (H + 1) + h] = std::min(hist[h], max_distance_count);
  }
}

}  // extern "C"
