// Native host grouping: peak finding + associative-embedding clustering.
//
// The host decoder of the demo's `--backend native` (litepose_tpu_torch/
// native.py): decode heatmaps on the CPU, with no kernel launched.  The
// same source as the JAX package's litepose_tpu/native/fast_group.cpp (the
// role of the reference's C++ deployment extension, nano_demo/fast_utils/
// parse/find_peaks.cpp and assign.cpp).  Unlike the reference's greedy
// 10x10-capped variant, this implements the full grouping semantics of the
// Python pipeline (score-sorted top-K peaks, per-joint optimal assignment
// on round(||tag diff||)*100 - score with 1e10 column padding, tag-threshold
// join/spawn), the contract of the JAX package's group_ref.parse_np.
//
// Built with the JPEG decoder into the host library (kernels/build.py:
// build_host) and bound through ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// O(n^3) min-cost assignment (potentials + shortest augmenting path).
// cost is n x n row-major; rows [0, n_rows) are assigned; returns col per
// row in `match` (or -1).
void solve_assignment(const std::vector<double>& cost, int n, int n_rows,
                      std::vector<int>& match) {
  const double INF = 1e30;
  std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
  std::vector<int> p(n + 1, 0), way(n + 1, 0);
  for (int i = 1; i <= n_rows; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(n + 1, INF);
    std::vector<char> used(n + 1, 0);
    do {
      used[j0] = 1;
      int i0 = p[j0];
      double delta = INF;
      int j1 = 0;
      for (int j = 1; j <= n; ++j) {
        if (used[j]) continue;
        double cur = cost[(i0 - 1) * n + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= n; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  match.assign(n, -1);
  for (int j = 1; j <= n; ++j) {
    if (p[j] >= 1 && p[j] <= n_rows) match[p[j] - 1] = j - 1;
  }
}

}  // namespace

extern "C" {

// Windowed local-maximum peak extraction over one image's heatmaps.
//
// det: (K, H, W) float32; tag: (K, H, W, T) float32.
// Emits per joint up to max_peaks peaks sorted by score descending:
// counts (K,), vals (K, max_peaks), xys (K, max_peaks, 2) as float (x, y),
// tags_out (K, max_peaks, T).
// `win` is the NMS kernel size (odd), matching maxpool-equality NMS.
void lp_find_peaks(const float* det, const float* tag, int K, int H, int W,
                   int T, float threshold, int max_peaks, int win,
                   int32_t* counts, float* vals, float* xys, float* tags_out) {
  const int r = win / 2;
  std::vector<std::pair<float, int>> peaks;
  for (int k = 0; k < K; ++k) {
    peaks.clear();
    const float* d = det + (size_t)k * H * W;
    for (int y = 0; y < H; ++y) {
      for (int x = 0; x < W; ++x) {
        float c = d[y * W + x];
        if (c <= threshold) continue;
        bool is_max = true;
        for (int dy = -r; dy <= r && is_max; ++dy) {
          int yy = y + dy;
          if (yy < 0 || yy >= H) continue;
          for (int dx = -r; dx <= r; ++dx) {
            int xx = x + dx;
            if (xx < 0 || xx >= W) continue;
            if (d[yy * W + xx] > c) {
              is_max = false;
              break;
            }
          }
        }
        if (is_max) peaks.emplace_back(c, y * W + x);
      }
    }
    std::stable_sort(peaks.begin(), peaks.end(), [](auto& a, auto& b) {
      return a.first > b.first;
    });
    int n = std::min<int>((int)peaks.size(), max_peaks);
    counts[k] = n;
    for (int m = 0; m < n; ++m) {
      int pos = peaks[m].second;
      vals[k * max_peaks + m] = peaks[m].first;
      xys[(k * max_peaks + m) * 2 + 0] = (float)(pos % W);
      xys[(k * max_peaks + m) * 2 + 1] = (float)(pos / W);
      for (int t = 0; t < T; ++t) {
        tags_out[((size_t)k * max_peaks + m) * T + t] =
            tag[(((size_t)k * H + pos / W) * W + pos % W) * T + t];
      }
    }
  }
}

// Associative-embedding grouping over extracted peaks (one image).
//
// Inputs per lp_find_peaks layout. joint_order: K ints.
// Outputs: people (max_clusters, K, 3+T) rows [x, y, val, tag...] in
// cluster-creation order; returns the number of people.
int32_t lp_assign(const int32_t* counts, const float* vals, const float* xys,
                  const float* tags, const int32_t* joint_order, int K,
                  int max_peaks, int T, float tag_threshold,
                  int use_detection_val, int ignore_too_much, int max_people,
                  int max_clusters, float* people) {
  struct Cluster {
    std::vector<float> tag_sum;
    int tag_cnt = 0;
  };
  std::vector<Cluster> clusters;
  const int row_len = 3 + T;
  std::memset(people, 0, sizeof(float) * (size_t)max_clusters * K * row_len);

  std::vector<double> cost;
  std::vector<int> match;
  for (int oi = 0; oi < K; ++oi) {
    int idx = joint_order[oi];
    int n = counts[idx];
    if (n == 0) continue;

    auto peak_val = [&](int m) { return vals[idx * max_peaks + m]; };
    auto peak_tag = [&](int m, int t) {
      return tags[((size_t)idx * max_peaks + m) * T + t];
    };
    auto write_person = [&](int ci, int m) {
      if (ci >= max_clusters) return;
      float* row = people + ((size_t)ci * K + idx) * row_len;
      row[0] = xys[(idx * max_peaks + m) * 2 + 0];
      row[1] = xys[(idx * max_peaks + m) * 2 + 1];
      row[2] = peak_val(m);
      for (int t = 0; t < T; ++t) row[3 + t] = peak_tag(m, t);
    };
    auto spawn = [&](int m) {
      Cluster c;
      c.tag_sum.assign(T, 0.0f);
      for (int t = 0; t < T; ++t) c.tag_sum[t] = peak_tag(m, t);
      c.tag_cnt = 1;
      clusters.push_back(std::move(c));
      write_person((int)clusters.size() - 1, m);
    };

    if (oi == 0 || clusters.empty()) {
      for (int m = 0; m < n; ++m) spawn(m);
      continue;
    }
    int G = std::min<int>((int)clusters.size(), max_people);
    if (ignore_too_much && (int)clusters.size() >= max_people) continue;

    int dim = std::max(n, G);
    cost.assign((size_t)dim * dim, 0.0);
    std::vector<std::vector<double>> diff_saved(n, std::vector<double>(G));
    for (int m = 0; m < n; ++m) {
      for (int g = 0; g < G; ++g) {
        double d2 = 0.0;
        for (int t = 0; t < T; ++t) {
          double dt = peak_tag(m, t) -
                      clusters[g].tag_sum[t] / clusters[g].tag_cnt;
          d2 += dt * dt;
        }
        double dd = std::sqrt(d2);
        diff_saved[m][g] = dd;
        cost[(size_t)m * dim + g] =
            use_detection_val ? std::round(dd) * 100.0 - peak_val(m) : dd;
      }
      for (int g = G; g < dim; ++g) cost[(size_t)m * dim + g] = 1e10;
    }
    solve_assignment(cost, dim, n, match);
    for (int m = 0; m < n; ++m) {
      int g = match[m];
      if (g >= 0 && g < G && diff_saved[m][g] < tag_threshold) {
        write_person(g, m);
        for (int t = 0; t < T; ++t) clusters[g].tag_sum[t] += peak_tag(m, t);
        clusters[g].tag_cnt += 1;
      } else {
        spawn(m);
      }
    }
  }
  return std::min<int32_t>((int32_t)clusters.size(), max_clusters);
}

}  // extern "C"
