// Native cover-tree construction (C++17 + OpenMP), exposed through a C ABI:
// the host-side tree of the port's selection/covertree.py, which compiles it at
// first use with the host compiler (selection/native.py) and documents the
// construction: root at the data mean, radius halving per level, optional
// Lloyd's local-mean refinement with a minimum-separation guard, optional
// Voronoi repartition per level.  The code is the JAX package's native
// cover tree, kept here as a copy so the port reads nothing of that package;
// tests/test_torch_covertree.py holds the two copies' code equal and their
// trees equal.
//
// The uncovered set is kept compact (swap-removal), every distance pass is
// OpenMP parallel, and no per-center allocation happens.  The Lloyd's mean
// adds the threads' partial sums in the order they finish, so a centre may
// differ in its last bit between runs with more than one thread.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline double sq_dist(const double* a, const double* b, int64_t d) {
  double acc = 0.0;
  for (int64_t k = 0; k < d; ++k) {
    const double diff = a[k] - b[k];
    acc += diff * diff;
  }
  return acc;
}

}  // namespace

extern "C" {

// Builds the tree; returns 0 on success.
//   x:            [n, d] row-major input points
//   spatial_resolution: > 0 fixes num_levels and snaps max_radius
//   num_levels:   used when spatial_resolution <= 0 (reference num_levels arg)
//   lloyds, voronoi: 0/1 flags
//   centers_out:  [n, d] capacity buffer; first *num_centers_out rows written
//   labels_out:   [n] final cluster label per point
//   num_centers_out, num_levels_out: scalars
int covertree_build(const double* x, int64_t n, int64_t d,
                    double spatial_resolution, int64_t num_levels_in,
                    int lloyds, int voronoi,
                    double* centers_out, int64_t* labels_out,
                    int64_t* num_centers_out, int64_t* num_levels_out) {
  if (n <= 0 || d <= 0) return 1;

  // Root = mean of the data; max_radius = max distance to the root.
  std::vector<double> root(d, 0.0);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t k = 0; k < d; ++k) root[k] += x[i * d + k];
  for (int64_t k = 0; k < d; ++k) root[k] /= static_cast<double>(n);

  double max_r2 = 0.0;
#pragma omp parallel for reduction(max : max_r2)
  for (int64_t i = 0; i < n; ++i)
    max_r2 = std::max(max_r2, sq_dist(&x[i * d], root.data(), d));
  double max_radius = std::sqrt(max_r2);

  int64_t num_levels = num_levels_in;
  if (spatial_resolution > 0.0) {
    max_radius = std::max(max_radius, spatial_resolution);
    num_levels = static_cast<int64_t>(
                     std::ceil(std::log2(max_radius / spatial_resolution))) + 1;
    max_radius = spatial_resolution * std::ldexp(1.0, static_cast<int>(num_levels - 1));
  }

  std::vector<int64_t> labels(n, 0);
  std::vector<double> centers;           // current level, [m, d]
  centers.assign(root.begin(), root.end());
  int64_t num_centers = 1;

  std::vector<int64_t> order(n);         // parent-major seed order
  std::vector<int64_t> uncovered(n);     // compact uncovered index set
  std::vector<double> next_centers;
  std::vector<double> mean(d);
  // Hoisted per-center scratch (the "no per-center allocation" promise):
  // claim entries [0, num_uncovered) are fully rewritten each center, and
  // each thread gets a d-sized slice for the Lloyd's mean accumulation.
  std::vector<char> claim(n, 0);
#ifdef _OPENMP
  const int max_threads = omp_get_max_threads();
#else
  const int max_threads = 1;
#endif
  std::vector<double> lloyd_scratch(static_cast<size_t>(max_threads) * d);

  for (int64_t level = 1; level < num_levels; ++level) {
    const double radius = max_radius / std::ldexp(1.0, static_cast<int>(level));
    const double r2 = radius * radius;

    // Stable counting sort of indices by current label (parent-major order).
    {
      std::vector<int64_t> counts(num_centers + 1, 0);
      for (int64_t i = 0; i < n; ++i) ++counts[labels[i] + 1];
      for (int64_t c = 0; c < num_centers; ++c) counts[c + 1] += counts[c];
      for (int64_t i = 0; i < n; ++i) order[counts[labels[i]]++] = i;
    }

    // Uncovered set in parent-major order (compact; swap-removed on claim).
    std::vector<int64_t> pos_in_uncovered(n);
    for (int64_t i = 0; i < n; ++i) {
      uncovered[i] = order[i];
      pos_in_uncovered[order[i]] = i;
    }
    int64_t num_uncovered = n;
    int64_t cursor = 0;  // index into `order`
    std::vector<char> assigned(n, 0);

    next_centers.clear();
    int64_t m = 0;

    while (num_uncovered > 0) {
      while (cursor < n && assigned[order[cursor]]) ++cursor;
      if (cursor >= n) break;
      const int64_t seed_idx = order[cursor];
      const double* seed = &x[seed_idx * d];
      const double* point = seed;

      if (lloyds) {
        // Mean of the seed's uncovered radius-neighbourhood.
        std::fill(mean.begin(), mean.end(), 0.0);
        int64_t cnt = 0;
#pragma omp parallel
        {
#ifdef _OPENMP
          const int tid = omp_get_thread_num();
#else
          const int tid = 0;
#endif
          double* local = &lloyd_scratch[static_cast<size_t>(tid) * d];
          std::fill(local, local + d, 0.0);
          int64_t local_cnt = 0;
#pragma omp for nowait
          for (int64_t u = 0; u < num_uncovered; ++u) {
            const int64_t idx = uncovered[u];
            if (sq_dist(&x[idx * d], seed, d) <= r2) {
              for (int64_t k = 0; k < d; ++k) local[k] += x[idx * d + k];
              ++local_cnt;
            }
          }
#pragma omp critical
          {
            for (int64_t k = 0; k < d; ++k) mean[k] += local[k];
            cnt += local_cnt;
          }
        }
        if (cnt > 0) {
          for (int64_t k = 0; k < d; ++k) mean[k] /= static_cast<double>(cnt);
          // Keep minimum separation vs already-placed centers of this level.
          bool ok = true;
          for (int64_t c = 0; c < m && ok; ++c)
            if (sq_dist(&next_centers[c * d], mean.data(), d) < r2) ok = false;
          if (ok) point = mean.data();
        }
      }

      // Record the center, claim uncovered points within radius.
      next_centers.insert(next_centers.end(), point, point + d);
      const double* center = &next_centers[m * d];

#pragma omp parallel for
      for (int64_t u = 0; u < num_uncovered; ++u)
        claim[u] = sq_dist(&x[uncovered[u] * d], center, d) <= r2 ? 1 : 0;
      // Always claim the seed (guards Lloyd's means that drift off the seed).
      claim[pos_in_uncovered[seed_idx]] = 1;

      // Serial compaction (swap-removal keeps positions consistent).
      for (int64_t u = num_uncovered - 1; u >= 0; --u) {
        if (!claim[u]) continue;
        const int64_t idx = uncovered[u];
        labels[idx] = m;
        assigned[idx] = 1;
        const int64_t last = num_uncovered - 1;
        uncovered[u] = uncovered[last];
        pos_in_uncovered[uncovered[u]] = u;
        std::swap(claim[u], claim[last]);
        --num_uncovered;
      }
      ++m;
    }

    centers = next_centers;
    num_centers = m;

    if (voronoi) {
#pragma omp parallel for
      for (int64_t i = 0; i < n; ++i) {
        double best = std::numeric_limits<double>::infinity();
        int64_t best_c = 0;
        for (int64_t c = 0; c < num_centers; ++c) {
          const double dd = sq_dist(&x[i * d], &centers[c * d], d);
          if (dd < best) { best = dd; best_c = c; }
        }
        labels[i] = best_c;
      }
    }
  }

  std::memcpy(centers_out, centers.data(),
              sizeof(double) * static_cast<size_t>(num_centers) * d);
  for (int64_t i = 0; i < n; ++i) labels_out[i] = labels[i];
  *num_centers_out = num_centers;
  *num_levels_out = num_levels;
  return 0;
}

int covertree_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
