// Native host-side ops for mops_tpu_torch (a copy of the JAX package's
// mops_tpu/native/host_ops.cpp, which the port may not import).
//
// Replacement for the reference's C++ host components (nanoflann KD-tree
// build/query, reference src/Utils/KDTree.h:8-80 and
// src/Core/MPASOGrid.cpp:247-313; serial per-pixel SearchKDTree,
// src/GPU/SYCL/Kernel/SYCLKernel.cpp:5-22): a lat-lon bucket grid over cell
// centers with exact nearest-neighbor queries via ring expansion.  Built as a
// plain C ABI shared library consumed through ctypes.
//
// Exactness: query expands a rectangle of buckets until the best distance
// found is provably closer than any unvisited bucket (spherical bounds), so
// results match brute-force/KD 1-NN (ties to the lower cell id).  The one
// difference from mops_tpu's copy is the rectangle's shape (mops_tpu
// expands square rings, which scan the whole grid for a point near a pole).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct Grid {
  int n_lat, n_lon;
  double radius;                    // mean |cell|
  std::vector<int32_t> bucket_of;   // cell -> bucket
  std::vector<int32_t> starts;      // bucket -> first index in cell_ids
  std::vector<int32_t> cell_ids;    // bucketed cell ids (CSR)
  std::vector<double> xyz;          // n_cells * 3
  int64_t n_cells;
};

inline void latlon_of(const double* p, double& lat, double& lon) {
  const double r = std::sqrt(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
  lat = std::asin(std::min(1.0, std::max(-1.0, p[2] / r)));
  lon = std::atan2(p[1], p[0]);
}

inline int bucket_index(const Grid& g, double lat, double lon) {
  int li = static_cast<int>((lat + kPi / 2) / kPi * g.n_lat);
  li = std::min(g.n_lat - 1, std::max(0, li));
  int lj = static_cast<int>((lon + kPi) / (2 * kPi) * g.n_lon);
  lj = ((lj % g.n_lon) + g.n_lon) % g.n_lon;
  return li * g.n_lon + lj;
}

}  // namespace

extern "C" {

// Build a bucket grid over n cell centers (xyz row-major, length 3n).
// Returns an opaque handle.
void* mops_grid_build(const double* xyz, int64_t n, int n_lat, int n_lon) {
  Grid* g = new Grid();
  g->n_lat = n_lat;
  g->n_lon = n_lon;
  g->n_cells = n;
  g->xyz.assign(xyz, xyz + 3 * n);
  double rsum = 0.0;
  g->bucket_of.resize(n);
  std::vector<int32_t> counts(n_lat * n_lon, 0);
  for (int64_t i = 0; i < n; ++i) {
    const double* p = xyz + 3 * i;
    rsum += std::sqrt(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
    double lat, lon;
    latlon_of(p, lat, lon);
    const int b = bucket_index(*g, lat, lon);
    g->bucket_of[i] = b;
    counts[b]++;
  }
  g->radius = rsum / std::max<int64_t>(1, n);
  g->starts.resize(n_lat * n_lon + 1, 0);
  for (int b = 0; b < n_lat * n_lon; ++b)
    g->starts[b + 1] = g->starts[b] + counts[b];
  g->cell_ids.resize(n);
  std::vector<int32_t> cursor(g->starts.begin(), g->starts.end() - 1);
  for (int64_t i = 0; i < n; ++i)
    g->cell_ids[cursor[g->bucket_of[i]]++] = static_cast<int32_t>(i);
  return g;
}

void mops_grid_free(void* handle) { delete static_cast<Grid*>(handle); }

// Exact 1-NN: for m query points (xyz, 3m), write nearest cell ids (m).
void mops_grid_query(void* handle, const double* q, int64_t m, int32_t* out) {
  const Grid& g = *static_cast<Grid*>(handle);
  const double lat_step = kPi / g.n_lat;

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i) {
    const double* p = q + 3 * i;
    double lat, lon;
    latlon_of(p, lat, lon);
    const int li0 = std::min(g.n_lat - 1, std::max(0, static_cast<int>(
        (lat + kPi / 2) / kPi * g.n_lat)));
    const int lj0 = ((static_cast<int>((lon + kPi) / (2 * kPi) * g.n_lon)
                      % g.n_lon) + g.n_lon) % g.n_lon;

    double best_d2 = 1e300;
    int32_t best = -1;
    // Expand a rectangle of buckets around the point's bucket, r rows and
    // c(r) columns to each side, until every unvisited bucket is provably
    // farther than the best hit.  Lower bounds (angular): unvisited
    // latitude rows are >= r*lat_step away; unvisited longitude columns are
    // >= the cross-track distance asin(sin(d_lon) * cos(lat)) away, with
    // d_lon = c*lon_step.  Chord distance of an angle a is 2 R sin(a/2).
    // c(r) makes the column bound reach the row bound: c = r at the
    // equator, every column at once near a pole, where all meridians are
    // close (square rings, c = r, reach every column there only after
    // covering every row: the whole grid for each polar pixel of an image).
    const double lon_step = 2.0 * kPi / g.n_lon;
    const double cos_lat = std::cos(lat);
    const int c_all = g.n_lon;           // any c >= n_lon / 2 covers all
    int c = 0, lo_prev = 1, hi_prev = 0;  // the empty column range at first
    for (int r = 0; r <= g.n_lat; ++r) {
      const double s_need = std::sin(std::min(r * lat_step, kPi / 2)) /
                            std::max(cos_lat, 1e-300);
      const int c_need = s_need >= 1.0 ? c_all : static_cast<int>(
          std::ceil(std::asin(s_need) / lon_step));
      c = std::max(c, std::min(c_need, c_all));
      // column offsets [lo, hi]: at most n_lon distinct columns
      const int lo = -std::min(c, g.n_lon / 2);
      const int hi = std::min(c, (g.n_lon - 1) / 2);
      for (int di = -r; di <= r; ++di) {
        const int li = li0 + di;
        if (li < 0 || li >= g.n_lat) continue;
        const bool new_row = (std::abs(di) == r);
        for (int dj = lo; dj <= hi; ++dj) {
          if (!new_row && dj >= lo_prev && dj <= hi_prev) continue;
          const int lj = ((lj0 + dj) % g.n_lon + g.n_lon) % g.n_lon;
          const int b = li * g.n_lon + lj;
          for (int32_t k = g.starts[b]; k < g.starts[b + 1]; ++k) {
            const int32_t cid = g.cell_ids[k];
            const double* cc = g.xyz.data() + 3 * cid;
            const double dx = cc[0] - p[0], dy = cc[1] - p[1],
                         dz = cc[2] - p[2];
            const double d2 = dx * dx + dy * dy + dz * dz;
            // ties go to the lower cell id, whatever the scan order
            if (d2 < best_d2 || (d2 == best_d2 && cid < best)) {
              best_d2 = d2;
              best = cid;
            }
          }
        }
      }
      lo_prev = lo;
      hi_prev = hi;
      const bool lat_covered = (li0 - r <= 0) && (li0 + r >= g.n_lat - 1);
      const bool lon_covered = (hi - lo + 1 >= g.n_lon);
      if (lat_covered && lon_covered) break;
      if (best >= 0) {
        double ang = 1e300;
        if (!lat_covered) ang = std::min(ang, r * lat_step);
        if (!lon_covered) {
          const double dlon = std::min(std::min(-lo, hi) * lon_step, kPi / 2);
          ang = std::min(ang, std::asin(std::sin(dlon) * cos_lat));
        }
        const double chord = 2.0 * g.radius * std::sin(std::min(ang, kPi) / 2);
        if (chord * chord > best_d2) break;
      }
    }
    out[i] = best;
  }
}

// Dense candidate-table export for the on-device bucket search:
// each bucket lists cells of itself + 8 neighbors, padded with -1.
// Returns needed depth; call with table == nullptr to size, then fill.
int32_t mops_grid_candidates(void* handle, int32_t depth, int32_t* table) {
  const Grid& g = *static_cast<Grid*>(handle);
  int32_t max_fill = 0;
  for (int li = 0; li < g.n_lat; ++li) {
    for (int lj = 0; lj < g.n_lon; ++lj) {
      int32_t fill = 0;
      for (int di = -1; di <= 1; ++di) {
        const int ni = li + di;
        if (ni < 0 || ni >= g.n_lat) continue;
        for (int dj = -1; dj <= 1; ++dj) {
          const int nj = ((lj + dj) % g.n_lon + g.n_lon) % g.n_lon;
          const int b = ni * g.n_lon + nj;
          for (int32_t k = g.starts[b]; k < g.starts[b + 1]; ++k) {
            if (table != nullptr && fill < depth)
              table[(static_cast<int64_t>(li) * g.n_lon + lj) * depth + fill] =
                  g.cell_ids[k];
            fill++;
          }
        }
      }
      if (table != nullptr)
        for (int32_t k = fill; k < depth; ++k)
          table[(static_cast<int64_t>(li) * g.n_lon + lj) * depth + k] = -1;
      max_fill = std::max(max_fill, fill);
    }
  }
  return max_fill;
}

}  // extern "C"
