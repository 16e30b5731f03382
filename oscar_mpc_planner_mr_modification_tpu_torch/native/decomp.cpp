// Native EllipsoidDecomp2D: convex free-space decomposition around a seed
// path (the role of the external C++ decomp_util library in the upstream
// planner's decomp constraints).
//
// The same algorithm as ops/decomp.py::EllipsoidDecomp2D (ellipsoid seeding
// and a polyhedron of tangent halfspaces, after Liu et al., RA-L 2017): the
// same constants, iteration order and tie-breaking, so the two backends give
// the same halfspaces (tests/test_torch_decomp.py holds them to 1e-9).
//
// Built with g++ at first use by ops/decomp_native.py into build/decomp/.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct V2 {
  double x, y;
};

}  // namespace

extern "C" {

// Decompose every path segment (path[k-1], path[k]) for k in [1, n_pts).
//
// path:       n_pts * 2 doubles
// obstacles:  n_obs * 2 doubles
// out_a:      n_pts * max_c * 2 doubles (halfspace normals, row-major per k)
// out_b:      n_pts * max_c doubles (offsets, a.x <= b)
// out_counts: n_pts ints (halfspaces emitted per k; index 0 is always 0)
// Returns 0 on success.
int decomp_dilate_path(const double* path, int n_pts, const double* obstacles,
                       int n_obs, double local_range, int max_c,
                       double* out_a, double* out_b, int* out_counts) {
  std::vector<V2> local;
  std::vector<V2> remaining;
  for (int k = 0; k < n_pts; ++k) out_counts[k] = 0;

  for (int k = 1; k < n_pts; ++k) {
    const double p1x = path[2 * (k - 1)], p1y = path[2 * (k - 1) + 1];
    const double p2x = path[2 * k], p2y = path[2 * k + 1];
    const double cx = 0.5 * (p1x + p2x), cy = 0.5 * (p1y + p2y);
    double ax = p2x - p1x, ay = p2y - p1y;
    double seg_len = std::sqrt(ax * ax + ay * ay);
    if (seg_len < 1e-9) {
      ax = 1.0;
      ay = 0.0;
      seg_len = 1e-6;
    }
    const double e1x = ax / seg_len, e1y = ay / seg_len;
    const double e2x = -e1y, e2y = e1x;
    double a = seg_len / 2.0 + 1e-3;
    double b = a;

    // Local crop (chebyshev box, matches the numpy max(|rel|) <= range + a)
    local.clear();
    for (int i = 0; i < n_obs; ++i) {
      const double rx = obstacles[2 * i] - cx, ry = obstacles[2 * i + 1] - cy;
      const double m = std::max(std::fabs(rx), std::fabs(ry));
      if (m <= local_range + a) local.push_back({obstacles[2 * i], obstacles[2 * i + 1]});
    }

    // Ellipsoid seeding: shrink semi-minor axis until free
    if (!local.empty()) {
      for (int it = 0; it < 40; ++it) {
        double b_needed_min = 1e300;
        bool any_inside = false;
        for (const V2& p : local) {
          const double dx = p.x - cx, dy = p.y - cy;
          const double qx = dx * e1x + dy * e1y;
          const double qy = dx * e2x + dy * e2y;
          const double t = (qx / a) * (qx / a) + (qy / b) * (qy / b);
          if (t < 1.0) {
            any_inside = true;
            double denom = 1.0 - (qx / a) * (qx / a);
            if (denom < 1e-6) denom = 1e-6;
            const double need = std::sqrt(qy * qy / denom);
            if (need < b_needed_min) b_needed_min = need;
          }
        }
        if (!any_inside) break;
        b = std::max(std::min(b, b_needed_min) * 0.999, 1e-3);
        if (b <= 1e-3) break;
      }
    }

    // Polyhedron: tangent halfspaces at closest points in the ellipse metric.
    // E_inv2 = R^T diag(1/a^2, 1/b^2) R with R = [e1; e2]
    const double ia2 = 1.0 / (a * a), ib2 = 1.0 / (b * b);
    const double m00 = e1x * e1x * ia2 + e2x * e2x * ib2;
    const double m01 = e1x * e1y * ia2 + e2x * e2y * ib2;
    const double m11 = e1y * e1y * ia2 + e2y * e2y * ib2;

    remaining = local;
    int count = 0;
    while (count < max_c && !remaining.empty()) {
      // argmin of d^T E_inv2 d (first minimum wins, matching np.argmin)
      int best = 0;
      double best_metric = 1e300;
      for (size_t i = 0; i < remaining.size(); ++i) {
        const double dx = remaining[i].x - cx, dy = remaining[i].y - cy;
        const double metric = dx * (m00 * dx + m01 * dy) + dy * (m01 * dx + m11 * dy);
        if (metric < best_metric) {
          best_metric = metric;
          best = static_cast<int>(i);
        }
      }
      const double px = remaining[best].x, py = remaining[best].y;
      double nx = m00 * (px - cx) + m01 * (py - cy);
      double ny = m01 * (px - cx) + m11 * (py - cy);
      const double norm = std::sqrt(nx * nx + ny * ny);
      if (norm < 1e-12) break;
      nx /= norm;
      ny /= norm;
      const double bb = nx * px + ny * py;
      const int o = (k * max_c + count);
      out_a[2 * o] = nx;
      out_a[2 * o + 1] = ny;
      out_b[o] = bb;
      ++count;
      // Discard points cut off by this halfspace
      std::vector<V2> keep;
      keep.reserve(remaining.size());
      for (const V2& p : remaining) {
        if (p.x * nx + p.y * ny < bb - 1e-9) keep.push_back(p);
      }
      remaining.swap(keep);
    }
    out_counts[k] = count;
  }
  return 0;
}

}  // extern "C"
