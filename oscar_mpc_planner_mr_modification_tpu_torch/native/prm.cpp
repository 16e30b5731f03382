// Native guidance search: Visibility-PRM in (x, y, t) with winding signatures.
//
// C++ implementation of the hot host-side path of the guidance subsystem
// (the role of the external `guidance_planner` package in the reference stack,
// mpc_planner_modules/src/guidance_constraints.cpp:6,122; budget 1-5 ms/cycle,
// docs/guidance_constraints_documentation.md:1335). The GPU handles the solver
// fleet; this library handles the serial graph search the accelerator is wrong
// for: sampling, O(n^2) time-monotone visibility checks with obstacle
// interpolation, bounded DFS path enumeration, dt-grid resampling and
// per-obstacle winding signatures.
//
// Exposed as a flat-array C ABI consumed via ctypes
// (../guidance/cpp_backend.py, which builds it with g++ -O3 -fPIC -shared
// into build/prm/ at first use).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

struct Node {
  double x, y, t;
  int kind;     // 0 = start, 1 = goal, 2 = sample
  double cost;  // goal cost (goals only)
};

struct SearchContext {
  const double* obs;  // n_obs * n_steps * 2
  const double* radii;
  int n_obs;
  int n_steps;
  double dt;

  void obstacle_at(double t, int i, double* px, double* py) const {
    double k = t / dt;
    int k0 = (int)std::floor(k);
    if (k0 < 0) k0 = 0;
    if (k0 > n_steps - 1) k0 = n_steps - 1;
    int k1 = k0 + 1 < n_steps ? k0 + 1 : n_steps - 1;
    double a = k - k0;
    if (a < 0) a = 0;
    if (a > 1) a = 1;
    const double* p0 = obs + (i * n_steps + k0) * 2;
    const double* p1 = obs + (i * n_steps + k1) * 2;
    *px = (1 - a) * p0[0] + a * p1[0];
    *py = (1 - a) * p0[1] + a * p1[1];
  }

  bool point_free(double x, double y, double t) const {
    for (int i = 0; i < n_obs; ++i) {
      double ox, oy;
      obstacle_at(t, i, &ox, &oy);
      double dx = x - ox, dy = y - oy;
      if (dx * dx + dy * dy < radii[i] * radii[i]) return false;
    }
    return true;
  }

  bool segment_valid(const Node& a, const Node& b, double max_velocity) const {
    if (b.t <= a.t + 1e-9) return false;
    double dx = b.x - a.x, dy = b.y - a.y;
    double dist = std::sqrt(dx * dx + dy * dy);
    if (dist / (b.t - a.t) > max_velocity) return false;
    int n_checks = (int)std::ceil((b.t - a.t) / (dt * 0.5));
    if (n_checks < 2) n_checks = 2;
    for (int s = 0; s <= n_checks; ++s) {
      double alpha = (double)s / n_checks;
      if (!point_free(a.x + alpha * dx, a.y + alpha * dy,
                      a.t + alpha * (b.t - a.t)))
        return false;
    }
    return true;
  }
};

}  // namespace

extern "C" {

// Returns the number of homotopy-distinct candidate paths written (<= n_out).
// out_paths: n_out * n_grid * 2 (resampled on the dt grid, n_grid = N+1)
// out_sigs:  n_out * n_obs (winding signatures)
// out_costs: n_out (goal cost + length_weight * path length)
int prm_search(const double* start,              // x, y
               const double* goals,              // n_goals * 3 (x, y, cost)
               int n_goals,
               const double* obs_trajs,          // n_obs * n_steps * 2
               const double* obs_radii, int n_obs, int n_steps,
               double dt, int n_grid,            // horizon grid: N+1 points
               int n_samples, uint64_t seed, double max_velocity,
               double length_weight, double pass_threshold,
               int max_paths_enum, int n_out,
               double* out_paths, double* out_sigs, double* out_costs) {
  const double T_horizon = (n_grid - 1) * dt;
  SearchContext ctx{obs_trajs, obs_radii, n_obs, n_steps, dt};

  // ---- node set --------------------------------------------------------
  std::vector<Node> nodes;
  nodes.push_back({start[0], start[1], 0.0, 0, 0.0});
  for (int g = 0; g < n_goals; ++g) {
    double gx = goals[g * 3], gy = goals[g * 3 + 1], gc = goals[g * 3 + 2];
    if (ctx.point_free(gx, gy, T_horizon))
      nodes.push_back({gx, gy, T_horizon, 1, gc});
  }
  if (nodes.size() < 2) return 0;

  double lo[2] = {start[0], start[1]}, hi[2] = {start[0], start[1]};
  for (int g = 0; g < n_goals; ++g) {
    for (int d = 0; d < 2; ++d) {
      lo[d] = std::min(lo[d], goals[g * 3 + d]);
      hi[d] = std::max(hi[d], goals[g * 3 + d]);
    }
  }
  for (int d = 0; d < 2; ++d) {
    double span = std::max(hi[d] - lo[d], 1.0);
    lo[d] -= 0.25 * span;
    hi[d] += 0.25 * span;
  }

  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> ut(0.15, 0.85);
  std::uniform_real_distribution<double> ux(lo[0], hi[0]);
  std::uniform_real_distribution<double> uy(lo[1], hi[1]);
  int placed = 0, attempts = 0;
  while (placed < n_samples && attempts < n_samples * 10) {
    ++attempts;
    double t = ut(rng) * T_horizon, x = ux(rng), y = uy(rng);
    if (ctx.point_free(x, y, t)) {
      nodes.push_back({x, y, t, 2, 0.0});
      ++placed;
    }
  }

  // Sort by time (stable): time-monotone DAG
  std::stable_sort(nodes.begin(), nodes.end(),
                   [](const Node& a, const Node& b) { return a.t < b.t; });
  const int n = (int)nodes.size();
  int start_idx = 0;
  for (int i = 0; i < n; ++i)
    if (nodes[i].kind == 0) start_idx = i;

  std::vector<std::vector<int>> adj(n);
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n; ++j)
      if (ctx.segment_valid(nodes[i], nodes[j], max_velocity))
        adj[i].push_back(j);

  // ---- bounded DFS enumeration ----------------------------------------
  std::vector<std::vector<int>> paths;
  std::vector<int> stack_path;
  std::vector<std::pair<int, size_t>> dfs;  // (node, next child index)
  stack_path.push_back(start_idx);
  dfs.push_back({start_idx, 0});
  while (!dfs.empty() && (int)paths.size() < max_paths_enum) {
    auto& [node, child] = dfs.back();
    if (nodes[node].kind == 1) {
      paths.push_back(stack_path);
      dfs.pop_back();
      stack_path.pop_back();
      continue;
    }
    if (child >= adj[node].size()) {
      dfs.pop_back();
      stack_path.pop_back();
      continue;
    }
    int next = adj[node][child++];
    stack_path.push_back(next);
    dfs.push_back({next, 0});
  }
  if (paths.empty()) return 0;

  // ---- resample + signature + cost ------------------------------------
  const int P = (int)paths.size();
  std::vector<double> sampled(P * n_grid * 2);
  std::vector<double> sigs(P * std::max(n_obs, 1), 0.0);
  std::vector<double> costs(P);
  for (int p = 0; p < P; ++p) {
    const auto& path = paths[p];
    double length = 0.0;
    for (size_t i = 1; i < path.size(); ++i) {
      double dx = nodes[path[i]].x - nodes[path[i - 1]].x;
      double dy = nodes[path[i]].y - nodes[path[i - 1]].y;
      length += std::sqrt(dx * dx + dy * dy);
    }
    costs[p] = nodes[path.back()].cost + length_weight * length;
    // piecewise-linear resample on the dt grid
    for (int k = 0; k < n_grid; ++k) {
      double t = k * dt;
      size_t seg = 0;
      while (seg + 1 < path.size() - 1 && nodes[path[seg + 1]].t <= t) ++seg;
      const Node& a = nodes[path[seg]];
      const Node& b = nodes[path[seg + 1]];
      double alpha = (b.t - a.t) > 1e-9 ? (t - a.t) / (b.t - a.t) : 0.0;
      if (alpha < 0) alpha = 0;
      if (alpha > 1) alpha = 1;
      sampled[(p * n_grid + k) * 2] = a.x + alpha * (b.x - a.x);
      sampled[(p * n_grid + k) * 2 + 1] = a.y + alpha * (b.y - a.y);
    }
    // winding signatures
    for (int i = 0; i < n_obs; ++i) {
      double total = 0.0, prev = 0.0;
      for (int k = 0; k < n_grid; ++k) {
        double ox, oy;
        ctx.obstacle_at(k * dt, i, &ox, &oy);
        double ang = std::atan2(sampled[(p * n_grid + k) * 2 + 1] - oy,
                                sampled[(p * n_grid + k) * 2] - ox);
        if (k > 0) {
          double d = ang - prev;
          d = std::fmod(d + M_PI, 2.0 * M_PI);
          if (d < 0) d += 2.0 * M_PI;
          total += d - M_PI;
        }
        prev = ang;
      }
      sigs[p * n_obs + i] = total;
    }
  }

  // ---- sort by cost, dedupe by homotopy class, emit -------------------
  std::vector<int> order(P);
  for (int i = 0; i < P; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return costs[a] < costs[b]; });

  int emitted = 0;
  std::vector<int> chosen;
  for (int oi = 0; oi < P && emitted < n_out; ++oi) {
    int p = order[oi];
    bool duplicate = false;
    for (int c : chosen) {
      bool same = true;
      for (int i = 0; i < n_obs; ++i) {
        if (std::fabs(sigs[p * n_obs + i] - sigs[c * n_obs + i]) >=
            pass_threshold) {
          same = false;
          break;
        }
      }
      if (same && n_obs > 0) {
        duplicate = true;
        break;
      }
      if (n_obs == 0) {  // no obstacles: single class
        duplicate = true;
        break;
      }
    }
    if (duplicate) continue;
    chosen.push_back(p);
    std::memcpy(out_paths + emitted * n_grid * 2, &sampled[p * n_grid * 2],
                sizeof(double) * n_grid * 2);
    for (int i = 0; i < n_obs; ++i)
      out_sigs[emitted * n_obs + i] = sigs[p * n_obs + i];
    out_costs[emitted] = costs[p];
    ++emitted;
  }
  return emitted;
}

// H-signature (Bhattacharya homology invariant) for a BATCH of space-time
// paths — the runtime classifier of guidance/homotopy.py::h_signature_batch
// (guidance_planner's "Homology" comparison function,
// config/guidance_planner.yaml:12). Per path x obstacle: line integral of the
// Biot-Savart field of the obstacle's time-extended skeleton along the path
// (closed form per straight segment). The control tick classifies ~10 paths
// against ~4 obstacles every cycle; the numpy version costs ~1.5 ms/call in
// broadcasting overhead, real money against the 33 ms p99 tick gate.
//
// paths: P*K*2 (x, y on a dt grid), obs: n_obs*T*2, out: P*n_obs.
void h_signature_batch(const double* paths, int P, int K, const double* obs,
                       int n_obs, int T, double dt, double* out) {
  const double t_extend =
      1e3 * std::max(dt * static_cast<double>(std::max(K, T)), 1.0);
  const int M = T + 1;  // skeleton segments after +-inf time extension
  // Skeleton endpoints per obstacle: S[0] = first point shifted -t_extend,
  // S[T+1] = last point shifted +t_extend (time is the 3rd coordinate).
  std::vector<double> A(n_obs * M * 3), B(n_obs * M * 3), Dh(n_obs * M * 3);
  for (int o = 0; o < n_obs; ++o) {
    auto S = [&](int j, double* pt) {  // skeleton vertex j in [0, T+1]
      if (j == 0) {
        pt[0] = obs[(o * T + 0) * 2 + 0];
        pt[1] = obs[(o * T + 0) * 2 + 1];
        pt[2] = -t_extend;
      } else if (j == T + 1) {
        pt[0] = obs[(o * T + T - 1) * 2 + 0];
        pt[1] = obs[(o * T + T - 1) * 2 + 1];
        pt[2] = (T - 1) * dt + t_extend;
      } else {
        pt[0] = obs[(o * T + j - 1) * 2 + 0];
        pt[1] = obs[(o * T + j - 1) * 2 + 1];
        pt[2] = (j - 1) * dt;
      }
    };
    double a[3], b[3];
    for (int m = 0; m < M; ++m) {
      S(m, a);
      S(m + 1, b);
      double d[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
      double L = std::sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
      L = std::max(L, 1e-12);
      for (int c = 0; c < 3; ++c) {
        A[(o * M + m) * 3 + c] = a[c];
        B[(o * M + m) * 3 + c] = b[c];
        Dh[(o * M + m) * 3 + c] = d[c] / L;
      }
    }
  }

  for (int p = 0; p < P; ++p) {
    for (int o = 0; o < n_obs; ++o) out[p * n_obs + o] = 0.0;
    for (int k = 0; k + 1 < K; ++k) {
      const double* p0 = paths + (p * K + k) * 2;
      const double* p1 = paths + (p * K + k + 1) * 2;
      const double mid[3] = {0.5 * (p0[0] + p1[0]), 0.5 * (p0[1] + p1[1]),
                             (k + 0.5) * dt};
      const double dl[3] = {p1[0] - p0[0], p1[1] - p0[1], dt};
      for (int o = 0; o < n_obs; ++o) {
        double acc[3] = {0.0, 0.0, 0.0};
        for (int m = 0; m < M; ++m) {
          const double* a = &A[(o * M + m) * 3];
          const double* b = &B[(o * M + m) * 3];
          const double* dh = &Dh[(o * M + m) * 3];
          const double ra[3] = {mid[0] - a[0], mid[1] - a[1], mid[2] - a[2]};
          const double rb[3] = {mid[0] - b[0], mid[1] - b[1], mid[2] - b[2]};
          const double cr[3] = {dh[1] * ra[2] - dh[2] * ra[1],
                                dh[2] * ra[0] - dh[0] * ra[2],
                                dh[0] * ra[1] - dh[1] * ra[0]};
          const double rho2 = std::max(
              cr[0] * cr[0] + cr[1] * cr[1] + cr[2] * cr[2], 1e-12);
          const double na = std::max(
              std::sqrt(ra[0] * ra[0] + ra[1] * ra[1] + ra[2] * ra[2]), 1e-12);
          const double nb = std::max(
              std::sqrt(rb[0] * rb[0] + rb[1] * rb[1] + rb[2] * rb[2]), 1e-12);
          const double cos_a =
              (dh[0] * ra[0] + dh[1] * ra[1] + dh[2] * ra[2]) / na;
          const double cos_b =
              (dh[0] * rb[0] + dh[1] * rb[1] + dh[2] * rb[2]) / nb;
          const double s = (cos_a - cos_b) / rho2;
          acc[0] += cr[0] * s;
          acc[1] += cr[1] * s;
          acc[2] += cr[2] * s;
        }
        out[p * n_obs + o] +=
            acc[0] * dl[0] + acc[1] * dl[1] + acc[2] * dl[2];
      }
    }
    for (int o = 0; o < n_obs; ++o)
      out[p * n_obs + o] /= 4.0 * M_PI;
  }
}

}  // extern "C"
