// Native world-generation core: 3D line-of-sight + Theta* planner
// (the port's copy of native/theta_star.cpp; host code, no CUDA).
//
// The algorithm mirrors rvo3d_tpu_torch/worlds/gen/planner.py exactly
// (heap-based A* with the Theta* parent shortcut, cost
// F = kg*G + kh*H + ke*grid[n], insertion-counter tie-breaking) so the
// Python and native paths produce identical routes; tests assert equality.
//
// Built by g++ at first use into build/torch_kernels/ and loaded via ctypes
// (rvo3d_tpu_torch/worlds/gen/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <tuple>
#include <unordered_map>
#include <vector>

namespace {

struct Key {
  double f;
  int64_t counter;
  int64_t node;
};

struct KeyCmp {
  bool operator()(const Key& a, const Key& b) const {
    if (a.f != b.f) return a.f > b.f;   // min-heap on f
    return a.counter > b.counter;        // then FIFO like Python's heapq
  }
};

inline double dist3(double ay, double ax, double az, double by, double bx,
                    double bz) {
  const double dy = ay - by, dx = ax - bx, dz = az - bz;
  return std::sqrt(dy * dy + dx * dx + dz * dz);
}

}  // namespace

extern "C" {

// Line of sight on a [Y, X, Z] grid (row-major, value 1.0 == blocked).
// Parametric sampling at `samples_per_cell` resolution; 0.5 margins do not
// block. Returns 1 if free, 0 if blocked.
int los3d(const double* grid, int ys, int xs, int zs, double y0, double x0,
          double z0, double y1, double x1, double z1,
          double samples_per_cell) {
  const double d = dist3(y0, x0, z0, y1, x1, z1);
  int n = static_cast<int>(std::ceil(d * samples_per_cell)) + 1;
  if (n < 2) n = 2;
  for (int i = 0; i < n; ++i) {
    const double t = static_cast<double>(i) / (n - 1);
    int iy = static_cast<int>(std::floor(y0 + t * (y1 - y0)));
    int ix = static_cast<int>(std::floor(x0 + t * (x1 - x0)));
    int iz = static_cast<int>(std::floor(z0 + t * (z1 - z0)));
    if (iy < 0) iy = 0; else if (iy >= ys) iy = ys - 1;
    if (ix < 0) ix = 0; else if (ix >= xs) ix = xs - 1;
    if (iz < 0) iz = 0; else if (iz >= zs) iz = zs - 1;
    if (grid[(static_cast<int64_t>(iy) * xs + ix) * zs + iz] == 1.0) return 0;
  }
  return 1;
}

// Theta* plan. start/goal are (y, x, z) continuous coords (floored /
// ceiled to the grid like the Python path). Writes up to max_len (y, x, z)
// triples into out_path; returns the number of nodes, 0 if unreachable,
// -1 if out_path is too small.
int theta_star(const double* grid, int ys, int xs, int zs, double sy,
               double sx, double sz, double gy, double gx, double gz,
               double kg, double kh, double ke, double blocked_threshold,
               double samples_per_cell, int32_t* out_path, int max_len) {
  auto clampi = [](int v, int hi) { return v < 0 ? 0 : (v >= hi ? hi - 1 : v); };
  const int s_y = clampi(static_cast<int>(std::floor(sy)), ys);
  const int s_x = clampi(static_cast<int>(std::floor(sx)), xs);
  const int s_z = clampi(static_cast<int>(std::floor(sz)), zs);
  const int g_y = clampi(static_cast<int>(std::ceil(gy)), ys);
  const int g_x = clampi(static_cast<int>(std::ceil(gx)), xs);
  const int g_z = clampi(static_cast<int>(std::ceil(gz)), zs);

  const int64_t total = static_cast<int64_t>(ys) * xs * zs;
  auto idx = [xs, zs](int y, int x, int z) {
    return (static_cast<int64_t>(y) * xs + x) * zs + z;
  };
  auto node_y = [xs, zs](int64_t n) { return static_cast<int>(n / (static_cast<int64_t>(xs) * zs)); };
  auto node_x = [xs, zs](int64_t n) { return static_cast<int>((n / zs) % xs); };
  auto node_z = [zs](int64_t n) { return static_cast<int>(n % zs); };

  const int64_t start = idx(s_y, s_x, s_z);
  const int64_t goal = idx(g_y, g_x, g_z);

  std::vector<double> G(total, 1e300);
  std::vector<int64_t> parent(total, -1);
  std::vector<uint8_t> closed(total, 0);
  G[start] = 0.0;
  parent[start] = start;

  auto h = [&](int64_t n) {
    return dist3(node_y(n), node_x(n), node_z(n), g_y, g_x, g_z);
  };

  std::priority_queue<Key, std::vector<Key>, KeyCmp> open;
  int64_t counter = 0;
  open.push({kh * h(start), counter++, start});
  bool found = false;

  while (!open.empty()) {
    const Key top = open.top();
    open.pop();
    const int64_t cur = top.node;
    if (closed[cur]) continue;
    if (cur == goal) { found = true; break; }
    closed[cur] = 1;
    const int cy = node_y(cur), cx = node_x(cur), cz = node_z(cur);
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx)
        for (int dz = -1; dz <= 1; ++dz) {
          if (dy == 0 && dx == 0 && dz == 0) continue;
          const int ny = cy + dy, nx = cx + dx, nz = cz + dz;
          if (ny < 0 || ny >= ys || nx < 0 || nx >= xs || nz < 0 || nz >= zs)
            continue;
          const int64_t nb = idx(ny, nx, nz);
          if (closed[nb]) continue;
          if (grid[nb] >= blocked_threshold) continue;
          const int64_t par = parent[cur];
          int64_t cand_parent;
          double base;
          if (los3d(grid, ys, xs, zs, node_y(par), node_x(par), node_z(par),
                    ny, nx, nz, samples_per_cell)) {
            cand_parent = par;
            base = G[par];
          } else {
            cand_parent = cur;
            base = G[cur];
          }
          const double g_try =
              base + dist3(node_y(cand_parent), node_x(cand_parent),
                           node_z(cand_parent), ny, nx, nz);
          if (g_try < G[nb]) {
            G[nb] = g_try;
            parent[nb] = cand_parent;
            const double f = kg * g_try + kh * h(nb) + ke * grid[nb];
            open.push({f, counter++, nb});
          }
        }
  }

  if (!found) return 0;

  // backtrace
  std::vector<int64_t> rev;
  int64_t node = goal;
  rev.push_back(node);
  while (node != start) {
    node = parent[node];
    if (node < 0) return 0;
    rev.push_back(node);
  }
  const int n = static_cast<int>(rev.size());
  if (n > max_len) return -1;
  for (int i = 0; i < n; ++i) {
    const int64_t nd = rev[n - 1 - i];
    out_path[i * 3 + 0] = node_y(nd);
    out_path[i * 3 + 1] = node_x(nd);
    out_path[i * 3 + 2] = node_z(nd);
  }
  return n;
}

}  // extern "C"
