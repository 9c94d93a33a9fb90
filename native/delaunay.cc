// Native runtime kernels of the deformable-reconstruction framework.
//
// 2D Delaunay triangulation (Bowyer-Watson) of the landmark cloud's (x, y)
// projection -- the host-side meshing step feeding the ARAP solver. Fills the
// role Qhull ("d Qbb Qt") plays in the reference (Geometry.cc:317-368): the
// caller keeps the original 3D vertices and only consumes triangle indices.
//
// Exposed via a plain C ABI for ctypes; no Python.h dependency.
//
// Build: see native/Makefile (g++ -O2 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Tri {
  int a, b, c;      // vertex indices (super-triangle verts are n..n+2)
  bool alive;
};

// Robust-enough incircle: determinant in long double with a relative epsilon.
// Points are landmark coordinates (meters, well-scaled); exact predicates are
// unnecessary at this tolerance but we guard near-degeneracy.
static bool in_circumcircle(const double* xy, int n_total, const double* px,
                            const double* py, int p, int a, int b, int c) {
  auto X = [&](int i) -> long double { return (long double)px[i]; };
  auto Y = [&](int i) -> long double { return (long double)py[i]; };
  (void)xy;
  (void)n_total;
  long double ax = X(a) - X(p), ay = Y(a) - Y(p);
  long double bx = X(b) - X(p), by = Y(b) - Y(p);
  long double cx = X(c) - X(p), cy = Y(c) - Y(p);
  long double d = (ax * ax + ay * ay) * (bx * cy - cx * by) -
                  (bx * bx + by * by) * (ax * cy - cx * ay) +
                  (cx * cx + cy * cy) * (ax * by - bx * ay);
  return d > 0.0L;
}

static long double orient2d(const double* px, const double* py, int a, int b, int c) {
  return ((long double)px[b] - px[a]) * ((long double)py[c] - py[a]) -
         ((long double)px[c] - px[a]) * ((long double)py[b] - py[a]);
}

}  // namespace

extern "C" {

// xy: n points, interleaved (x0, y0, x1, y1, ...).
// tri_out: capacity >= 2n + 16 triangles (3 ints each).
// Returns 0 on success; 1 = too few points; 2 = degenerate input.
int tids_delaunay2d(const double* xy, int n, int* tri_out, int* ntri_out) {
  if (n < 3) return 1;

  std::vector<double> px(n + 3), py(n + 3);
  double minx = 1e300, maxx = -1e300, miny = 1e300, maxy = -1e300;
  for (int i = 0; i < n; ++i) {
    px[i] = xy[2 * i];
    py[i] = xy[2 * i + 1];
    minx = std::min(minx, px[i]);
    maxx = std::max(maxx, px[i]);
    miny = std::min(miny, py[i]);
    maxy = std::max(maxy, py[i]);
  }
  double dx = maxx - minx, dy = maxy - miny;
  double dmax = std::max(dx, dy);
  if (dmax <= 0.0) return 2;
  double midx = (minx + maxx) / 2, midy = (miny + maxy) / 2;

  // Super-triangle comfortably containing all points.
  px[n] = midx - 4000 * dmax;
  py[n] = midy - 2000 * dmax;
  px[n + 1] = midx;
  py[n + 1] = midy + 4000 * dmax;
  px[n + 2] = midx + 4000 * dmax;
  py[n + 2] = midy - 2000 * dmax;

  std::vector<Tri> tris;
  tris.reserve(4 * n);
  tris.push_back({n, n + 1, n + 2, true});

  // Ensure CCW orientation for every triangle we keep.
  auto make_ccw = [&](Tri& t) {
    if (orient2d(px.data(), py.data(), t.a, t.b, t.c) < 0) std::swap(t.b, t.c);
  };
  make_ccw(tris[0]);

  struct Edge {
    int u, v;
  };

  // Insertion order: as given (points are landmark clouds, effectively random).
  for (int p = 0; p < n; ++p) {
    std::vector<Edge> boundary;
    boundary.reserve(32);
    // Collect edges of the cavity (triangles whose circumcircle contains p).
    for (auto& t : tris) {
      if (!t.alive) continue;
      if (in_circumcircle(nullptr, 0, px.data(), py.data(), p, t.a, t.b, t.c)) {
        t.alive = false;
        boundary.push_back({t.a, t.b});
        boundary.push_back({t.b, t.c});
        boundary.push_back({t.c, t.a});
      }
    }
    // Remove doubled (internal) edges; keep the cavity boundary.
    std::vector<Edge> hull;
    hull.reserve(boundary.size());
    for (size_t i = 0; i < boundary.size(); ++i) {
      bool dup = false;
      for (size_t j = 0; j < boundary.size(); ++j) {
        if (i == j) continue;
        if (boundary[i].u == boundary[j].v && boundary[i].v == boundary[j].u) {
          dup = true;
          break;
        }
      }
      if (!dup) hull.push_back(boundary[i]);
    }
    for (const auto& e : hull) {
      Tri t{e.u, e.v, p, true};
      // Skip exactly-degenerate slivers (collinear with the new point).
      if (orient2d(px.data(), py.data(), t.a, t.b, t.c) == 0.0L) continue;
      make_ccw(t);
      tris.push_back(t);
    }
  }

  int count = 0;
  for (const auto& t : tris) {
    if (!t.alive) continue;
    if (t.a >= n || t.b >= n || t.c >= n) continue;  // touches super-triangle
    tri_out[3 * count] = t.a;
    tri_out[3 * count + 1] = t.b;
    tri_out[3 * count + 2] = t.c;
    ++count;
  }
  *ntri_out = count;
  return 0;
}

}  // extern "C"
