// Native geometry engine: the GEOS-replacement primitives the data layer needs.
//
// The reference leans on shapely/GEOS (C++) for point-in-polygon masks,
// polygon-overlay intersection areas (LF->HF max-overlap resampling,
// gpras/preprocess.py:390-398), and rasterization. GEOS is not available in
// this image, so these hot host-side predicates are implemented here and
// exposed through a C ABI consumed via ctypes (gpras_tpu/native/__init__.py).
//
// Functions:
//   pip_batch          - ray-casting point-in-polygon over a batch of points
//   clip_area_convex   - Sutherland-Hodgman clip of a polygon by a CONVEX
//                        clip polygon; returns the intersection area
//   best_overlap_batch - for each query cell (convex), the index of the
//                        candidate cell with the largest intersection area
//                        (exact max-overlap pairing; candidates pre-filtered
//                        by bounding box on the Python side)
//   segments_intersect_poly - does any segment of a polyline cross/enter a
//                        polygon (centerline-cell test)
//
// Build: g++ -O3 -shared -fPIC geometry.cpp -o libgprasgeom.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

inline double cross(const Pt &o, const Pt &a, const Pt &b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

double polygon_area(const std::vector<Pt> &poly) {
  double s = 0.0;
  const size_t n = poly.size();
  for (size_t i = 0; i < n; ++i) {
    const Pt &p = poly[i];
    const Pt &q = poly[(i + 1) % n];
    s += p.x * q.y - q.x * p.y;
  }
  return std::fabs(s) * 0.5;
}

// Sutherland-Hodgman: clip `subject` by each directed edge of the convex
// `clip` polygon (counter-clockwise orientation enforced by the caller).
std::vector<Pt> clip_polygon(std::vector<Pt> subject, const std::vector<Pt> &clip) {
  const size_t nc = clip.size();
  for (size_t e = 0; e < nc && !subject.empty(); ++e) {
    const Pt &a = clip[e];
    const Pt &b = clip[(e + 1) % nc];
    std::vector<Pt> out;
    out.reserve(subject.size() + 4);
    const size_t ns = subject.size();
    for (size_t i = 0; i < ns; ++i) {
      const Pt &p = subject[i];
      const Pt &q = subject[(i + 1) % ns];
      const double dp = cross(a, b, p);
      const double dq = cross(a, b, q);
      if (dp >= 0.0) {
        out.push_back(p);
        if (dq < 0.0) {
          const double t = dp / (dp - dq);
          out.push_back({p.x + t * (q.x - p.x), p.y + t * (q.y - p.y)});
        }
      } else if (dq >= 0.0) {
        const double t = dp / (dp - dq);
        out.push_back({p.x + t * (q.x - p.x), p.y + t * (q.y - p.y)});
      }
    }
    subject.swap(out);
  }
  return subject;
}

std::vector<Pt> to_ccw(const double *ring, int n) {
  std::vector<Pt> poly(n);
  for (int i = 0; i < n; ++i) poly[i] = {ring[2 * i], ring[2 * i + 1]};
  // signed area; reverse if clockwise
  double s = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt &p = poly[i];
    const Pt &q = poly[(i + 1) % n];
    s += p.x * q.y - q.x * p.y;
  }
  if (s < 0.0) {
    for (int i = 0, j = n - 1; i < j; ++i, --j) std::swap(poly[i], poly[j]);
  }
  return poly;
}

bool point_in_poly(const std::vector<Pt> &poly, double x, double y) {
  bool inside = false;
  const size_t n = poly.size();
  for (size_t i = 0, j = n - 1; i < n; j = i++) {
    const Pt &pi = poly[i];
    const Pt &pj = poly[j];
    if (((pi.y > y) != (pj.y > y)) &&
        (x < (pj.x - pi.x) * (y - pi.y) / (pj.y - pi.y) + pi.x)) {
      inside = !inside;
    }
  }
  return inside;
}

static bool on_segment(const Pt &p, const Pt &q, const Pt &r) {
  // r collinear with pq: does r lie within the segment's bounding box?
  return std::min(p.x, q.x) <= r.x && r.x <= std::max(p.x, q.x) &&
         std::min(p.y, q.y) <= r.y && r.y <= std::max(p.y, q.y);
}

bool segs_cross(const Pt &a, const Pt &b, const Pt &c, const Pt &d) {
  const double d1 = cross(c, d, a);
  const double d2 = cross(c, d, b);
  const double d3 = cross(a, b, c);
  const double d4 = cross(a, b, d);
  if (((d1 > 0) != (d2 > 0)) && ((d3 > 0) != (d4 > 0))) return true;
  // Degenerate/touching cases (exact zeros are common on axis-aligned
  // HEC-RAS grids): a vertex lying exactly on the other segment counts as a
  // crossing — inclusive is the safe direction for touch queries.
  if (d1 == 0 && on_segment(c, d, a)) return true;
  if (d2 == 0 && on_segment(c, d, b)) return true;
  if (d3 == 0 && on_segment(a, b, c)) return true;
  if (d4 == 0 && on_segment(a, b, d)) return true;
  return false;
}

}  // namespace

extern "C" {

// points (npts, 2) -> out[i] = 1 if inside ring (nring vertices, closed or open)
void pip_batch(const double *ring, int nring, const double *pts, int npts,
               uint8_t *out) {
  std::vector<Pt> poly(nring);
  for (int i = 0; i < nring; ++i) poly[i] = {ring[2 * i], ring[2 * i + 1]};
  for (int i = 0; i < npts; ++i) {
    out[i] = point_in_poly(poly, pts[2 * i], pts[2 * i + 1]) ? 1 : 0;
  }
}

// intersection area of `subject` (any simple polygon) with CONVEX `clip`
double clip_area_convex(const double *subject, int ns, const double *clip,
                        int nc) {
  std::vector<Pt> subj(ns);
  for (int i = 0; i < ns; ++i) subj[i] = {subject[2 * i], subject[2 * i + 1]};
  std::vector<Pt> cl = to_ccw(clip, nc);
  std::vector<Pt> inter = clip_polygon(std::move(subj), cl);
  if (inter.size() < 3) return 0.0;
  return polygon_area(inter);
}

// For each query polygon (flattened, padded vertex arrays), find the candidate
// polygon with the largest intersection area.
//   q_verts  : (nq * max_qv * 2) doubles, padded entries repeat the first vertex
//   q_counts : (nq) vertex counts
//   c_verts / c_counts: same encoding for the ncand candidate polygons
//   cand_idx : (nq * max_cand) candidate-polygon indices, -1 padded
//   out_best : (nq) winning candidate index (or -1 when no overlap)
//   out_area : (nq) winning overlap area
void best_overlap_batch(const double *q_verts, const int *q_counts, int nq,
                        int max_qv, const double *c_verts, const int *c_counts,
                        int /*ncand*/, int max_cv, const int *cand_idx,
                        int max_cand, int *out_best, double *out_area) {
  for (int q = 0; q < nq; ++q) {
    const double *qs = q_verts + (size_t)q * max_qv * 2;
    const int qn = q_counts[q];
    std::vector<Pt> qpoly = to_ccw(qs, qn);  // query cell: the convex clip
    double best_area = 0.0;
    int best = -1;
    for (int k = 0; k < max_cand; ++k) {
      const int c = cand_idx[(size_t)q * max_cand + k];
      if (c < 0) continue;
      const int cn = c_counts[c];
      const double *cs = c_verts + (size_t)c * max_cv * 2;
      std::vector<Pt> subj(cn);
      for (int i = 0; i < cn; ++i) subj[i] = {cs[2 * i], cs[2 * i + 1]};
      std::vector<Pt> inter = clip_polygon(std::move(subj), qpoly);
      if (inter.size() < 3) continue;
      const double a = polygon_area(inter);
      if (a > best_area) {
        best_area = a;
        best = c;
      }
    }
    out_best[q] = best;
    out_area[q] = best_area;
  }
}

// 1 if any polyline segment crosses a polygon edge or has an endpoint inside
int polyline_touches_poly(const double *line, int nline, const double *ring,
                          int nring) {
  std::vector<Pt> poly(nring);
  for (int i = 0; i < nring; ++i) poly[i] = {ring[2 * i], ring[2 * i + 1]};
  for (int i = 0; i < nline; ++i) {
    if (point_in_poly(poly, line[2 * i], line[2 * i + 1])) return 1;
  }
  for (int i = 0; i + 1 < nline; ++i) {
    Pt a{line[2 * i], line[2 * i + 1]};
    Pt b{line[2 * i + 2], line[2 * i + 3]};
    for (int j = 0; j < nring; ++j) {
      Pt c = poly[j];
      Pt d = poly[(j + 1) % nring];
      if (segs_cross(a, b, c, d)) return 1;
    }
  }
  return 0;
}

}  // extern "C"
