// Native conservative spherical remapping core (the port's copy of
// deepsphere_weather_tpu/native/geometry.cpp).
//
// C++ counterpart of sphere/remap.py's polygon clipping (the CDO
// replacement): for each candidate (dst, src) Voronoi-cell pair, clip the
// destination polygon against the source polygon with a spherical
// Sutherland-Hodgman pass (half-spaces are planes through the origin) and
// return the spherical overlap area via the signed van Oosterom-Strackee
// excess. This is the O(n_dst * k_candidates) setup-time hot spot when
// building pooling matrices for 100 km-class grids (HEALPix-64: 49k cells).
//
// Built at first use by native/build.py (g++, plain C interface).
// ABI: dsw_conservative_weights (see geometry.py ctypes signature).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Vec3 {
    double x, y, z;
};

inline Vec3 cross(const Vec3& a, const Vec3& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

inline double dot(const Vec3& a, const Vec3& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}

inline double norm(const Vec3& a) { return std::sqrt(dot(a, a)); }

inline Vec3 scale(const Vec3& a, double s) {
    return {a.x * s, a.y * s, a.z * s};
}

inline Vec3 sub(const Vec3& a, const Vec3& b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}

inline Vec3 add(const Vec3& a, const Vec3& b) {
    return {a.x + b.x, a.y + b.y, a.z + b.z};
}

// Clip polygon by half-space {p : n . p >= 0}; intersection points are the
// exact plane/great-circle intersections (chord intersection renormalized).
void clip_halfspace(std::vector<Vec3>& poly, const Vec3& n,
                    std::vector<Vec3>& out) {
    out.clear();
    const size_t m = poly.size();
    if (m == 0) return;
    std::vector<double> d(m);
    for (size_t i = 0; i < m; ++i) d[i] = dot(poly[i], n);
    for (size_t i = 0; i < m; ++i) {
        const size_t j = (i + 1) % m;
        const double di = d[i], dj = d[j];
        if (di >= 0) out.push_back(poly[i]);
        if ((di >= 0) != (dj >= 0)) {
            const double t = di / (di - dj);
            Vec3 p = add(poly[i], scale(sub(poly[j], poly[i]), t));
            const double nn = norm(p);
            if (nn > 1e-14) out.push_back(scale(p, 1.0 / nn));
        }
    }
    if (out.size() < 3) out.clear();
}

// Signed spherical polygon area (van Oosterom-Strackee over a centroid fan).
double polygon_area(const std::vector<Vec3>& poly) {
    const size_t m = poly.size();
    if (m < 3) return 0.0;
    Vec3 c{0, 0, 0};
    for (const auto& v : poly) c = add(c, v);
    const double nc = norm(c);
    if (nc < 1e-14) return 0.0;
    c = scale(c, 1.0 / nc);
    double area = 0.0;
    for (size_t i = 0; i < m; ++i) {
        const Vec3& a = poly[i];
        const Vec3& b = poly[(i + 1) % m];
        const double num = dot(cross(a, b), c);
        const double den = 1.0 + dot(a, c) + dot(a, b) + dot(b, c);
        area += 2.0 * std::atan2(num, den);
    }
    return area > 0.0 ? area : 0.0;
}

}  // namespace

extern "C" {

// Overlap areas for candidate (dst, src) polygon pairs.
// Polygons are flattened [sum_m, 3] with per-polygon offsets (CSR-style).
// Returns the number of pairs written (== n_pairs on success).
long long dsw_conservative_weights(
    const double* dst_flat, long long /*dst_total*/,
    const long long* dst_off, const double* dst_centers, long long /*n_dst*/,
    const double* src_flat, long long /*src_total*/,
    const long long* src_off, const double* src_centers, long long /*n_src*/,
    const long long* pairs, long long n_pairs, double* out_areas) {
    std::vector<Vec3> poly, tmp;
    for (long long p = 0; p < n_pairs; ++p) {
        const long long d = pairs[2 * p];
        const long long s = pairs[2 * p + 1];

        // load destination polygon
        poly.clear();
        for (long long i = dst_off[d]; i < dst_off[d + 1]; ++i) {
            poly.push_back({dst_flat[3 * i], dst_flat[3 * i + 1],
                            dst_flat[3 * i + 2]});
        }
        const Vec3 sc{src_centers[3 * s], src_centers[3 * s + 1],
                      src_centers[3 * s + 2]};

        // clip against each src edge's great-circle half-space
        const long long sm = src_off[s + 1] - src_off[s];
        for (long long e = 0; e < sm && !poly.empty(); ++e) {
            const long long i0 = src_off[s] + e;
            const long long i1 = src_off[s] + (e + 1) % sm;
            const Vec3 a{src_flat[3 * i0], src_flat[3 * i0 + 1],
                         src_flat[3 * i0 + 2]};
            const Vec3 b{src_flat[3 * i1], src_flat[3 * i1 + 1],
                         src_flat[3 * i1 + 2]};
            Vec3 n = cross(a, b);
            const double nn = norm(n);
            if (nn < 1e-12) continue;  // degenerate edge (duplicate vertex)
            n = scale(n, 1.0 / nn);
            if (dot(n, sc) < 0) n = scale(n, -1.0);
            clip_halfspace(poly, n, tmp);
            poly.swap(tmp);
        }
        out_areas[p] = polygon_area(poly);
    }
    return n_pairs;
}

}  // extern "C"
