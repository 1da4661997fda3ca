// Minimal 3-vector / AABB toolkit for the host-side scene pipeline.
//
// TPU-native counterpart of the reference's host utilities
// (include/Utilities.h:26-102, include/AABB.h:23-163) — re-derived, not
// translated: only what the SBVH builder and loaders need.
#pragma once

#include <algorithm>
#include <cfloat>
#include <cmath>

namespace vtrace {

struct V3 {
  float x = 0.f, y = 0.f, z = 0.f;

  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
  float& operator[](int i) { return i == 0 ? x : (i == 1 ? y : z); }
};

inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline V3 vmin(V3 a, V3 b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(V3 a, V3 b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline float length(V3 a) { return std::sqrt(dot(a, a)); }
inline V3 normalize(V3 a) {
  float l = length(a);
  return l > 0.f ? a * (1.f / l) : V3{0.f, 0.f, 0.f};
}

// Axis-aligned bounding box, FLT_MAX-initialised so an empty box is invalid
// and extend() works without a first-point special case.
struct AABB {
  V3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  V3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};

  void extend(V3 p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  void extend(const AABB& b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  bool valid() const { return lo.x <= hi.x && lo.y <= hi.y && lo.z <= hi.z; }
  V3 size() const { return hi - lo; }
  V3 centroid() const { return (lo + hi) * 0.5f; }
  float surface_area() const {
    if (!valid()) return 0.f;
    V3 d = size();
    return 2.f * (d.x * d.y + d.y * d.z + d.z * d.x);
  }
  AABB intersect(const AABB& b) const {
    AABB r;
    r.lo = vmax(lo, b.lo);
    r.hi = vmin(hi, b.hi);
    return r;
  }
};

}  // namespace vtrace
