// Per-kind intersection in a primitive's local frame, shared by the sweep
// (sweep.cu, which reads the frame from the packed table) and a round's
// shading kernel (round.cu, which recomputes the winner's t and its surface
// detail from the node record).  Each function takes the ray in the node's
// local frame and the t-range start already raised on the ray's source
// surface; the callers raise it each in their plain version's op order.
//
// Numerics: the op order of the plain PyTorch versions
// (ops/cuda_intersect.py, ops/intersect.py), every op rounded on its own
// (the sources are built with -fmad=false); selects are ternaries with
// torch.where's NaN behaviour and clamps keep a NaN, as torch.clamp does.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace geom {

__device__ __forceinline__ float fmin_sel(float a, float b) { return a < b ? a : b; }
__device__ __forceinline__ float fmax_sel(float a, float b) { return a > b ? a : b; }

// torch.clamp(x, min=lo) / (max=hi) / (lo, hi): a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clamp_to(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch.minimum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// n / d where d != 0, else +inf (_gd).
__device__ __forceinline__ float guarded_div(float n, float d) {
  return d != 0.0f ? n / d : CUDART_INF_F;
}

__device__ __forceinline__ bool in_range(float t, float t_min, float t_max) {
  return (t >= t_min) && (t < t_max);
}

// Smallest root of a t^2 + b t + c in [t_min, t_max) (math3d's
// smallest_root_in_range; linear fallback at a == 0).
__device__ __forceinline__ float smallest_root(float a, float b, float c,
                                               float t_min, float t_max) {
  const float inf = CUDART_INF_F;
  float disc = b * b - 4.0f * a * c;
  float sq = sqrtf(fmax_sel(disc, 0.0f));
  float sgn = b >= 0.0f ? 1.0f : -1.0f;
  float q = -0.5f * (b + sgn * sq);
  float safe_a = a == 0.0f ? 1.0f : a;
  float safe_q = q == 0.0f ? 1.0f : q;
  float ra = a == 0.0f ? inf : q / safe_a;
  float rb = q == 0.0f ? -b / (2.0f * safe_a) : c / safe_q;
  float r0 = fmin_sel(ra, rb);
  float r1 = fmax_sel(ra, rb);
  float safe_b = b == 0.0f ? 1.0f : b;
  float lin = b == 0.0f ? inf : -c / safe_b;
  bool quad_ok = (a != 0.0f) && (disc >= 0.0f);
  r0 = a == 0.0f ? lin : (quad_ok ? r0 : inf);
  r1 = a == 0.0f ? inf : (quad_ok ? r1 : inf);
  bool ok0 = (r0 >= t_min) && (r0 < t_max);
  bool ok1 = (r1 >= t_min) && (r1 < t_max);
  return ok0 ? r0 : (ok1 ? r1 : inf);
}

// A ray in a node's local frame.
struct Local {
  float ox, oy, oz, dx, dy, dz;
};

// The world ray (o, d) through the world -> local affine m [3, 4] row-major,
// m[r * 4 + c] read through `at` (a table's layout).
template <class At>
__device__ __forceinline__ Local to_local(At at, float ox, float oy, float oz, float dx,
                                          float dy, float dz) {
  float m[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) m[r] = at(r);
  Local l;
  l.ox = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
  l.oy = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
  l.oz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
  l.dx = m[0] * dx + m[1] * dy + m[2] * dz;
  l.dy = m[4] * dx + m[5] * dy + m[6] * dz;
  l.dz = m[8] * dx + m[9] * dy + m[10] * dz;
  return l;
}

// Unit sphere.
__device__ __forceinline__ float sphere(const Local& l, float t_min, float t_max) {
  float a = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
  float b = 2.0f * (l.ox * l.dx + l.oy * l.dy + l.oz * l.dz);
  float c = l.ox * l.ox + l.oy * l.oy + l.oz * l.oz - 1.0f;
  return smallest_root(a, b, c, t_min, t_max);
}

// Unit XZ square at y = 0 (plane.rs); eps_r = 0.5 + epsilon.
__device__ __forceinline__ float plane(const Local& l, float t_min, float t_max, float eps_r) {
  float t = guarded_div(-l.oy, l.dy);
  float px = l.ox + t * l.dx;
  float pz = l.oz + t * l.dz;
  bool ok = in_range(t, t_min, t_max) && (fabsf(px) <= eps_r) && (fabsf(pz) <= eps_r);
  return ok ? t : CUDART_INF_F;
}

// The 6-face fold in cube.rs FACES order (right, left, top, bottom, near,
// far), strictly smaller wins; containment skips the solved axis (on the
// plane by construction).  *face: the winning face, -1 for none.
__device__ __forceinline__ float cube(const Local& l, float t_min, float t_max, float eps_r,
                                      int* face = nullptr) {
  const float o3[3] = {l.ox, l.oy, l.oz};
  const float d3[3] = {l.dx, l.dy, l.dz};
  float best = CUDART_INF_F;
  int best_face = -1;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const int axis = f >> 1;
    const float sign = (f & 1) ? -0.5f : 0.5f;
    const float sg = (f & 1) ? -1.0f : 1.0f;
    float t = guarded_div(-(o3[axis] - sign) * sg, d3[axis] * sg);
    float p[3] = {l.ox + t * l.dx, l.oy + t * l.dy, l.oz + t * l.dz};
    bool contains = true;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax)
      if (ax != axis) contains = contains && (fabsf(p[ax]) <= eps_r);
    bool ok = in_range(t, t_min, t_max) && contains && (t < best);
    best = ok ? t : best;
    best_face = ok ? f : best_face;
  }
  if (face != nullptr) *face = best_face;
  return best;
}

// Cylinder: body quadratic (r = 0.5, |y| <= 0.5) and the two caps.  *part:
// 0 body, 1 top cap, 2 bottom cap (ops/intersect.py _cylinder_detail).
__device__ __forceinline__ float cylinder(const Local& l, float t_min, float t_max,
                                          int* part = nullptr) {
  const float R2 = 0.25f;
  float a = l.dx * l.dx + l.dz * l.dz;
  float b = 2.0f * (l.ox * l.dx + l.oz * l.dz);
  float c = l.ox * l.ox + l.oz * l.oz - R2;
  float t_body = smallest_root(a, b, c, t_min, t_max);
  float y = l.oy + t_body * l.dy;
  float best = (!(y > 0.5f) && !(y < -0.5f)) ? t_body : CUDART_INF_F;
  int best_part = 0;
#pragma unroll
  for (int cap = 0; cap < 2; ++cap) {
    const float h = cap == 0 ? 0.5f : -0.5f;
    float t = guarded_div(h - l.oy, l.dy);
    float px = l.ox + t * l.dx;
    float pz = l.oz + t * l.dz;
    bool ok = in_range(t, t_min, t_max) && !(px * px + pz * pz > R2);
    t = ok ? t : CUDART_INF_F;
    best_part = t < best ? cap + 1 : best_part;
    best = t < best ? t : best;
  }
  if (part != nullptr) *part = best_part;
  return best;
}

// Cone: body quadratic (apex at y = +0.5, r = 0.5 at y = -0.5) and the base
// cap (cone.rs:28-187).  *is_cap: the cap is nearer.
__device__ __forceinline__ float cone(const Local& l, float t_min, float t_max,
                                      bool* is_cap = nullptr) {
  const float r2 = 0.25f;
  float a = 4.0f * l.dy * l.dy * r2 - 4.0f * (l.dx * l.dx + l.dz * l.dz);
  float b = -8.0f * (l.dx * l.ox + l.dz * l.oz)
            - 1.0f * (l.dy * 1.0f - 2.0f * l.dy * l.oy);
  float c = -4.0f * (l.ox * l.ox + l.oz * l.oz)
            + r2 * (1.0f - 4.0f * l.oy + 4.0f * l.oy * l.oy);
  float t_body = smallest_root(a, b, c, t_min, t_max);
  float y = l.oy + t_body * l.dy;
  t_body = (!(y > 0.5f) && !(y < -0.5f)) ? t_body : CUDART_INF_F;
  float t_cap = guarded_div(-0.5f - l.oy, l.dy);
  float px = l.ox + t_cap * l.dx;
  float pz = l.oz + t_cap * l.dz;
  bool okc = in_range(t_cap, t_min, t_max) && !(px * px + pz * pz > r2);
  t_cap = okc ? t_cap : CUDART_INF_F;
  if (is_cap != nullptr) *is_cap = t_cap < t_body;
  return t_cap < t_body ? t_cap : t_body;
}

// arccos by Abramowitz-Stegun 4.4.45, as the TPU kernel computes it.
__device__ __forceinline__ float as_acos(float x) {
  float ax = clamp_to(fabsf(x), 0.0f, 1.0f);
  float p = -0.0012624911f;
  p = p * ax + 0.0066700901f;
  p = p * ax + -0.0170881256f;
  p = p * ax + 0.0308918810f;
  p = p * ax + -0.0501743046f;
  p = p * ax + 0.0889789874f;
  p = p * ax + -0.2145988016f;
  p = p * ax + 1.5707963050f;
  float r = p * sqrtf(1.0f - ax);
  return x < 0.0f ? 3.14159265358979f - r : r;
}

// Signed cube root through exp/log, as the TPU kernel computes it.
__device__ __forceinline__ float exp_cbrt(float x, float third) {
  float ax = clamp_min(fabsf(x), 1e-30f);
  float r = expf(logf(ax) * third);
  float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return x == 0.0f ? 0.0f : sgn * r;
}

// The torus quartic's coefficients (primitive/torus.rs:56-110): hole along
// y, center radius c_r, tube radius a_r.
struct Quartic {
  float A, B, C, D, E;
};

__device__ __forceinline__ Quartic torus_coeffs(const Local& l, float c_r, float a_r) {
  float dd = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
  float pp = l.ox * l.ox + l.oy * l.oy + l.oz * l.oz;
  float dp = l.dx * l.ox + l.dy * l.oy + l.dz * l.oz;
  float a2 = a_r * a_r;
  float c2 = c_r * c_r;
  float k = pp - (a2 + c2);
  Quartic q;
  q.A = dd * dd;
  q.B = 4.0f * dd * dp;
  q.C = 2.0f * dd * k + 4.0f * dp * dp + 4.0f * c2 * l.dy * l.dy;
  q.D = 4.0f * k * dp + 8.0f * c2 * l.oy * l.dy;
  q.E = k * k - 4.0f * c2 * (a2 - l.oy * l.oy);
  return q;
}

// The torus: Ferrari through the resolvent cubic, 2 resolvent and 3 root
// Newton steps.  Integer powers are products in XLA's integer_pow order;
// division by 3 and 27 multiplies by the f32 reciprocal, as the plain
// version (and PyTorch on CUDA for any scalar divisor) does.  acos_ and
// cbrt_ (cbrt_(x, 1/3)) are the arccos and signed cube root: the sweep's
// as_acos and exp_cbrt (torus below), or math3d's torch.acos and pow.
template <class Acos, class Cbrt>
__device__ __forceinline__ float torus_with(const Local& l, float c_r, float a_r, float t_min,
                                            float t_max, Acos acos_, Cbrt cbrt_) {
  const float inf = CUDART_INF_F;
  const float third = 1.0f / 3.0f;
  const float rcp27 = 1.0f / 27.0f;
  const Quartic qc4 = torus_coeffs(l, c_r, a_r);
  const float A = qc4.A, Bq = qc4.B, C4 = qc4.C, D = qc4.D, E = qc4.E;

  float safe_A = A == 0.0f ? 1.0f : A;
  float b = Bq / safe_A;
  float c = C4 / safe_A;
  float d_ = D / safe_A;
  float e = E / safe_A;
  float b2 = b * b;
  float p = c - 3.0f * b2 / 8.0f;
  float q = d_ - b * c / 2.0f + b2 * b / 8.0f;
  float r = e - b * d_ / 4.0f + b2 * c / 16.0f - 3.0f * b2 * b2 / 256.0f;

  // Resolvent cubic z^3 + 2p z^2 + (p^2-4r) z - q^2.
  float a2c = 2.0f * p;
  float a1c = p * p - 4.0f * r;
  float a0c = -q * q;
  float pc = a1c - a2c * a2c * third;
  float qc = 2.0f * (a2c * (a2c * a2c)) * rcp27 - a2c * a1c * third + a0c;
  float half_q = qc / 2.0f;
  float third_p = pc * third;
  float disc = half_q * half_q + third_p * (third_p * third_p);
  float safe_tp = clamp_max(third_p, -1e-30f);
  float mm = 2.0f * sqrtf(-safe_tp);
  float cos_arg = clamp_to(3.0f * qc / (pc * (pc == 0.0f ? 1.0f : mm)), -1.0f, 1.0f);
  float phi = acos_(cos_arg);
  float z_trig = mm * cosf(phi * third) - a2c * third;
  float sqd = sqrtf(clamp_min(disc, 0.0f));
  float z_card = cbrt_(-half_q + sqd, third) + cbrt_(-half_q - sqd, third) - a2c * third;
  float z = disc > 0.0f ? z_card : z_trig;
#pragma unroll
  for (int it = 0; it < 2; ++it) {  // polish the resolvent (Cardano cancellation)
    float fz = ((z + a2c) * z + a1c) * z + a0c;
    float fpz = (3.0f * z + 2.0f * a2c) * z + a1c;
    z = z - fz / (fpz == 0.0f ? 1.0f : fpz);
  }
  z = clamp_min(z, 0.0f);

  float sz = sqrtf(z);
  bool biquad = z < 1e-6f * (1.0f + fabsf(p));
  float s_safe = biquad ? 1.0f : sz;
  float half = (p + z) / 2.0f;
  float shift = q / (2.0f * s_safe);
  float c1 = half - shift;
  float c2q = half + shift;
  float d1 = sz * sz - 4.0f * c1;
  float sq1 = sqrtf(clamp_min(d1, 0.0f));
  float d2 = sz * sz - 4.0f * c2q;
  float sq2 = sqrtf(clamp_min(d2, 0.0f));
  float ydisc = p * p - 4.0f * r;
  float ysq = sqrtf(clamp_min(ydisc, 0.0f));
  float y1 = (-p - ysq) / 2.0f;
  float y2 = (-p + ysq) / 2.0f;
  bool okb1 = (ydisc >= 0.0f) && (y1 >= 0.0f);
  bool okb2 = (ydisc >= 0.0f) && (y2 >= 0.0f);
  float r1s = sqrtf(clamp_min(y1, 0.0f));
  float r2s = sqrtf(clamp_min(y2, 0.0f));
  bool ok12 = biquad ? okb1 : (d1 >= 0.0f);
  bool ok34 = biquad ? okb2 : (d2 >= 0.0f);

  const float us[4] = {biquad ? -r1s : (-sz - sq1) / 2.0f, biquad ? r1s : (-sz + sq1) / 2.0f,
                       biquad ? -r2s : (sz - sq2) / 2.0f, biquad ? r2s : (sz + sq2) / 2.0f};
  float best = inf;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float t = us[i] - b / 4.0f;
#pragma unroll
    for (int it = 0; it < 3; ++it) {  // Newton polish on the quartic
      float fv = (((A * t + Bq) * t + C4) * t + D) * t + E;
      float fp = ((4.0f * A * t + 3.0f * Bq) * t + 2.0f * C4) * t + D;
      t = t - fv / (fp == 0.0f ? 1.0f : fp);
    }
    bool ok = (i < 2 ? ok12 : ok34) && in_range(t, t_min, t_max);
    t = ok ? t : inf;
    best = t < best ? t : best;
  }
  return best;
}

// The sweep's torus (the TPU kernel's arccos and cube root).
__device__ __forceinline__ float torus(const Local& l, float c_r, float a_r, float t_min,
                                       float t_max) {
  return torus_with(l, c_r, a_r, t_min, t_max, as_acos, exp_cbrt);
}

}  // namespace geom
