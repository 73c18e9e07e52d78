// Ray x packed-chunk sweep for Hopper (sm_90a): nearest-hit and any-hit.
//
// Replaces the TPU kernel of portrayer_tpu/ops/pallas_intersect.py
// (_make_kernel, launched by intersect_scene_pallas through pl.pallas_call)
// together with the XLA cull prologue around it.  It computes what that
// kernel computes -- per ray, the nearest (t, node, tri) over the packed
// chunk table, or whether any in-range hit exists -- and is not a
// block-by-block copy of it:
//
//  * One warp per ray; a chunk's columns go on the warp's lanes, as the TPU
//    kernel puts them on its vector lanes.  A crossed chunk takes
//    ceil(real_lanes / 32) steps; in a step lane l evaluates column
//    chunk * 128 + step * 32 + l, so each table row is one coalesced
//    128-byte line per warp, the id loads go out with the row loads, and
//    the switch on the packed kind is uniform across the warp.  The real
//    lanes of a chunk are a prefix (the lowering pads only a kind group's
//    tail), so a chunk with one primitive costs one step, not 128.  In a
//    tri_w chunk a step takes two columns a lane while more than 32 real
//    lanes are left: the two evaluations are independent, so the loads of
//    two steps are in flight together.  The triangle branch is short and
//    latency-bound, and this took 5-13% off a mesh launch on an H100;
//    done for every kind, it made big-scene's launches up to 20% and
//    torus-showcase's up to 50% slower (PERF.md, section 6).
//  * A two-level cull with the TPU prologue's conservative slab rule.
//    Chunks are grouped 32 to a group in table order (the lowering's SAH
//    order, so neighbours are near); a group's box is the exact elementwise
//    min/max of its members' boxes, and the rule is monotone in the box, so
//    a group passes whenever one of its chunks does.  The warp tests 32
//    group boxes a step, one per lane; for each crossed group, in ascending
//    order, its chunk boxes, one per lane; then sweeps the crossed chunks in
//    ascending order.  Tables of at most 32 chunks skip the group level.
//    Nearest mode also skips a crossed group or chunk whose entry lies
//    beyond the ray's best t so far (the prologue's t_max rule, with the
//    best t for t_max): no hit inside it is nearer.
//  * t stays exact f32 and the ids are read directly.  Nearest mode: a
//    step's (t, column) minimum is found with shuffles (ties to the lower
//    column) and folded into the ray's best with a strict <, which equals the
//    sequential strict-< fold over (chunk, lane) in table order: ties go to
//    the earlier column.  The TPU kernel's 2^-16 lane-tagged key was a
//    workaround for the TPU's lane reductions.  Any-hit mode: a ballot after
//    each step, and the warp leaves at the first hit.
//  * Every packed kind has a branch.  The torus branch is five times the
//    size of the others and would set the register count, and so the
//    occupancy, of every scene; it is instantiated only for tables that
//    hold a torus chunk (template flag HAS_TORUS), as the TPU kernel
//    compiles only the kinds present.
//
// Bound on this card: ~40-200 f32 ops per (ray, primitive) (~40 for a
// triangle, ~700 for a torus) and 5-14 table words per column, read as
// whole lines; the group boxes, chunk boxes and the table of a 73,729-
// triangle scene (6 MB) stay in L2.  A ray's work is a chain of dependent
// L2 round trips (group boxes, chunk boxes, then one per step), so the
// kernel is bound by latency, which the many resident warps (one per ray,
// four to a block) hide.
//
// Numerics: built with -fmad=false and written in the op order of the plain
// PyTorch version (ops/cuda_intersect.py: intersect_scene_sweep_ref), whose
// every op rounds once; IEEE division and sqrt (nvcc defaults).  Selects
// are written as ternaries with the same NaN behaviour as torch.where, and
// clamps as ternaries that keep a NaN, as torch.clamp does.  expf, logf and
// cosf (torus only) are CUDA's, which PyTorch's CUDA ops also call.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace {

constexpr int kChunk = 128;       // columns per chunk (PACK_CHUNK)
constexpr int kWarp = 32;         // lanes per warp; also chunks per group
// Rays (warps) per block, chosen by device time on an H100 against 2 and 8.
constexpr int kRaysPerBlock = 4;
// Blocks that ptxas plans to fit on an SM; with 4 (up to 128 registers a
// thread) no instantiation spills, where the default heuristics spilled 40
// bytes in one (CUDA 12.8).
constexpr int kMinBlocksPerSM = 4;
constexpr unsigned kFull = 0xffffffffu;

// Packed chunk kinds (scene/flatten.py).
constexpr int kSphereG = 0, kPlaneG = 1, kCubeG = 2, kCylinderG = 3, kConeG = 4, kTriW = 5,
              kTorusG = 6, kSphereW = 7, kAabox = 8;

struct Tables {
  const float* pf;        // [21, ncol] row-major
  const int* pid;         // [2, ncol]: node id, tri id
  const int* chunk_kind;  // [n_chunks]
  const float* cmin;      // [n_chunks, 3]
  const float* cmax;      // [n_chunks, 3]
  const float* gmin;      // [n_groups, 3]: min of 32 consecutive chunks' cmin
  const float* gmax;      // [n_groups, 3]
  const int* real_lanes;  // [n_chunks]: count of node ids >= 0, a prefix
  int n_chunks;
  int n_groups;
  int ncol;
};

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

struct Ray {
  float ox, oy, oz, dx, dy, dz, t_min, t_max;
  int src, srct;
};

struct Local {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float row(const Tables& tb, int r, int col) {
  return __ldg(tb.pf + (size_t)r * tb.ncol + col);
}

__device__ __forceinline__ Local local_frame(const Tables& tb, int col, const Ray& ry) {
  float m[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) m[r] = row(tb, r, col);
  Local l;
  l.ox = m[0] * ry.ox + m[1] * ry.oy + m[2] * ry.oz + m[3];
  l.oy = m[4] * ry.ox + m[5] * ry.oy + m[6] * ry.oz + m[7];
  l.oz = m[8] * ry.ox + m[9] * ry.oy + m[10] * ry.oz + m[11];
  l.dx = m[0] * ry.dx + m[1] * ry.dy + m[2] * ry.dz;
  l.dy = m[4] * ry.dx + m[5] * ry.dy + m[6] * ry.dz;
  l.dz = m[8] * ry.dx + m[9] * ry.dy + m[10] * ry.dz;
  return l;
}

// Self-intersection raise of the t-range start, in the source node's local
// units: max(t_min, self_eps / sqrt(max(|d_local|^2, 1e-30))).
__device__ __forceinline__ float general_tmin(float ld2, bool is_src, float t_min,
                                              float self_eps) {
  if (!is_src) return t_min;
  float t_self = self_eps * (1.0f / sqrtf(fmax_sel(ld2, 1e-30f)));
  return fmax_sel(t_min, t_self);
}

// sphere_g: unit sphere under a general affine (non-uniform scale).
__device__ __forceinline__ float sphere_g(const Tables& tb, int col, const Ray& ry, bool is_src,
                                          float self_eps) {
  Local l = local_frame(tb, col, ry);
  float a = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
  float b = 2.0f * (l.ox * l.dx + l.oy * l.dy + l.oz * l.dz);
  float c = l.ox * l.ox + l.oy * l.oy + l.oz * l.oz - 1.0f;
  return smallest_root(a, b, c, general_tmin(a, is_src, ry.t_min, self_eps), ry.t_max);
}

// plane_g: unit XZ square at y = 0 (plane.rs).
__device__ __forceinline__ float plane_g(const Tables& tb, int col, const Ray& ry, bool is_src,
                                         float eps_r, float self_eps) {
  Local l = local_frame(tb, col, ry);
  float t = guarded_div(-l.oy, l.dy);
  float px = l.ox + t * l.dx;
  float pz = l.oz + t * l.dz;
  float ld2 = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
  bool ok = in_range(t, general_tmin(ld2, is_src, ry.t_min, self_eps), ry.t_max) &&
            (fabsf(px) <= eps_r) && (fabsf(pz) <= eps_r);
  return ok ? t : CUDART_INF_F;
}

// cube_g: the 6-face fold in cube.rs FACES order; containment skips the
// solved axis (on the plane by construction).
__device__ __forceinline__ float cube_g(const Tables& tb, int col, const Ray& ry, bool is_src,
                                        float eps_r, float self_eps) {
  Local l = local_frame(tb, col, ry);
  float ld2 = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
  float t_min_e = general_tmin(ld2, is_src, ry.t_min, self_eps);
  const float o3[3] = {l.ox, l.oy, l.oz};
  const float d3[3] = {l.dx, l.dy, l.dz};
  float best = CUDART_INF_F;
#pragma unroll
  for (int face = 0; face < 6; ++face) {
    const int axis = face >> 1;
    const float sign = (face & 1) ? -0.5f : 0.5f;
    const float sg = (face & 1) ? -1.0f : 1.0f;
    float t = guarded_div(-(o3[axis] - sign) * sg, d3[axis] * sg);
    float p[3] = {l.ox + t * l.dx, l.oy + t * l.dy, l.oz + t * l.dz};
    bool contains = true;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax)
      if (ax != axis) contains = contains && (fabsf(p[ax]) <= eps_r);
    bool ok = in_range(t, t_min_e, ry.t_max) && contains && (t < best);
    best = ok ? t : best;
  }
  return best;
}

// cylinder_g: body quadratic (r = 0.5, |y| <= 0.5) and the two caps.
__device__ __forceinline__ float cylinder_g(const Tables& tb, int col, const Ray& ry, bool is_src,
                                            float self_eps) {
  Local l = local_frame(tb, col, ry);
  const float R2 = 0.25f;
  float a = l.dx * l.dx + l.dz * l.dz;
  float b = 2.0f * (l.ox * l.dx + l.oz * l.dz);
  float c = l.ox * l.ox + l.oz * l.oz - R2;
  float ld2 = a + l.dy * l.dy;
  float t_min_e = general_tmin(ld2, is_src, ry.t_min, self_eps);
  float t_body = smallest_root(a, b, c, t_min_e, ry.t_max);
  float y = l.oy + t_body * l.dy;
  float best = (!(y > 0.5f) && !(y < -0.5f)) ? t_body : CUDART_INF_F;
#pragma unroll
  for (int cap = 0; cap < 2; ++cap) {
    const float h = cap == 0 ? 0.5f : -0.5f;
    float t = guarded_div(h - l.oy, l.dy);
    float px = l.ox + t * l.dx;
    float pz = l.oz + t * l.dz;
    bool ok = in_range(t, t_min_e, ry.t_max) && !(px * px + pz * pz > R2);
    t = ok ? t : CUDART_INF_F;
    best = t < best ? t : best;
  }
  return best;
}

// cone_g: body quadratic (apex at y = +0.5, r = 0.5 at y = -0.5) and the
// base cap (cone.rs:28-187).
__device__ __forceinline__ float cone_g(const Tables& tb, int col, const Ray& ry, bool is_src,
                                        float self_eps) {
  Local l = local_frame(tb, col, ry);
  const float r2 = 0.25f;
  float a = 4.0f * l.dy * l.dy * r2 - 4.0f * (l.dx * l.dx + l.dz * l.dz);
  float b = -8.0f * (l.dx * l.ox + l.dz * l.oz)
            - 1.0f * (l.dy * 1.0f - 2.0f * l.dy * l.oy);
  float c = -4.0f * (l.ox * l.ox + l.oz * l.oz)
            + r2 * (1.0f - 4.0f * l.oy + 4.0f * l.oy * l.oy);
  float ld2 = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
  float t_min_e = general_tmin(ld2, is_src, ry.t_min, self_eps);
  float t_body = smallest_root(a, b, c, t_min_e, ry.t_max);
  float y = l.oy + t_body * l.dy;
  t_body = (!(y > 0.5f) && !(y < -0.5f)) ? t_body : CUDART_INF_F;
  float t_cap = guarded_div(-0.5f - l.oy, l.dy);
  float px = l.ox + t_cap * l.dx;
  float pz = l.oz + t_cap * l.dz;
  bool okc = in_range(t_cap, t_min_e, ry.t_max) && !(px * px + pz * pz > r2);
  t_cap = okc ? t_cap : CUDART_INF_F;
  return t_cap < t_body ? t_cap : t_body;
}

// tri_w: world triangle in its unit-triangle frame (rows 0..11 map o and d
// to (beta, gamma, w); zero for a degenerate triangle, which then has
// t = +inf).  The compares are written as !(x < 0) so that a NaN passes
// them, as in the TPU kernel.  The ray's source (node, triangle) pair is
// excluded outright: a ray leaving a planar triangle never re-hits it.
__device__ __forceinline__ float tri_w(const Tables& tb, int col, const Ray& ry, bool is_src) {
  Local l = local_frame(tb, col, ry);
  float t = guarded_div(-l.oz, l.dz);
  float beta = l.ox + t * l.dx;
  float gamma = l.oy + t * l.dy;
  bool ok = in_range(t, ry.t_min, ry.t_max) && !(beta < 0.0f) && !(gamma < 0.0f) &&
            !(beta + gamma > 1.0f) && !is_src;
  return ok ? t : CUDART_INF_F;
}

// sphere_w: world sphere (center rows 0..2, r^2 row 3, scale row 4);
// roots of t^2 + b t + c for unit directions.
__device__ __forceinline__ float sphere_w(const Tables& tb, int col, const Ray& ry, bool is_src,
                                          float self_eps) {
  float ocx = ry.ox - row(tb, 0, col);
  float ocy = ry.oy - row(tb, 1, col);
  float ocz = ry.oz - row(tb, 2, col);
  float b = 2.0f * (ocx * ry.dx + ocy * ry.dy + ocz * ry.dz);
  float c = ocx * ocx + ocy * ocy + ocz * ocz - row(tb, 3, col);
  float t_min_e = ry.t_min;
  if (is_src) t_min_e = fmax_sel(ry.t_min, self_eps * row(tb, 4, col));
  float disc = b * b - 4.0f * c;
  float sq = sqrtf(fmax_sel(disc, 0.0f));
  float sgn = b >= 0.0f ? 1.0f : -1.0f;
  float q = -0.5f * (b + sgn * sq);
  float safe_q = q == 0.0f ? 1.0f : q;
  float cq = c / safe_q;
  float r0 = fmin_sel(q, cq);
  float r1 = fmax_sel(q, cq);
  bool ok = disc >= 0.0f;
  bool ok0 = ok && (r0 >= t_min_e) && (r0 < ry.t_max);
  bool ok1 = ok && (r1 >= t_min_e) && (r1 < ry.t_max);
  return ok0 ? r0 : (ok1 ? r1 : CUDART_INF_F);
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

// torus_g: the quartic torus (primitive/torus.rs:56-110), center and tube
// radius in rows 12..13.  Ferrari through the resolvent cubic, 2 resolvent
// and 3 root Newton steps.  Integer powers are products in XLA's
// integer_pow order; division by 3 and 27 multiplies by the f32 reciprocal,
// as the plain version (and PyTorch on CUDA for any scalar divisor) does.
__device__ __forceinline__ float torus_g(const Tables& tb, int col, const Ray& ry, bool is_src,
                                         float self_eps) {
  const float inf = CUDART_INF_F;
  const float third = 1.0f / 3.0f;
  const float rcp27 = 1.0f / 27.0f;
  Local l = local_frame(tb, col, ry);
  const float c_r = row(tb, 12, col), a_r = row(tb, 13, col);
  float dd = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
  float pp = l.ox * l.ox + l.oy * l.oy + l.oz * l.oz;
  float dp = l.dx * l.ox + l.dy * l.oy + l.dz * l.oz;
  float t_min_e = general_tmin(dd, is_src, ry.t_min, self_eps);
  float a2 = a_r * a_r;
  float c2 = c_r * c_r;
  float k = pp - (a2 + c2);
  float A = dd * dd;
  float Bq = 4.0f * dd * dp;
  float C4 = 2.0f * dd * k + 4.0f * dp * dp + 4.0f * c2 * l.dy * l.dy;
  float D = 4.0f * k * dp + 8.0f * c2 * l.oy * l.dy;
  float E = k * k - 4.0f * c2 * (a2 - l.oy * l.oy);

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
  float phi = as_acos(cos_arg);
  float z_trig = mm * cosf(phi * third) - a2c * third;
  float sqd = sqrtf(clamp_min(disc, 0.0f));
  float z_card = exp_cbrt(-half_q + sqd, third) + exp_cbrt(-half_q - sqd, third) - a2c * third;
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
    bool ok = (i < 2 ? ok12 : ok34) && in_range(t, t_min_e, ry.t_max);
    t = ok ? t : inf;
    best = t < best ? t : best;
  }
  return best;
}

// aabox: slab test on the pack-time inflated world box (rows 0..2 min,
// 3..5 max) with the hoisted reciprocal directions; the entry face if in
// range, else the exit face (the cube's 6-face fold semantics).  The
// self-eps raise measures the direction in the box's local units (inverse
// scale rows 6..8).
__device__ __forceinline__ float aabox(const Tables& tb, int col, const Ray& ry, const float rcp[3],
                                       bool is_src, float self_eps) {
  float t1x = (row(tb, 0, col) - ry.ox) * rcp[0];
  float t2x = (row(tb, 3, col) - ry.ox) * rcp[0];
  float t1y = (row(tb, 1, col) - ry.oy) * rcp[1];
  float t2y = (row(tb, 4, col) - ry.oy) * rcp[1];
  float t1z = (row(tb, 2, col) - ry.oz) * rcp[2];
  float t2z = (row(tb, 5, col) - ry.oz) * rcp[2];
  float ten = nan_max(nan_max(nan_min(t1x, t2x), nan_min(t1y, t2y)), nan_min(t1z, t2z));
  float tex = nan_min(nan_min(nan_max(t1x, t2x), nan_max(t1y, t2y)), nan_max(t1z, t2z));
  float dlx = ry.dx * row(tb, 6, col);
  float dly = ry.dy * row(tb, 7, col);
  float dlz = ry.dz * row(tb, 8, col);
  float t_min_e = general_tmin(dlx * dlx + dly * dly + dlz * dlz, is_src, ry.t_min, self_eps);
  float t = ten >= t_min_e ? ten : tex;
  bool ok = (ten <= tex) && in_range(t, t_min_e, ry.t_max);
  return ok ? t : CUDART_INF_F;
}

// The conservative slab test of box i of (bmin, bmax) (the TPU prologue's
// rule): the box's entry distance less a slack, or NaN where the ray misses
// the box or leaves it before t_min.  The box is crossed iff the entry is
// <= t_max; no hit inside it is nearer than the entry.
__device__ __forceinline__ float box_entry(const float* bmin, const float* bmax, int i,
                                           const Ray& ry, const float rcp[3]) {
  const float o3[3] = {ry.ox, ry.oy, ry.oz};
  float ten = -CUDART_INF_F, tex = CUDART_INF_F;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    float ta = (__ldg(bmin + i * 3 + axis) - o3[axis]) * rcp[axis];
    float tb_ = (__ldg(bmax + i * 3 + axis) - o3[axis]) * rcp[axis];
    ten = fmax_sel(ten, fmin_sel(ta, tb_));
    tex = fmin_sel(tex, fmax_sel(ta, tb_));
  }
  float te = ten - (1e-4f * fabsf(ten) + 1e-5f);
  te = te > 0.0f ? te : 0.0f;
  return (ten <= tex) && (tex >= ry.t_min) ? te : CUDART_NAN_F;
}

__device__ __forceinline__ float safe_rcp(float dc) {
  float tiny = dc < 0.0f ? -1e-30f : 1e-30f;
  return 1.0f / (fabsf(dc) < 1e-30f ? tiny : dc);
}

// The branch of packed kind `kind` on column `col` (+inf: no hit).
template <bool HAS_TORUS>
__device__ __forceinline__ float eval_column(const Tables& tb, int kind, int col, const Ray& ry,
                                             const float rcp[3], bool is_src, float eps_r,
                                             float self_eps) {
  switch (kind) {
    case kSphereG: return sphere_g(tb, col, ry, is_src, self_eps);
    case kPlaneG: return plane_g(tb, col, ry, is_src, eps_r, self_eps);
    case kCubeG: return cube_g(tb, col, ry, is_src, eps_r, self_eps);
    case kCylinderG: return cylinder_g(tb, col, ry, is_src, self_eps);
    case kConeG: return cone_g(tb, col, ry, is_src, self_eps);
    case kTriW: return tri_w(tb, col, ry, is_src);
    case kTorusG:
      if constexpr (HAS_TORUS) return torus_g(tb, col, ry, is_src, self_eps);
      return CUDART_INF_F;
    case kSphereW: return sphere_w(tb, col, ry, is_src, self_eps);
    case kAabox: return aabox(tb, col, ry, rcp, is_src, self_eps);
    default: return CUDART_INF_F;
  }
}

// The warp's least (t, key) (no NaN), ties to the lower key; keys are
// distinct.  Returns the key, the same in every lane.
__device__ __forceinline__ int warp_argmin(float t, int key) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    float ot = __shfl_xor_sync(kFull, t, off);
    int ok = __shfl_xor_sync(kFull, key, off);
    if (ot < t || (ot == t && ok < key)) {
      t = ot;
      key = ok;
    }
  }
  return key;
}

// One warp per ray (warp w of block b: ray b * kRaysPerBlock + w); every
// branch below is uniform across the warp, so the shuffles and ballots see
// all 32 lanes.  src_node/src_tri null: no ray has a source surface (all
// -1).  HAS_TORUS: the tables hold a torus chunk (else the torus case is
// compiled out).  Nearest mode skips a crossed group or chunk whose entry
// lies beyond the ray's best t: it holds no nearer hit.
template <bool ANY_HIT, bool HAS_TORUS>
__global__ void __launch_bounds__(kWarp * kRaysPerBlock, kMinBlocksPerSM)
sweep_kernel(const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ t_min, const float* __restrict__ t_max,
             const bool* __restrict__ active, const int* __restrict__ src_node,
             const int* __restrict__ src_tri, Tables tb, int n_rays, float eps_r,
             float self_eps, float* __restrict__ out_t, int* __restrict__ out_node,
             int* __restrict__ out_tri, int* __restrict__ out_found) {
  const int lane = threadIdx.x % kWarp;
  const int i = blockIdx.x * kRaysPerBlock + threadIdx.x / kWarp;
  if (i >= n_rays) return;
  float best_t = CUDART_INF_F;
  int best_node = -1, best_tri = -1;
  bool found = false;
  if (active[i]) {
    Ray ry;
    ry.ox = o[3 * i]; ry.oy = o[3 * i + 1]; ry.oz = o[3 * i + 2];
    ry.dx = d[3 * i]; ry.dy = d[3 * i + 1]; ry.dz = d[3 * i + 2];
    ry.t_min = t_min[i];
    ry.t_max = t_max[i];
    ry.src = src_node != nullptr ? src_node[i] : -1;
    ry.srct = src_tri != nullptr ? src_tri[i] : -1;
    const float rcp[3] = {safe_rcp(ry.dx), safe_rcp(ry.dy), safe_rcp(ry.dz)};

    // Columns base .. base + N * 32 - 1 of chunk ci, N to a lane, each
    // evaluated by eval(column, is_src) where it is a real lane; true when
    // a hit ends an any-hit ray.  Nearest mode: a lane keeps its first
    // least t, the warp the least (t, column), folded into the best by a
    // strict <.
    auto step = [&](auto n, int ci, int real, int base, auto&& eval) -> bool {
      constexpr int N = decltype(n)::value;
      const int col0 = ci * kChunk + base + lane;
      int node[N], tri[N];
      float t[N];
#pragma unroll
      for (int u = 0; u < N; ++u) {
        node[u] = tri[u] = -1;
        t[u] = CUDART_INF_F;
        if (base + u * kWarp + lane < real) {
          node[u] = __ldg(tb.pid + col0 + u * kWarp);
          tri[u] = __ldg(tb.pid + tb.ncol + col0 + u * kWarp);
          t[u] = eval(col0 + u * kWarp, node[u] == ry.src && tri[u] == ry.srct);
        }
      }
      float lt = CUDART_INF_F;
      int lu = 0;
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const bool hit = node[u] >= 0 && t[u] < CUDART_INF_F;  // a NaN is a miss
        if (hit && t[u] < lt) {
          lt = t[u];
          lu = u;
        }
      }
      if (ANY_HIT) return __any_sync(kFull, lt < CUDART_INF_F);
      if (__any_sync(kFull, lt < best_t)) {
        const int win = warp_argmin(lt, lu * kWarp + lane);
        int wn = node[0], wt = tri[0];
#pragma unroll
        for (int u = 1; u < N; ++u) {
          wn = lu == u ? node[u] : wn;
          wt = lu == u ? tri[u] : wt;
        }
        best_t = __shfl_sync(kFull, lt, win % kWarp);
        best_node = __shfl_sync(kFull, wn, win % kWarp);
        best_tri = __shfl_sync(kFull, wt, win % kWarp);
      }
      return false;
    };
    // Sweep chunk ci.  A tri_w chunk takes two columns a lane while more
    // than 32 real lanes are left (kChunk is a multiple of 64, so they
    // stay in the chunk); every other step one.
    auto sweep_chunk = [&](int ci) -> bool {
      const int kind = __ldg(tb.chunk_kind + ci);
      const int real = __ldg(tb.real_lanes + ci);
      int base = 0;
      if (kind == kTriW) {
        auto tri = [&](int col, bool is_src) { return tri_w(tb, col, ry, is_src); };
        for (; base + kWarp < real; base += 2 * kWarp)
          if (step(std::integral_constant<int, 2>{}, ci, real, base, tri)) return true;
      }
      auto any = [&](int col, bool is_src) {
        return eval_column<HAS_TORUS>(tb, kind, col, ry, rcp, is_src, eps_r, self_eps);
      };
      for (; base < real; base += kWarp)
        if (step(std::integral_constant<int, 1>{}, ci, real, base, any)) return true;
      return false;
    };
    // Boxes first..first+31 of (bmin, bmax), one per lane: the crossed
    // ones in ascending order go to visit(index); true ends the ray.
    auto cull = [&](const float* bmin, const float* bmax, int first, int count,
                    auto&& visit) -> bool {
      const int b = first + lane;
      const float e = b < count ? box_entry(bmin, bmax, b, ry, rcp) : CUDART_NAN_F;
      for (unsigned m = __ballot_sync(kFull, e <= ry.t_max); m != 0; m &= m - 1) {
        const int l = __ffs(m) - 1;
        const float el = __shfl_sync(kFull, e, l);
        if (!ANY_HIT && el > best_t) continue;
        if (visit(first + l)) return true;
      }
      return false;
    };
    auto group = [&](int g) {
      return cull(tb.cmin, tb.cmax, g * kWarp, tb.n_chunks, sweep_chunk);
    };
    if (tb.n_groups <= 1) {
      found = group(0);
    } else {
      for (int g0 = 0; g0 < tb.n_groups && !found; g0 += kWarp)
        found = cull(tb.gmin, tb.gmax, g0, tb.n_groups, group);
    }
  }
  if (lane != 0) return;
  if (ANY_HIT) {
    out_found[i] = found ? 1 : 0;
  } else {
    out_t[i] = best_t;
    out_node[i] = best_node;
    out_tri[i] = best_tri;
  }
}

template <bool ANY_HIT>
int launch(const float* o, const float* d, const float* t_min, const float* t_max,
           const bool* active, const int* src_node, const int* src_tri, const Tables& tb,
           int n_rays, float eps_r, float self_eps, int has_torus, float* out_t, int* out_node,
           int* out_tri, int* out_found, void* stream) {
  if (n_rays <= 0) return 0;
  dim3 grid((n_rays + kRaysPerBlock - 1) / kRaysPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = has_torus ? sweep_kernel<ANY_HIT, true> : sweep_kernel<ANY_HIT, false>;
  kernel<<<grid, kWarp * kRaysPerBlock, 0, s>>>(o, d, t_min, t_max, active, src_node, src_tri,
                                                 tb, n_rays, eps_r, self_eps, out_t, out_node,
                                                 out_tri, out_found);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns cudaGetLastError()
// after the launch; src_node/src_tri may be null (no self-intersection raise);
// group_min/group_max/real_lanes come from ops/cuda_intersect.py
// (chunk_groups); has_torus != 0 when a chunk of chunk_kind is a torus.
extern "C" int sweep_nearest(const float* o, const float* d, const float* t_min,
                             const float* t_max, const bool* active, const int* src_node,
                             const int* src_tri, const float* pf, const int* pid,
                             const int* chunk_kind, const float* cmin, const float* cmax,
                             const float* group_min, const float* group_max,
                             const int* real_lanes, int n_rays, int n_chunks, int n_groups,
                             int ncol, float eps_r, float self_eps, int has_torus,
                             float* out_t, int* out_node, int* out_tri, void* stream) {
  const Tables tb{pf, pid, chunk_kind, cmin, cmax, group_min, group_max, real_lanes,
                  n_chunks, n_groups, ncol};
  return launch<false>(o, d, t_min, t_max, active, src_node, src_tri, tb, n_rays, eps_r,
                       self_eps, has_torus, out_t, out_node, out_tri, nullptr, stream);
}

extern "C" int sweep_any_hit(const float* o, const float* d, const float* t_min,
                             const float* t_max, const bool* active, const int* src_node,
                             const int* src_tri, const float* pf, const int* pid,
                             const int* chunk_kind, const float* cmin, const float* cmax,
                             const float* group_min, const float* group_max,
                             const int* real_lanes, int n_rays, int n_chunks, int n_groups,
                             int ncol, float eps_r, float self_eps, int has_torus,
                             int* out_found, void* stream) {
  const Tables tb{pf, pid, chunk_kind, cmin, cmax, group_min, group_max, real_lanes,
                  n_chunks, n_groups, ncol};
  return launch<true>(o, d, t_min, t_max, active, src_node, src_tri, tb, n_rays, eps_r,
                      self_eps, has_torus, nullptr, nullptr, nullptr, out_found, stream);
}
