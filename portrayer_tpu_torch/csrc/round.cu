// A bounce round's lane work in two launches, on either side of the any-hit
// sweep: the plain chain of ops/trace.py (_round_shade, _apply_shadows,
// _compact), ops/intersect.py (hit_detail) and ops/shade.py (shade_pre),
// hundreds of small PyTorch kernels a round, which stays the plain version.
// Not a port of a TPU kernel: the JAX package leaves this chain to XLA,
// which fuses it.
//
// shade_round   one thread a lane of the (head slice of the) queue: the
//               winner's t recomputed from the node record (the sweep's t
//               the fallback), the hit point, the normal, uv and tangent
//               frame of the record's kind (switched per lane), the uv
//               transform, the image-texture and normal-map atlases, the
//               background, miss and ambient terms added to acc, the area-
//               light and glossy draws (threefry.cuh: rng.draw_lanes' bits),
//               Lambert/Blinn-Phong per light, Schlick/TIR; it writes the
//               shadow rays in the [L * R] layout of the any-hit sweep, the
//               throughput-weighted light contributions lc [L, R, 3] and the
//               2R children (reflected at i, refracted at R + i) with their
//               take flags (w > 0).
// resolve_round adds the unoccluded lc, summed over the lights, to acc, and
//               places the taken children in the next queue in order (slot
//               = the inclusive prefix of the take flags less one), the dead
//               slots filled with _FILL's values; with a dropping threshold
//               (the queue's children outnumber its capacity) the live
//               children left out add their throughput times the background
//               to acc and to `dropped`.
//
// acc: a bounce round adds to acc[pix] with atomics (the plain version's
// index_add, itself atomic on the card), or, under PyTorch's deterministic
// algorithms, leaves each lane's terms in `x` and `light` for the wrapper's
// index_add_; round 0 on a pixel-major queue of spp_c samples a pixel sums
// each pixel's lanes in order in one thread of resolve_round (shade_round
// leaves each lane's term in `x`), as the plain version sums by reshape.
//
// Numerics: the plain version's op order, every op rounded on its own
// (-fmad=false); a division by a Python scalar multiplies by its f32
// reciprocal, as PyTorch on CUDA does; `scalar / tensor` is the reciprocal
// times the scalar (Tensor.__rtruediv__).  atan2f, acosf and powf are CUDA's;
// PyTorch's kernels call the same functions, built with other flags, so a
// texel's sRGB power or a specular power may differ in its last bit.
//
// Bound on this card: a lane reads its queue entry (48 B), hit (12 B), node
// record (136 B, from L2), a triangle record (104 B) and texels where its
// kind and material have them, and writes L shadow rays (33 B each), lc (12
// B a light) and two children (2 x 48 B); resolve_round reads them back and
// writes the next queue (48 B a slot).  Both are bound by memory, a few MB a
// round, a few microseconds at 3.35 TB/s: at the renderer's sizes by their
// launch latency.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "geometry.cuh"
#include "threefry.cuh"

// The argument structs are the C entry points' parameter types, outside
// the anonymous namespace: a function whose type names an internal type
// is not exported.

// Everything shade_round reads and writes.  Pointers first, then 64-bit,
// then 32-bit fields: ops/cuda_round.py mirrors this layout with ctypes.
struct ShadeArgs {
  const float* o;          // [R, 3] queue
  const float* d;          // [R, 3]
  const float* w;          // [R]
  const int* pix;          // [R]
  const float* t_min;      // [R]
  const int* src_node;     // [R]
  const int* src_tri;      // [R]
  const int* sid;          // [R]
  const float* hit_t;      // [R] the nearest-hit sweep's t
  const int* hit_node;     // [R] (-1: no hit)
  const int* hit_tri;      // [R]
  const bool* hit_mask;    // [R], or null: isfinite(t) && w > 0
  const float* rec;        // [N, 34]
  const float* trec;       // [T, 26], or null without meshes
  const unsigned char* tex_data;  // [P, 3] u8
  const int* tex_meta;     // [K, 3] (offset, w, h)
  const unsigned char* nm_data;
  const int* nm_meta;
  const float* light_pos;  // [L, 3]
  const float* light_color;
  const float* light_falloff;
  const float* light_area_a;
  const float* light_area_b;
  const float* ambient;    // [3]
  const float* bg;         // [n_pixels, 3]
  const long long* key;    // the round's key, or null: (k1, k2) by value
  float* acc;              // [n_pixels, 3]: bounce rounds add here
  float* x;                // [R, 3] each lane's term, or null: added to acc
  float* sh_o;             // [L * R, 3] shadow rays
  float* sh_d;
  float* sh_t;             // [L * R] t-range starts
  bool* sh_need;           // [L * R]
  int* sh_src_node;
  int* sh_src_tri;
  float* lc;               // [L, R, 3]
  float* c_o;              // [2R, 3] children
  float* c_d;
  float* c_w;              // [2R]
  int* c_pix;
  float* c_t;
  int* c_src_node;
  int* c_src_tri;
  int* c_sid;
  int* take;               // [2R] w > 0, or null
  unsigned long long* counts;  // [2]: shade_round, resolve_round launches
  long long key_word;      // the key's word stride
  long long n;             // lanes R
  unsigned int k1, k2;     // the key's words where key is null
  float epsilon;
  float eps_rel;
  float self_eps;          // self_eps_local (0: no raise)
  float eps_r;             // 0.5 + epsilon, f32
  int spp_c;               // samples a pixel of a pixel-major round 0, else 0
  int n_lights;
  int area;                // bit li: light li is an area light
  int is_last;             // the last round: no children
  int flags;               // kReflective | kRefractive | ...
};

// Everything resolve_round reads and writes (the same ordering rule).
struct ResolveArgs {
  const void* occ;         // [L * R]: the any-hit sweep's found (int32) or bool
  const float* lc;         // [L, R, 3]
  const float* x;          // [R, 3] (spp_c > 0)
  float* acc;              // [n_pixels, 3]
  float* light;            // [R, 3] each lane's light (spp_c 0), or null: added to acc
  const float* bg;         // [n_pixels, 3]
  const int* pix;          // [R] the lanes' pixels: the children's first R, or in the
                           // last round the queue's (never the next queue, which a
                           // round of equal capacity writes over its own)
  const float* c_o;        // [2R, 3] children
  const float* c_d;
  const float* c_w;
  const int* c_pix;
  const float* c_t;
  const int* c_src_node;
  const int* c_src_tri;
  const int* c_sid;
  const int* pos;          // [2R] inclusive prefix of the take flags, or null
  float* q_o;              // [cap, 3] the next queue
  float* q_d;
  float* q_w;
  int* q_pix;
  float* q_t;
  int* q_src_node;
  int* q_src_tri;
  int* q_sid;
  long long* n_live;       // [1]
  float* dropped;          // [1] (zeroed), or null: no threshold
  unsigned long long* counts;
  long long n;             // lanes R
  long long cap;           // the next queue's capacity
  long long n_pixels;
  int n_lights;
  int spp_c;
  int occ_is_int;
};

namespace {

using geom::clamp_min;
using geom::clamp_to;
using geom::Local;
using geom::nan_max;

constexpr int kThreads = 128;
constexpr int kRec = 34;   // node record width (scene/flatten.py node_record)
constexpr int kTrec = 26;  // triangle record width (tri_record)
constexpr int kSphere = 0, kPlane = 1, kCube = 2, kCylinder = 3, kCone = 4, kMesh = 5,
              kTorus = 6;
// Flags of ShadeArgs::flags (the scene's SceneTables.any_* flags).
constexpr int kReflective = 1, kRefractive = 2, kGlossy = 4, kImageTex = 8, kNormalMap = 16;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return v3(s * a.x, s * a.y, s * a.z); }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return v3(a.x / s, a.y / s, a.z / s); }
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
// math3d.norm(v, eps) for eps 1e-20 or 1e-30: |v|^2 clamped at 1.2e-38.
__device__ __forceinline__ float norm_eps(V3 v) { return sqrtf(clamp_min(dot(v, v), 1.2e-38f)); }
__device__ __forceinline__ V3 normalize(V3 v) { return v / norm_eps(v); }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}
__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ float comp(V3 v, int i) { return i == 0 ? v.x : (i == 1 ? v.y : v.z); }
// m [3, 3] (columns c0, c1, c2) times v: math3d.matvec3's op order.
__device__ __forceinline__ V3 matvec_cols(V3 c0, V3 c1, V3 c2, V3 v) {
  return v.x * c0 + v.y * c1 + v.z * c2;
}
// math3d's arccos and signed cube root on the card: torch.acos, and
// sign(x) * |x|^(1/3) by torch.pow with the exponent 1/3 in f32.
__device__ __forceinline__ float torch_acos(float x) { return acosf(x); }
__device__ __forceinline__ float torch_cbrt(float x, float) {
  const float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : (x == 0.0f ? 0.0f : x));
  return sgn * powf(fabsf(x), (float)(1.0 / 3.0));
}
// Division by a Python scalar s on the card: times its f32 reciprocal.
__device__ __forceinline__ float div_scalar(float x, float s) { return x * (1.0f / s); }

// The hit's surface in the node's local frame (ops/intersect.py HitDetail):
// the local normal, uv, tangent frame (columns nmt0..2) and flags.
struct Surface {
  V3 n;
  float u, v;
  bool has_uv, has_nmt;
  V3 nmt0, nmt1, nmt2;
};

__device__ __forceinline__ void identity_frame(Surface& s) {
  s.nmt0 = v3(1.0f, 0.0f, 0.0f);
  s.nmt1 = v3(0.0f, 1.0f, 0.0f);
  s.nmt2 = v3(0.0f, 0.0f, 1.0f);
}

// The sphere's and the cube's tangent frame (sphere.rs:72-96,
// cube.rs:111-136): to_top = normalize((0, 1, 0) - p), degenerate at the
// poles; `up` picks the pole's third column.
__device__ __forceinline__ void pole_frame(Surface& s, V3 p, V3 n, bool up, float eps) {
  V3 to_top = normalize(v3(-p.x, 1.0f - p.y, -p.z));
  bool degenerate = (fabsf(to_top.x) < eps) && (fabsf(to_top.z) < eps);
  V3 h_tan = cross(to_top, n);
  V3 v_tan = cross(n, h_tan);
  V3 pole = up ? v3(0.0f, 0.0f, 1.0f) : v3(0.0f, 0.0f, -1.0f);
  s.nmt0 = sel(degenerate, v3(1.0f, 0.0f, 0.0f), h_tan);
  s.nmt1 = n;
  s.nmt2 = sel(degenerate, pole, v_tan);
}

// Cube face uv (cube.rs FACES): per face, the uv axes' signs and offsets.
__constant__ float kFaceUv[6][4] = {
    {-1.0f, 1.0f, 0.5f, (float)(1.0 / 3.0)},   // right
    {1.0f, 1.0f, 0.0f, (float)(1.0 / 3.0)},    // left
    {1.0f, -1.0f, 0.25f, 0.0f},                // top
    {1.0f, 1.0f, 0.25f, (float)(2.0 / 3.0)},   // bottom
    {1.0f, 1.0f, 0.25f, (float)(1.0 / 3.0)},   // near
    {-1.0f, 1.0f, 0.75f, (float)(1.0 / 3.0)},  // far
};

// Shirley/Cramer on a triangle record (triangle.rs:39-80): t (+inf where
// invalid), beta and gamma (2 where the system is singular).
__device__ __forceinline__ float cramer(const Local& l, V3 a, V3 b, V3 c, float t_min,
                                        float t_max, float& beta, float& gamma) {
  V3 e1 = a - b, e2 = a - c, rhs = a - v3(l.ox, l.oy, l.oz);
  float A = e1.x, B = e1.y, C_ = e1.z, D = e2.x, E = e2.y, F = e2.z;
  float G = l.dx, H = l.dy, I = l.dz, J = rhs.x, K = rhs.y, L = rhs.z;
  float ei_hf = E * I - H * F;
  float gf_di = G * F - D * I;
  float dh_eg = D * H - E * G;
  float M = A * ei_hf + B * gf_di + C_ * dh_eg;
  float ak_jb = A * K - J * B;
  float jc_al = J * C_ - A * L;
  float bl_ck = B * L - C_ * K;
  bool ok_m = M != 0.0f;
  float Ms = ok_m ? M : 1.0f;
  float t = ok_m ? -(F * ak_jb + E * jc_al + D * bl_ck) / Ms : CUDART_INF_F;
  gamma = ok_m ? (I * ak_jb + H * jc_al + G * bl_ck) / Ms : 2.0f;
  beta = ok_m ? (J * ei_hf + K * gf_di + L * dh_eg) / Ms : 2.0f;
  bool ok = geom::in_range(t, t_min, t_max) && !(gamma < 0.0f) && !(gamma > 1.0f) &&
            !(beta < 0.0f) && !(beta > 1.0f - gamma);
  return ok ? t : CUDART_INF_F;
}

// sample_atlas (src/texture.rs:104-141): nearest texel with euclidean
// wrap-around, c / 255, then c^2.2 where srgb.
__device__ __forceinline__ V3 sample_atlas(const unsigned char* data, const int* meta, int ix,
                                           float u, float v, bool srgb) {
  ix = ix < 0 ? 0 : ix;
  const int off = meta[3 * ix], w = meta[3 * ix + 1], h = meta[3 * ix + 2];
  int x = (int)truncf(u * (float)(w - 1));
  int y = (int)truncf(v * (float)(h - 1));
  const int wc = w < 1 ? 1 : w, hc = h < 1 ? 1 : h;
  x %= wc;
  x = (x != 0 && ((x < 0) != (wc < 0))) ? x + wc : x;
  y %= hc;
  y = (y != 0 && ((y < 0) != (hc < 0))) ? y + hc : y;
  const long long idx = (long long)off + (long long)y * (long long)w + (long long)x;
  const float s = (float)(1.0 / 255.0);
  V3 c = v3((float)data[3 * idx] * s, (float)data[3 * idx + 1] * s, (float)data[3 * idx + 2] * s);
  if (srgb) c = v3(powf(c.x, 2.2f), powf(c.y, 2.2f), powf(c.z, 2.2f));
  return c;
}

__device__ __forceinline__ void count_launch(unsigned long long* counts, int entry) {
  if (counts != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(counts + entry, 1ull);
}

__device__ __forceinline__ void atomic_add3(float* acc, long long p, V3 v) {
  atomicAdd(acc + 3 * p, v.x);
  atomicAdd(acc + 3 * p + 1, v.y);
  atomicAdd(acc + 3 * p + 2, v.z);
}

template <bool HAS_TORUS>
__global__ void __launch_bounds__(kThreads) shade_round_kernel(const ShadeArgs a) {
  count_launch(a.counts, 0);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long R = a.n;
  if (i >= R) return;
  const int L = a.n_lights;
  const float w = a.w[i];
  const bool active = w > 0.0f;
  const float t_hit = a.hit_t[i];
  const bool hit = a.hit_mask != nullptr ? a.hit_mask[i] : (isfinite(t_hit) && active);
  const bool shade = active && hit;
  const long long pixel = a.spp_c > 0 ? i / a.spp_c : (long long)a.pix[i];
  const V3 bgc = load3(a.bg, pixel);
  const int node = a.hit_node[i], tri = a.hit_tri[i];
  const bool reflective = a.flags & kReflective;

  // Children's throughput, the children and the lanes' light terms; a lane
  // that shades nothing keeps these.
  float w_refl = w * 0.0f, w_refr = w * 0.0f;
  V3 base = v3(0.0f, 0.0f, 0.0f);
  const V3 o = load3(a.o, i), d = load3(a.d, i);
  V3 point = o, refl_dir = d, refr_dir = d;
  float t_eps = a.epsilon;

  if (shade) {
    // ---- hit detail (ops/intersect.py hit_detail) ----
    const float* rec = a.rec + (long long)(node < 0 ? 0 : node) * kRec;
    const Local l = geom::to_local([&](int r) { return rec[r]; }, o.x, o.y, o.z, d.x, d.y, d.z);
    float t_min = a.t_min[i];
    if (a.self_eps > 0.0f && node == a.src_node[i] && tri == a.src_tri[i]) {
      const float dn = sqrtf(clamp_min(l.dx * l.dx + l.dy * l.dy + l.dz * l.dz, 1.2e-38f));
      const float t_self = (1.0f / clamp_min(dn, 1e-30f)) * a.self_eps;
      t_min = nan_max(t_min, t_self);
    }
    const float inf = CUDART_INF_F;
    const int kind = (int)rec[31];
    int face = -1, part = 0;
    bool is_cap = false;
    float beta = 0.0f, gamma = 0.0f;
    const float* tr = a.trec != nullptr ? a.trec + (long long)(tri < 0 ? 0 : tri) * kTrec
                                        : nullptr;
    float t_re = inf;
    switch (kind) {
      case kSphere: t_re = geom::sphere(l, t_min, inf); break;
      case kPlane: t_re = geom::plane(l, t_min, inf, a.eps_r); break;
      case kCube: t_re = geom::cube(l, t_min, inf, a.eps_r, &face); break;
      case kCylinder: t_re = geom::cylinder(l, t_min, inf, &part); break;
      case kCone: t_re = geom::cone(l, t_min, inf, &is_cap); break;
      case kMesh:
        t_re = cramer(l, v3(tr[0], tr[1], tr[2]), v3(tr[3], tr[4], tr[5]),
                      v3(tr[6], tr[7], tr[8]), t_min, inf, beta, gamma);
        break;
      case kTorus:
        if constexpr (HAS_TORUS) {
          // math3d's quartic root (its arccos and cube root), then one
          // Newton step, as torus_candidate takes its solved root.
          const float t0 = geom::torus_with(l, rec[32], rec[33], t_min, inf, torch_acos,
                                            torch_cbrt);
          const geom::Quartic q = geom::torus_coeffs(l, rec[32], rec[33]);
          const float tc = isfinite(t0) ? t0 : 0.0f;
          const float f = (((q.A * tc + q.B) * tc + q.C) * tc + q.D) * tc + q.E;
          const float fp = ((4.0f * q.A * tc + 3.0f * q.B) * tc + 2.0f * q.C) * tc + q.D;
          t_re = isfinite(t0) ? tc - f / (fp == 0.0f ? 1.0f : fp) : inf;
        }
        break;
      default: break;
    }
    const float t = isfinite(t_re) ? t_re : t_hit;
    const V3 pl = v3(l.ox + t * l.dx, l.oy + t * l.dy, l.oz + t * l.dz);
    point = o + t * d;

    Surface s;
    s.u = s.v = 0.0f;
    s.has_uv = s.has_nmt = false;
    identity_frame(s);
    switch (kind) {
      case kSphere: {
        s.u = div_scalar((float)CUDART_PI + atan2f(-pl.z, pl.x), (float)(2.0 * CUDART_PI));
        s.v = div_scalar(acosf(clamp_to(pl.y, -1.0f, 1.0f)), (float)CUDART_PI);
        s.n = pl;
        pole_frame(s, pl, pl, pl.y > 0.0f, a.epsilon);
        s.has_uv = s.has_nmt = true;
        break;
      }
      case kPlane:
        s.n = v3(0.0f, 1.0f, 0.0f);
        s.u = pl.x + 0.5f;
        s.v = pl.z + 0.5f;
        s.has_uv = s.has_nmt = true;
        break;
      case kCube: {
        const int f = face < 0 ? 0 : face;
        const int axis = f >> 1;
        const float sg = (f & 1) ? -1.0f : 1.0f;
        s.n = v3(axis == 0 ? sg : 0.0f, axis == 1 ? sg : 0.0f, axis == 2 ? sg : 0.0f);
        const int s0 = axis == 0 ? 2 : 0, s1 = axis == 1 ? 2 : 1;
        const float norm_u = comp(pl, s0) * kFaceUv[f][0] + 0.5f;
        const float norm_v = 0.5f - comp(pl, s1) * kFaceUv[f][1];
        s.u = norm_u * 0.25f + kFaceUv[f][2];
        s.v = norm_v * (1.0f / 3.0f) + kFaceUv[f][3];
        pole_frame(s, pl, s.n, s.n.y > 0.0f, a.epsilon);
        s.has_uv = s.has_nmt = true;
        break;
      }
      case kCylinder:
        s.n = part == 0 ? v3(pl.x, 0.0f, pl.z)
                        : (part == 1 ? v3(0.0f, 1.0f, 0.0f) : v3(0.0f, -1.0f, 0.0f));
        break;
      case kCone: {
        const V3 tangent1 = v3(0.0f - pl.x, 0.5f - pl.y, 0.0f - pl.z);
        const V3 across = v3(-2.0f * pl.x, 0.0f, -2.0f * pl.z);
        const V3 tangent2 = cross(tangent1, across);
        s.n = is_cap ? v3(0.0f, -1.0f, 0.0f) : cross(tangent1, tangent2);
        break;
      }
      case kTorus: {
        const float rxz = sqrtf(pl.x * pl.x + pl.z * pl.z);
        const float scale = rec[32] / clamp_min(rxz, 1e-30f);
        s.n = pl - v3(pl.x * scale, 0.0f, pl.z * scale);
        break;
      }
      case kMesh: {
        const V3 ta = v3(tr[0], tr[1], tr[2]), tb = v3(tr[3], tr[4], tr[5]),
                 tc = v3(tr[6], tr[7], tr[8]);
        const float alpha = 1.0f - beta - gamma;
        const V3 n_smooth = alpha * v3(tr[9], tr[10], tr[11]) +
                            beta * v3(tr[12], tr[13], tr[14]) +
                            gamma * v3(tr[15], tr[16], tr[17]);
        s.n = tr[24] > 0.5f ? n_smooth : cross(tb - ta, tc - ta);
        s.has_uv = s.has_nmt = tr[25] > 0.5f;
        const float uva0 = tr[18], uva1 = tr[19], uvb0 = tr[20], uvb1 = tr[21], uvc0 = tr[22],
                    uvc1 = tr[23];
        s.u = uva0 * alpha + uvb0 * beta + uvc0 * gamma;
        s.v = 1.0f - (uva1 * alpha + uvb1 * beta + uvc1 * gamma);
        const V3 edge1 = tb - ta, edge2 = tc - ta;
        const float duv1_0 = uvb0 - uva0, duv1_1 = uvb1 - uva1;
        const float duv2_0 = uvc0 - uva0, duv2_1 = uvc1 - uva1;
        const V3 tangent = duv2_1 * edge1 - duv1_1 * edge2;
        const V3 bitangent = (-duv2_0) * edge1 + duv1_0 * edge2;
        const float coeff = duv1_0 * duv2_1 - duv2_0 * duv1_1;
        const float cs = coeff != 0.0f ? coeff : 1.0f;
        s.nmt0 = normalize(tangent / cs);
        s.nmt1 = normalize(s.n);
        s.nmt2 = normalize(bitangent / cs);
        break;
      }
      default:
        s.n = v3(0.0f, 0.0f, 0.0f);
        break;
    }
    // World normal: the transposed rotation of world -> local (scene.rs:204).
    const V3 normal_w = matvec_cols(v3(rec[0], rec[1], rec[2]), v3(rec[4], rec[5], rec[6]),
                                    v3(rec[8], rec[9], rec[10]), s.n);

    // ---- shading (ops/shade.py shade_pre) ----
    V3 mat_diffuse = v3(rec[12], rec[13], rec[14]);
    const V3 mat_specular = v3(rec[15], rec[16], rec[17]);
    const float mat_shininess = rec[18];
    const V3 view = neg(d);
    V3 n = normalize(normal_w);
    if (a.flags & (kNormalMap | kImageTex)) {
      const float u = rec[25] * s.u + rec[26] * s.v + rec[27];
      const float v = rec[28] * s.u + rec[29] * s.v + rec[30];
      if (a.flags & kNormalMap) {
        const int mat_nm = (int)rec[23];
        if (mat_nm >= 0 && s.has_nmt && s.has_uv) {
          const V3 tx = sample_atlas(a.nm_data, a.nm_meta, mat_nm, u, v, false);
          const float nx = 2.0f * tx.x - 1.0f;
          const float ny = 2.0f * tx.y - 1.0f;
          const float nz = -(2.0f * tx.z - 1.0f);
          n = matvec_cols(s.nmt0, s.nmt1, s.nmt2, normalize(v3(nx, -nz, -ny)));
        }
      }
      if (a.flags & kImageTex) {
        const int mat_tex = (int)rec[22];
        if (mat_tex >= 0) mat_diffuse = sample_atlas(a.tex_data, a.tex_meta, mat_tex, u, v, true);
      }
    }
    base = load3(a.ambient, 0) * mat_diffuse;
    if (a.eps_rel != 0.0f) t_eps = clamp_min(a.eps_rel * norm_eps(point), a.epsilon);

    const bool spec_possible =
        nan_max(nan_max(mat_specular.x, mat_specular.y), mat_specular.z) > 0.0f;
    const uint32_t sid = (uint32_t)a.sid[i];
    uint32_t k1 = a.k1, k2 = a.k2;
    if (a.key != nullptr) {
      k1 = (uint32_t)a.key[0];
      k2 = (uint32_t)a.key[a.key_word];
    }
    for (int li = 0; li < L; ++li) {
      V3 lpos = load3(a.light_pos, li);
      const V3 lcol = load3(a.light_color, li);
      const float c0 = a.light_falloff[3 * li], c1 = a.light_falloff[3 * li + 1],
                  c2 = a.light_falloff[3 * li + 2];
      if (a.area & (1 << li)) {  // one point of the parallelogram per lane
        uint32_t l1, l2;
        tf::lane_key(k1, k2, (uint32_t)(1000 + 2 * li), sid, l1, l2);
        const float ab0 = tf::lane_draw(l1, l2, 0u) * 2.0f - 1.0f;
        const float ab1 = tf::lane_draw(l1, l2, 1u) * 2.0f - 1.0f;
        lpos = lpos + ab0 * load3(a.light_area_a, li) + ab1 * load3(a.light_area_b, li);
      }
      const V3 hit_to_light = lpos - point;
      const float light_dist = norm_eps(hit_to_light);
      const V3 ldir = hit_to_light / clamp_min(light_dist, 1e-30f);
      const float attn = c0 + c1 * light_dist + c2 * light_dist * light_dist;
      const float nl = clamp_min(dot(n, ldir), 0.0f);
      const V3 diffuse = nl * (mat_diffuse * lcol);
      const V3 half = normalize(view + ldir);
      const float nh_raw = dot(n, half);
      const bool spec_on = (nh_raw > 0.0f) || (mat_shininess == 0.0f);
      const float nh = spec_on ? powf(clamp_min(nh_raw, 1e-20f), 4.0f * mat_shininess) : 0.0f;
      const V3 specular = nh * (mat_specular * lcol);
      const V3 contrib = (diffuse + specular) / attn;
      const long long j = (long long)li * R + i;
      store3(a.sh_o, j, point);
      store3(a.sh_d, j, ldir);
      a.sh_t[j] = t_eps;
      a.sh_need[j] = (nl > 0.0f) || (spec_possible && spec_on);
      a.sh_src_node[j] = node;
      a.sh_src_tri[j] = tri;
      store3(a.lc, j, w * contrib);
    }

    if (reflective) {
      const float mat_reflect = rec[19], mat_glossy = rec[20], mat_refr = rec[21];
      const float dn = dot(d, n);
      V3 rd = d - (2.0f * dn) * n;
      if ((a.flags & kGlossy) && mat_glossy > 0.0f) {  // material.rs:221-239
        const bool aligned_z = (fabsf(rd.x) < a.epsilon) && (fabsf(rd.y) < a.epsilon);
        const V3 offset = rd + (aligned_z ? v3(0.0f, 0.1f, 0.0f) : v3(0.0f, 0.0f, 0.1f));
        const V3 u_basis = cross(rd, offset);
        const V3 v_basis = cross(rd, u_basis);
        uint32_t l1, l2;
        tf::lane_key(k1, k2, 2000u, sid, l1, l2);
        const float u_coord = (-0.5f + tf::lane_draw(l1, l2, 0u)) * mat_glossy;
        const float v_coord = (-0.5f + tf::lane_draw(l1, l2, 1u)) * mat_glossy;
        rd = rd + u_coord * u_basis + v_coord * v_basis;
      }
      float refl_mult = mat_reflect, refr_mult = 0.0f;
      V3 rf = d;
      if (a.flags & kRefractive) {  // material.rs:253-275
        const bool dielectric = mat_refr > 0.0f;
        const float eta = dielectric ? mat_refr : 1.0f;
        const bool entering = dn < 0.0f;
        const float under_e = 1.0f - (1.0f - dn * dn) / (eta * eta);
        const V3 tang = d - dn * n;
        const float sq_e = under_e > 0.0f ? sqrtf(clamp_min(under_e, 1e-30f)) : 0.0f;
        const V3 refr_e = tang / eta - sq_e * n;
        const float under_x = 1.0f - (1.0f - dn * dn) * (eta * eta);
        const bool tir = under_x < 0.0f;
        const float sq_x = under_x > 0.0f ? sqrtf(clamp_min(under_x, 1e-30f)) : 0.0f;
        const V3 refr_x = eta * tang + sq_x * n;
        rf = entering ? refr_e : refr_x;
        const float cos_inc = entering ? -dn : dot(refr_x, n);
        float r0 = (eta - 1.0f) / (eta + 1.0f);
        r0 = r0 * r0;
        const float om = 1.0f - cos_inc;
        const float om2 = om * om;
        const float schlick = r0 + (1.0f - r0) * (om * (om2 * om2));
        const bool tir_exit = !entering && tir;
        refl_mult = dielectric ? (tir_exit ? mat_reflect : mat_reflect * schlick) : mat_reflect;
        refr_mult = (dielectric && !tir_exit) ? mat_reflect * (1.0f - schlick) : 0.0f;
      }
      const bool live = mat_reflect > 0.0f;
      w_refl = w * (live ? refl_mult : 0.0f);
      w_refr = w * (live ? refr_mult : 0.0f);
      refl_dir = normalize(rd);
      refr_dir = normalize(rf);
    }
  }
  if (!shade) {  // shadow rays that no sweep traces (need false), lc 0
    if (a.eps_rel != 0.0f) t_eps = clamp_min(a.eps_rel * norm_eps(point), a.epsilon);
    for (int li = 0; li < L; ++li) {
      const long long j = (long long)li * R + i;
      store3(a.sh_o, j, point);
      store3(a.sh_d, j, d);
      a.sh_t[j] = t_eps;
      a.sh_need[j] = false;
      a.sh_src_node[j] = node;
      a.sh_src_tri[j] = tri;
      store3(a.lc, j, v3(0.0f, 0.0f, 0.0f));
    }
  }

  // ---- accumulation (ops/trace.py _round_shade) ----
  const float miss_w = (active && !hit) ? w : 0.0f;
  const float bg_w = miss_w + (a.is_last ? w_refl + w_refr : 0.0f);
  const V3 x = bg_w * bgc + w * base;
  if (a.x != nullptr) {
    store3(a.x, i, x);
  } else if (x.x != 0.0f || x.y != 0.0f || x.z != 0.0f) {
    atomic_add3(a.acc, pixel, x);
  }
  if (a.is_last) return;
  const int pix = a.pix[i];
  const uint32_t sid2 = 2u * (uint32_t)a.sid[i];
  const long long js[2] = {i, R + i};
  const float ws[2] = {w_refl, w_refr};
  const V3 ds[2] = {refl_dir, refr_dir};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const long long j = js[c];
    store3(a.c_o, j, point);
    store3(a.c_d, j, ds[c]);
    a.c_w[j] = ws[c];
    a.c_pix[j] = pix;
    a.c_t[j] = t_eps;
    a.c_src_node[j] = node;
    a.c_src_tri[j] = tri;
    a.c_sid[j] = (int)(sid2 + (uint32_t)c);
    if (a.take != nullptr) a.take[j] = ws[c] > 0.0f ? 1 : 0;
  }
}

__device__ __forceinline__ bool occluded(const ResolveArgs& a, long long j) {
  return a.occ_is_int ? ((const int*)a.occ)[j] != 0 : ((const bool*)a.occ)[j];
}

// The unoccluded light of lane i, summed over the lights in order.
__device__ __forceinline__ V3 light_of(const ResolveArgs& a, long long i) {
  V3 s = v3(0.0f, 0.0f, 0.0f);
  for (int li = 0; li < a.n_lights; ++li) {
    const long long j = (long long)li * a.n + i;
    const V3 lc = load3(a.lc, j);
    s = li == 0 ? (occluded(a, j) ? v3(0.0f, 0.0f, 0.0f) : lc)
                : s + (occluded(a, j) ? v3(0.0f, 0.0f, 0.0f) : lc);
  }
  return s;
}

__device__ __forceinline__ bool taken(const ResolveArgs& a, long long c) {
  return a.pos[c] != (c > 0 ? a.pos[c - 1] : 0);
}

__global__ void __launch_bounds__(kThreads) resolve_round_kernel(const ResolveArgs a) {
  count_launch(a.counts, 1);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long R = a.n;
  const long long n_live = a.pos != nullptr && R > 0 ? (long long)a.pos[2 * R - 1] : 0;

  // acc: round 0's pixel-major sum, a pixel a thread, in lane order.
  if (a.spp_c > 0 && i < a.n_pixels) {
    const long long l0 = i * a.spp_c;
    V3 s = load3(a.x, l0);
    for (int k = 1; k < a.spp_c; ++k) s = s + load3(a.x, l0 + k);
    V3 acc = v3(0.0f, 0.0f, 0.0f) + s;
    if (a.n_lights > 0) {
      V3 light = light_of(a, l0);
      for (int k = 1; k < a.spp_c; ++k) light = light + light_of(a, l0 + k);
      acc = acc + light;
    }
    if (a.dropped != nullptr) {
      const V3 bg = load3(a.bg, i);
      for (int c = 0; c < 2; ++c)
        for (int k = 0; k < a.spp_c; ++k) {
          const long long j = c * R + l0 + k;
          const float cw = a.c_w[j];
          if (!taken(a, j) && cw > 0.0f) acc = acc + cw * bg;
        }
    }
    store3(a.acc, i, acc);
  } else if (a.spp_c == 0 && a.n_lights > 0 && i < R) {
    const V3 light = light_of(a, i);
    if (a.light != nullptr)
      store3(a.light, i, light);
    else if (light.x != 0.0f || light.y != 0.0f || light.z != 0.0f)
      atomic_add3(a.acc, a.pix[i], light);
  }
  if (a.pos == nullptr) return;  // the last round: no next queue

  // The children: a taken one to its slot, a dropped one to acc.
  if (i < 2 * R) {
    const float cw = a.c_w[i];
    if (taken(a, i)) {
      const long long s = (long long)a.pos[i] - 1;
      store3(a.q_o, s, load3(a.c_o, i));
      store3(a.q_d, s, load3(a.c_d, i));
      a.q_w[s] = cw;
      a.q_pix[s] = a.c_pix[i];
      a.q_t[s] = a.c_t[i];
      a.q_src_node[s] = a.c_src_node[i];
      a.q_src_tri[s] = a.c_src_tri[i];
      a.q_sid[s] = a.c_sid[i];
    } else if (a.dropped != nullptr && cw > 0.0f) {
      atomicAdd(a.dropped, cw);
      if (a.spp_c == 0) {
        const int p = a.c_pix[i];
        atomic_add3(a.acc, p, cw * load3(a.bg, p));
      }
    }
  }
  // The dead slots: _FILL's values.
  if (i >= n_live && i < a.cap) {
    store3(a.q_o, i, v3(0.0f, 0.0f, 0.0f));
    store3(a.q_d, i, v3(1.0f, 1.0f, 1.0f));
    a.q_w[i] = 0.0f;
    a.q_pix[i] = 0;
    a.q_t[i] = 1.0f;
    a.q_src_node[i] = -1;
    a.q_src_tri[i] = -1;
    a.q_sid[i] = 0;
  }
  if (i == 0) *a.n_live = n_live;
}

unsigned int blocks(long long n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

// Plain C entry points (bound with ctypes); each returns cudaGetLastError()
// after its launch.  has_torus != 0 when the tables hold a torus node.
extern "C" int shade_round(const ShadeArgs* args, int has_torus, void* stream) {
  if (args->n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_torus)
    shade_round_kernel<true><<<blocks(args->n), kThreads, 0, s>>>(*args);
  else
    shade_round_kernel<false><<<blocks(args->n), kThreads, 0, s>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int resolve_round(const ResolveArgs* args, void* stream) {
  long long n = args->spp_c > 0 ? args->n_pixels : args->n;
  if (args->pos != nullptr) {
    n = n > 2 * args->n ? n : 2 * args->n;
    n = n > args->cap ? n : args->cap;
  }
  if (n <= 0) return cudaSuccess;
  resolve_round_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// sizeof the argument structs, so that the binding can check its layout.
extern "C" int round_args_sizes(long long* out) {
  out[0] = (long long)sizeof(ShadeArgs);
  out[1] = (long long)sizeof(ResolveArgs);
  return 0;
}
