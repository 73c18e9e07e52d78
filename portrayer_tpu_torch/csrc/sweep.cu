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
//  * Every packed kind has a branch; the branches' local-frame formulas are
//    geometry.cuh's, which round.cu's hit detail shares.  The torus branch
//    is five times the size of the others and would set the register
//    count, and so the occupancy, of every scene; it is instantiated only
//    for tables that hold a torus chunk (template flag HAS_TORUS), as the
//    TPU kernel compiles only the kinds present.
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

#include "geometry.cuh"

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

using geom::fmax_sel;
using geom::fmin_sel;
using geom::guarded_div;
using geom::in_range;
using geom::Local;
using geom::nan_max;
using geom::nan_min;

struct Ray {
  float ox, oy, oz, dx, dy, dz, t_min, t_max;
  int src, srct;
};

__device__ __forceinline__ float row(const Tables& tb, int r, int col) {
  return __ldg(tb.pf + (size_t)r * tb.ncol + col);
}

__device__ __forceinline__ Local local_frame(const Tables& tb, int col, const Ray& ry) {
  return geom::to_local([&](int r) { return row(tb, r, col); }, ry.ox, ry.oy, ry.oz, ry.dx, ry.dy,
                        ry.dz);
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
  float ld2 = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
  return geom::sphere(l, general_tmin(ld2, is_src, ry.t_min, self_eps), ry.t_max);
}

// plane_g: unit XZ square at y = 0 (plane.rs).
__device__ __forceinline__ float plane_g(const Tables& tb, int col, const Ray& ry, bool is_src,
                                         float eps_r, float self_eps) {
  Local l = local_frame(tb, col, ry);
  float ld2 = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
  return geom::plane(l, general_tmin(ld2, is_src, ry.t_min, self_eps), ry.t_max, eps_r);
}

// cube_g: the 6-face fold in cube.rs FACES order.
__device__ __forceinline__ float cube_g(const Tables& tb, int col, const Ray& ry, bool is_src,
                                        float eps_r, float self_eps) {
  Local l = local_frame(tb, col, ry);
  float ld2 = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
  return geom::cube(l, general_tmin(ld2, is_src, ry.t_min, self_eps), ry.t_max, eps_r);
}

// cylinder_g: body quadratic (r = 0.5, |y| <= 0.5) and the two caps.
__device__ __forceinline__ float cylinder_g(const Tables& tb, int col, const Ray& ry, bool is_src,
                                            float self_eps) {
  Local l = local_frame(tb, col, ry);
  float ld2 = (l.dx * l.dx + l.dz * l.dz) + l.dy * l.dy;
  return geom::cylinder(l, general_tmin(ld2, is_src, ry.t_min, self_eps), ry.t_max);
}

// cone_g: body quadratic and the base cap (cone.rs:28-187).
__device__ __forceinline__ float cone_g(const Tables& tb, int col, const Ray& ry, bool is_src,
                                        float self_eps) {
  Local l = local_frame(tb, col, ry);
  float ld2 = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
  return geom::cone(l, general_tmin(ld2, is_src, ry.t_min, self_eps), ry.t_max);
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

// torus_g: the quartic torus (geom::torus), center and tube radius in rows
// 12..13.
__device__ __forceinline__ float torus_g(const Tables& tb, int col, const Ray& ry, bool is_src,
                                         float self_eps) {
  Local l = local_frame(tb, col, ry);
  float dd = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
  return geom::torus(l, row(tb, 12, col), row(tb, 13, col),
                     general_tmin(dd, is_src, ry.t_min, self_eps), ry.t_max);
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
