// The integrator's bounce and the lane pool's refill for the wavefront
// (Hopper, sm_90a): three entry points, a thread per lane of the lane pool.
//
// They replace no Pallas kernel. In the JAX package the bounce is XLA code
// under jit: raytrace_tpu/render/integrator.py's closest_hit (:219-368),
// _shade_hit (:701-850) and _bounce_step (:857-983), inside the wavefront's
// lax.while_loop (raytrace_tpu/render/wavefront.py:195-296), whose assign
// (:102-150) refills the pool; XLA fuses them into a few device programs.
// The port ran the same bounce as about a thousand torch kernels an
// iteration and the refill as about 175; these entries take their place
// inside the iteration's CUDA graph (render/wavefront.Lanes):
//
//   bounce_prims   the brute nearest hit over every sphere and free
//                  triangle, read from the scene's columns (no cap on
//                  their counts), and the mesh walk's seed (-inf on dead
//                  lanes): integrator.prims_hit. gpu semantics take a
//                  sphere's near root with its near < far test, cpu
//                  semantics its least positive root and every hit at
//                  t >= 20 EPS; both stages update on strict <. Three
//                  instantiations (bounce_prims_kernel<mode>): the lanes'
//                  own rays; one emitter's shadow rays (emitter >= 0),
//                  where it forms the ray (integrator.shadow_ray, the omit
//                  test on this bounce's merged hit, read back with the
//                  mesh's) and writes whether the ray is cast and meets
//                  that emitter first among the spheres and free triangles;
//                  and, with direct-light sampling in a scene without mesh
//                  triangles (flag set), the lanes' own rays and then, in
//                  the same thread, every emitter's shadow ray tested
//                  against the hit just found, which is the merged hit
//                  there, into the (n_emit, n) flags. A mesh scene's
//                  shadow rays need the mesh hit first, so they stay
//                  launches of their own, each followed by mesh_hit.
//   bounce_shade   everything after the hits, in place on the lane state:
//                  the mesh hit merged over the sphere / free-triangle hit,
//                  the draws (8 in mesh scenes, 5 in meshless ones; weyl or
//                  pcg), the shading of the three kinds (the mesh's
//                  attributes and texels through mesh_common.cuh), the gpu
//                  or cpu radiance update and roulette, the miss record, the
//                  direct-light terms in the emitters' order after the
//                  emissive term, debug_single_ray, the bounce cap and the
//                  retire (a retiring lane's radiance, with
//                  resolve_sky_dense's sky term, into its work unit's slot,
//                  and, given the counter, the sky's fetches counted: one
//                  atomic a warp, its ballot's popcount):
//                  integrator.shade_step and the wavefront's cap and retire.
//   lanes_assign   the refill (Lanes._assign; its plain version is
//                  ops/bounce_kernel.assign_reference), two launches: the
//                  dead lanes of each block of 1,024 (lanes_count_kernel),
//                  then (lanes_assign_kernel) each block's offset from those
//                  counts, its lanes ranked by a ballot scan, and each dead
//                  lane whose work id q + rank is below n_work seeded from
//                  (x, y, sample_base + id / n_pix) and raygen'd (the lens
//                  and jitter draws, the sqrt-then-divide normalize of
//                  raygen.generate_paths) with fresh radiance, throughput,
//                  bounce count, miss record and no pending direct-light
//                  term; block 0 advances q, sets the any-active flag and
//                  adds the lanes active after the refill (the next
//                  iteration's) to the device's iteration and lane-bounce
//                  counts. The source state and the buffers are separate
//                  arguments (the same tensors in the render; a lane that is
//                  not refilled is copied only where they differ).
//
// Dead lanes: bounce_prims writes a miss and the dead seed without testing
// anything (no later step reads a dead lane's hit: its shadow rays are
// never cast, since a pending direct-light term implies a live lane), and
// bounce_shade leaves a dead lane as it is, stream and direct-light record
// included, so a replay on a drained pool changes nothing. The slots'
// discard row, which the plain version writes for the lanes that do not
// retire, is not written.
//
// Bound on an H100: bytes. chip_smoke.py's phase 7b counts them on the
// a380-class frame's in-render pool (131,072 live lanes, cpu semantics):
// bounce_prims moves 7.5 MB (0.0022 ms at 3.35 TB/s) for 3.1e6 FP32
// instructions (0.0001 ms at 33.5 T/s), bounce_shade 42.8 MB, the lane
// state read and written once (0.0128 ms) for 2.0e7 (0.0006 ms). Measured
// there on an NVIDIA H100 80GB HBM3 at 700 W: 0.0033 and 0.0209 ms a
// launch, 67% and 61% of the bound (the plain versions 0.072 and 1.55 ms).
// The design is the plain one: a thread per lane, coalesced column reads,
// the scene's few rows through the uniform-load path. With the shadow rays
// in its launch, on walled's direct-light pool (1200x600 in cpu semantics,
// two emitters, 110,746 of 131,072 lanes pending; H100 80GB HBM3 at
// 700 W), bounce_prims takes 0.0161 ms against 0.0199 for the own-ray
// launch and the two shadow launches it replaces: the pending record is
// read once, the merged hit stays in registers, the flags are the only
// shadow output, and the iteration's graph holds two kernels fewer.
// lanes_assign at the 131,072-lane pool moves at most 12 MB (the flags
// read twice, the 80 B of a fresh lane's state written for every lane, the
// tables read): 3.6 us
// at 3.35 TB/s, and far less on a pool whose lanes mostly live. Its torch
// version was about 175 launches of a few us each; the design spends two
// launches, reads the 1-byte flags twice rather than keeping a scan's state
// in device memory, and writes only the lanes it refills.
//
// Exactness: built with -fmad=false (kernels/build.py); every sum and
// product is taken in the plain version's order (dot products left to
// right, x^5 as x * ((x x) (x x)), emissive * ci * inten in gpu semantics,
// L + 0 where the plain version adds a masked zero), with sqrtf, cosf, sinf
// and IEEE division, so the entries equal their plain versions bitwise. No
// t is ever NaN (every select that could pass one compares it first), so
// torch's first-of-equal-minima over the spheres and free triangles is the
// strict-< loop below.
//
// Built by raytrace_tpu_torch/kernels/build.py; called through ctypes from
// ops/bounce_kernel.py with one argument struct a family (BounceArgs, the
// field order of ops/bounce_kernel._PTRS / _LONGS / _INTS / _FLOATS;
// AssignArgs, that of _ASSIGN_PTRS and AssignArgs._fields_).

#include <math_constants.h>

#include "cubemap.cuh"
#include "mesh_common.cuh"
#include "path_common.cuh"

// The one argument of both entries, filled by ops/bounce_kernel.py.
struct BounceArgs {
  // the scene's columns (models/scene.SceneTensors), its mesh's shading
  // tables, its sky's face table and pool, the emitters' sphere indices
  const float *sph_c, *sph_r, *sph_rgb, *sph_em, *sph_diffp, *sph_n_out, *sph_n_in;
  const bool* sph_has_em;
  const long long* sph_kind;
  const float *ft_v0, *ft_e1, *ft_e2, *ft_norm, *ft_rgb, *ft_em, *ft_diffp, *ft_n_out, *ft_n_in;
  const bool* ft_has_em;
  const long long* ft_kind;
  const float* attr;
  const int* desc;
  const void* pool;
  const int* face;
  const void* sky_pool;
  const int* emitters;
  // the lane state (integrator.init_lanes' tree)
  float *ro[3], *rd[3], *L[3], *ci[3], *inten;
  long long* rng;  // u32 words
  bool* active;
  int* bounce;
  float *miss_d[3], *miss_w[3];
  bool* dls_active;
  float *dls_pos[3], *dls_norm[3], *dls_ci[3];
  long long* dls_self;
  // the sphere / free-triangle hit and the mesh walk's seed
  float* t;
  long long* kind;
  long long* idx;
  float *bu, *bv, *seed;
  // the mesh hit (mesh_hit's; null in meshless scenes)
  const float* mt;
  const int* mgid;
  const float *mu, *mv;
  // the shadow rays: one emitter's direction and flag, or every emitter's
  // (n_emit, n) flags (bounce_prims); every emitter's flags and mesh gids,
  // (n_emit, n) (bounce_shade)
  float* d_l[3];
  bool* flag;
  const bool* flags;
  const int* sgid;
  // the retire: each lane's work unit, the (n_work + 1, 3) slots; with a
  // sky, the 0-dim count of the retiring lanes that fetched it (or null)
  const long long* unit;
  float* slots;
  long long* sky_fetches;
  long long pool_len, sky_len;
  int n, n_sph, n_ft, n_mesh, n_emit, pool_kind, sky_kind;
  int cpu, pcg, dls, debug, miss, assured, cap, emitter;
  float max_thres, inv_thres, t_min, dls_normze;
};

// The one argument of lanes_assign, filled by ops/bounce_kernel.py: the
// bounce's lane state (src_*) and the buffers it is written into, each
// miss record and direct-light flag null where the state has none.
struct AssignArgs {
  const float *src_ro[3], *src_rd[3], *src_L[3], *src_ci[3], *src_inten;
  const long long* src_rng;
  const int* src_bounce;
  const float *src_miss_d[3], *src_miss_w[3];
  const bool *src_dls_active, *src_active;
  float *ro[3], *rd[3], *L[3], *ci[3], *inten;
  long long* rng;
  int* bounce;
  float *miss_d[3], *miss_w[3];
  bool *dls_active, *active;
  // each lane's work unit; the tile-ordered pixel tables (int32)
  long long* unit;
  const int *xs, *ys;
  // 0-dim device buffers: the queue counter, the batch's first sample id,
  // the iteration and lane-bounce counts, the any-active flag
  long long* q;
  const long long* sample_base;
  long long *iters, *lane_bounces;
  bool* flag;
  long long* scratch;  // (blocks + 1): each block's dead lanes, then q
  long long n_work, n_pix;
  int n, has_lens, pcg;
  float cam[18];  // ops/trace_kernel.make_cam_vec's row
};

namespace {

using namespace rt;

constexpr int kThreads = 256;
constexpr int kNone = 0, kSphere = 1, kFreeTri = 2, kMeshTri = 3;
constexpr float kCpuRrThres = 0.4f;  // radiance.rs:77


__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

// integrator.sphere_t of one sphere: INF on a miss
__device__ __forceinline__ float sphere_t(float ox, float oy, float oz, float dx, float dy,
                                          float dz, const float* c, float r, bool cpu) {
  const float ocx = ox - __ldg(c), ocy = oy - __ldg(c + 1), ocz = oz - __ldg(c + 2);
  const float dirv = dot3(dx, dy, dz, ocx, ocy, ocz);
  const float consts = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r;
  const float disc = dirv * dirv - consts;
  const bool pos = disc > 0.f;
  const float sq = sqrtf(pos ? disc : 1.f);
  const float t_near = -dirv - sq, t_far = -dirv + sq;
  if (!cpu) return pos && t_near > 0.f && t_near < t_far ? t_near : kInf;
  return pos ? (t_near > 0.f ? t_near : (t_far > 0.f ? t_far : kInf)) : kInf;
}

struct Hit {
  float t;
  int kind, idx;
  float bu, bv;
};

// integrator.prims_hit of one ray: spheres, then free triangles, each a
// strict-< loop from +inf (torch's first of equal minima) and the stage's
// winner kept where it is below the best so far
__device__ __forceinline__ Hit prims_hit(const BounceArgs& A, float ox, float oy, float oz,
                                         float dx, float dy, float dz) {
  Hit h{kInf, kNone, 0, 0.f, 0.f};
  if (A.n_sph) {
    float tmin = CUDART_INF_F;
    int amin = 0;
    for (int s = 0; s < A.n_sph; ++s) {
      float t = sphere_t(ox, oy, oz, dx, dy, dz, A.sph_c + 3 * s, __ldg(A.sph_r + s), A.cpu);
      if (A.cpu) t = t >= A.t_min ? t : kInf;
      if (t < tmin) {
        tmin = t;
        amin = s;
      }
    }
    if (tmin < h.t) {
      h.t = tmin;
      h.kind = kSphere;
      h.idx = amin;
    }
  }
  if (A.n_ft) {
    const Ray r{ox, oy, oz, dx, dy, dz};
    float tmin = CUDART_INF_F, umin = 0.f, wmin = 0.f;
    int amin = 0;
    for (int f = 0; f < A.n_ft; ++f) {
      const float *v0 = A.ft_v0 + 3 * f, *e1 = A.ft_e1 + 3 * f, *e2 = A.ft_e2 + 3 * f;
      float t = 0.f, u = 0.f, w = 0.f;
      const bool ok = tri_hit(r, __ldg(v0), __ldg(v0 + 1), __ldg(v0 + 2), __ldg(e1),
                              __ldg(e1 + 1), __ldg(e1 + 2), __ldg(e2), __ldg(e2 + 1),
                              __ldg(e2 + 2), t, u, w);
      float tt = ok ? t : kInf;
      if (A.cpu) tt = tt >= A.t_min ? tt : kInf;
      if (tt < tmin) {
        tmin = tt;
        amin = f;
        umin = u;
        wmin = w;
      }
    }
    if (tmin < h.t) {
      h = Hit{tmin, kFreeTri, amin, umin, wmin};
    }
  }
  return h;
}

// integrator.shadow_ray toward sphere e from a pending hit at p with normal
// n, made on sphere self (-1: none), given this bounce's merged hit (kind,
// idx): the ray's direction, and whether the pending hit casts it
__device__ __forceinline__ bool shadow_ray(const BounceArgs& A, int e, float px, float py,
                                           float pz, float nx, float ny, float nz,
                                           long long self, long long kind, long long idx,
                                           float& dx, float& dy, float& dz) {
  dx = __ldg(A.sph_c + 3 * e) - px;
  dy = __ldg(A.sph_c + 3 * e + 1) - py;
  dz = __ldg(A.sph_c + 3 * e + 2) - pz;
  vnorm(dx, dy, dz, 1e-20f);
  const float light_dot = dot3(dx, dy, dz, nx, ny, nz);
  const bool omit = self == e || (kind == kSphere && idx == e);
  return light_dot > 0.f && !omit;
}

constexpr int kOwnRays = 0, kShadowRays = 1, kOwnAndShadowRays = 2;

template <int kMode>
__global__ void __launch_bounds__(kThreads) bounce_prims_kernel(const BounceArgs A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.n) return;
  if (kMode == kShadowRays) {  // the shadow ray toward sphere `emitter` from the pending hit
    const int e = A.emitter;
    const float px = A.dls_pos[0][i], py = A.dls_pos[1][i], pz = A.dls_pos[2][i];
    // this bounce's merged hit: the mesh's where a triangle beat its seed
    long long kind = A.kind[i], idx = A.idx[i];
    if (A.mgid != nullptr && A.mgid[i] >= 0) {
      kind = kMeshTri;
      idx = A.mgid[i];
    }
    float dx, dy, dz;
    const bool cand = shadow_ray(A, e, px, py, pz, A.dls_norm[0][i], A.dls_norm[1][i],
                                 A.dls_norm[2][i], A.dls_self[i], kind, idx, dx, dy, dz) &&
                      A.dls_active[i];
    Hit h{kInf, kNone, 0, 0.f, 0.f};
    if (cand) h = prims_hit(A, px, py, pz, dx, dy, dz);
    A.d_l[0][i] = dx;
    A.d_l[1][i] = dy;
    A.d_l[2][i] = dz;
    A.seed[i] = cand ? h.t : -CUDART_INF_F;
    A.flag[i] = cand && h.kind == kSphere && h.idx == e;
    return;
  }
  // the lanes' own rays
  Hit h{kInf, kNone, 0, 0.f, 0.f};
  const bool live = A.active[i];
  if (live) h = prims_hit(A, A.ro[0][i], A.ro[1][i], A.ro[2][i], A.rd[0][i], A.rd[1][i],
                          A.rd[2][i]);
  A.t[i] = h.t;
  A.kind[i] = h.kind;
  A.idx[i] = h.idx;
  A.bu[i] = h.bu;
  A.bv[i] = h.bv;
  A.seed[i] = live ? h.t : -CUDART_INF_F;
  if (kMode == kOwnRays) return;
  // every emitter's shadow ray from the pending hit, tested against the hit
  // just found (without mesh triangles, the merged hit); a lane with nothing
  // pending casts none and reads no more of its record
  const bool pending = A.dls_active[i];
  float px = 0.f, py = 0.f, pz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  long long self = -1;
  if (pending) {
    px = A.dls_pos[0][i];
    py = A.dls_pos[1][i];
    pz = A.dls_pos[2][i];
    nx = A.dls_norm[0][i];
    ny = A.dls_norm[1][i];
    nz = A.dls_norm[2][i];
    self = A.dls_self[i];
  }
  for (int j = 0; j < A.n_emit; ++j) {
    const int e = __ldg(A.emitters + j);
    bool ok = false;
    float dx, dy, dz;
    if (pending && shadow_ray(A, e, px, py, pz, nx, ny, nz, self, h.kind, h.idx, dx, dy, dz)) {
      const Hit s = prims_hit(A, px, py, pz, dx, dy, dz);
      ok = s.kind == kSphere && s.idx == e;
    }
    A.flag[static_cast<size_t>(j) * A.n + i] = ok;
  }
}

// integrator._diff_dir: cosine-weighted direction in the frame (xd, n x xd, n)
__device__ __forceinline__ float3 diff_dir(float dx, float dy, float dz, float nx, float ny,
                                           float nz, float u, float w) {
  const float dn = dot3(dx, dy, dz, nx, ny, nz);
  float xx = dx - nx * dn, xy = dy - ny * dn, xz = dz - nz * dn;
  vnorm(xx, xy, xz, 1e-20f);
  const float yx = ny * xz - nz * xy, yy = nz * xx - nx * xz, yz = nx * xy - ny * xx;
  const float r = sqrtf(u);
  const float th = kTwoPi * w;
  const float rc = r * cosf(th), rs = r * sinf(th);
  const float z = sqrtf(fmaxf(1.f - u, 0.f));
  return make_float3(xx * rc + yx * rs + nx * z, xy * rc + yy * rs + ny * z,
                     xz * rc + yz * rs + nz * z);
}

// integrator._reflect then normalize (the spec direction, renormalized)
__device__ __forceinline__ float3 spec_dir(float dx, float dy, float dz, float nx, float ny,
                                           float nz) {
  const float k = 2.f * dot3(dx, dy, dz, nx, ny, nz);
  float x = dx - nx * k, y = dy - ny * k, z = dz - nz * k;
  vnorm(x, y, z, 0.f);
  return make_float3(x, y, z);
}

// integrator._refract_dir: the dielectric with the reference's Schlick
// quirks; returns the direction and sets its weight
__device__ __forceinline__ float3 refract_dir(float dx, float dy, float dz, float nx, float ny,
                                              float nz, float n_out, float n_in, float u,
                                              bool cpu, float& weight) {
  const float c = dot3(nx, ny, nz, dx, dy, dz);
  const bool into = c < 0.f;
  const float n1 = into ? n_out : n_in, n2 = into ? n_in : n_out;
  const float c1 = fabsf(c);
  const float rx = into ? nx : -nx, ry = into ? ny : -ny, rz = into ? nz : -nz;
  const float n_over = n1 / n2;
  const float c22 = 1.f - n_over * n_over * (1.f - c1 * c1);
  const bool tir = c22 < 0.f;
  const float k = 2.f * dot3(dx, dy, dz, rx, ry, rz);
  const float fx = dx - rx * k, fy = dy - ry * k, fz = dz - rz * k;
  const float sq = sqrtf(c22 > 0.f ? c22 : 1.f);
  const float k_t = n_over * c1 - sq;
  float tx = dx, ty = dy, tz = dz;
  if (!tir) {
    tx = dx * n_over + rx * k_t;
    ty = dy * n_over + ry * k_t;
    tz = dz * n_over + rz * k_t;
  }
  float r0 = (n1 - n2) / (n1 + n2);
  r0 = r0 * r0;
  const float tn = dot3(tx, ty, tz, nx, ny, nz);
  const float cos_term = 1.f - (cpu && into ? c1 : tn);
  const float re = r0 + (1.f + r0) * pow5(cos_term);
  if (tir || u < re) {
    weight = cpu && !tir ? re : 1.f;
    return make_float3(fx, fy, fz);
  }
  weight = 1.f - re;
  return make_float3(tx, ty, tz);
}

__global__ void __launch_bounds__(kThreads) bounce_shade_kernel(const BounceArgs A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.n || !A.active[i]) return;  // a dead lane keeps its state

  // ---- the merged hit ----
  float t = A.t[i], bu = A.bu[i], bv = A.bv[i];
  int kind = static_cast<int>(A.kind[i]);
  long long idx = A.idx[i];
  if (A.mgid != nullptr && A.mgid[i] >= 0) {
    t = A.mt[i];
    kind = kMeshTri;
    idx = A.mgid[i];
    bu = A.mu[i];
    bv = A.mv[i];
  }
  const bool hit = kind != kNone;

  // ---- the draws: 8 in mesh scenes, 5 in meshless ones ----
  uint32_t s = static_cast<uint32_t>(A.rng[i]);
  auto draw = [&]() { return A.pcg ? next_f32_pcg(s) : next_f32(s); };
  const float u0 = draw(), u1 = draw(), u2 = draw(), u3 = draw();
  float u4 = u1, u5 = u2, u6 = u3, u7;  // meshless: u0-u3, u7; u1-u3 stand in for u4-u6
  if (A.n_mesh) {
    u4 = draw();
    u5 = draw();
    u6 = draw();
  }
  u7 = draw();

  // ---- the shading of the hit's kind (integrator._shade_hit) ----
  const float ox = A.ro[0][i], oy = A.ro[1][i], oz = A.ro[2][i];
  const float dx = A.rd[0][i], dy = A.rd[1][i], dz = A.rd[2][i];
  const float ts = isfinite(t) ? t : 0.f;
  const float qx = ox + dx * ts, qy = oy + dy * ts, qz = oz + dz * ts;
  float nx = 0.f, ny = 0.f, nz = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, er = 0.f, eg = 0.f, eb = 0.f;
  bool has_em = false;
  long long mkind = 0;
  float diffp = 0.f, n_out = 1.f, n_in = 1.f, metal = 0.f, rough = 0.f;
  if (kind == kSphere) {
    const float* c = A.sph_c + 3 * idx;
    nx = qx - __ldg(c);
    ny = qy - __ldg(c + 1);
    nz = qz - __ldg(c + 2);
    vnorm(nx, ny, nz, 1e-20f);
    cr = __ldg(A.sph_rgb + 3 * idx);
    cg = __ldg(A.sph_rgb + 3 * idx + 1);
    cb = __ldg(A.sph_rgb + 3 * idx + 2);
    er = __ldg(A.sph_em + 3 * idx);
    eg = __ldg(A.sph_em + 3 * idx + 1);
    eb = __ldg(A.sph_em + 3 * idx + 2);
    has_em = A.sph_has_em[idx];
    mkind = A.sph_kind[idx];
    diffp = __ldg(A.sph_diffp + idx);
    n_out = __ldg(A.sph_n_out + idx);
    n_in = __ldg(A.sph_n_in + idx);
  } else if (kind == kFreeTri) {
    nx = __ldg(A.ft_norm + 3 * idx);
    ny = __ldg(A.ft_norm + 3 * idx + 1);
    nz = __ldg(A.ft_norm + 3 * idx + 2);
    cr = __ldg(A.ft_rgb + 3 * idx);
    cg = __ldg(A.ft_rgb + 3 * idx + 1);
    cb = __ldg(A.ft_rgb + 3 * idx + 2);
    if (!A.cpu) {  // the CPU backend zeroes triangle emissive (generic.rs:85-86)
      er = __ldg(A.ft_em + 3 * idx);
      eg = __ldg(A.ft_em + 3 * idx + 1);
      eb = __ldg(A.ft_em + 3 * idx + 2);
      has_em = A.ft_has_em[idx];
    }
    mkind = A.ft_kind[idx];
    diffp = __ldg(A.ft_diffp + idx);
    n_out = __ldg(A.ft_n_out + idx);
    n_in = __ldg(A.ft_n_in + idx);
  } else if (kind == kMeshTri) {
    const MeshAttrs at = mesh_attrs(MeshShade{A.attr, A.desc, A.pool, A.pool_kind, A.pool_len},
                                    static_cast<int>(idx), bu, bv);
    nx = at.nx;
    ny = at.ny;
    nz = at.nz;
    cr = at.r;
    cg = at.g;
    cb = at.b;
    metal = at.metal;
    rough = at.rough;
  }
  const float px = qx + nx * kEps, py = qy + ny * kEps, pz = qz + nz * kEps;
  const bool ds_diff = u0 < diffp;

  // ---- the radiance update and roulette; the miss record ----
  float lr = A.L[0][i], lg = A.L[1][i], lb = A.L[2][i];
  float cir = A.ci[0][i], cig = A.ci[1][i], cib = A.ci[2][i];
  float inten = A.inten[i];
  const int bounce = A.bounce[i];
  float mdx = 0.f, mdy = 0.f, mdz = 0.f, mwr = 0.f, mwg = 0.f, mwb = 0.f;
  if (A.miss) {
    if (hit) {
      mdx = A.miss_d[0][i];
      mdy = A.miss_d[1][i];
      mdz = A.miss_d[2][i];
      mwr = A.miss_w[0][i];
      mwg = A.miss_w[1][i];
      mwb = A.miss_w[2][i];
    } else {  // gpu: ci * inten, cpu: ci
      mdx = dx;
      mdy = dy;
      mdz = dz;
      mwr = A.cpu ? cir : cir * inten;
      mwg = A.cpu ? cig : cig * inten;
      mwb = A.cpu ? cib : cib * inten;
    }
  }
  bool survive;
  float atten = 1.f;
  if (!A.cpu) {
    const bool add_em = hit && has_em;
    lr = lr + (add_em ? er * cir * inten : 0.f);
    lg = lg + (add_em ? eg * cig * inten : 0.f);
    lb = lb + (add_em ? eb * cib * inten : 0.f);
    if (add_em) {
      cir = cir * cr;
      cig = cig * cg;
      cib = cib * cb;
    }
    if (hit) {
      cir = cir * cr;
      cig = cig * cg;
      cib = cib * cb;
    }
    const bool rr_kill = bounce >= A.assured && u7 > A.max_thres;
    const bool term = hit && rr_kill;
    const float rr = cir * A.inv_thres, rg = cig * A.inv_thres, rb = cib * A.inv_thres;
    lr = lr + (term ? rr * inten : 0.f);
    lg = lg + (term ? rg * inten : 0.f);
    lb = lb + (term ? rb * inten : 0.f);
    if (term) {
      cir = rr;
      cig = rg;
      cib = rb;
    }
    survive = hit && !rr_kill;
  } else {  // radiance.rs:20-72
    lr = lr + (hit ? er * cir : 0.f);
    lg = lg + (hit ? eg * cig : 0.f);
    lb = lb + (hit ? eb * cib : 0.f);
    const bool rr_due = bounce > A.assured;
    atten = rr_due ? kCpuRrThres : 1.f;
    survive = hit && (!rr_due || u7 < kCpuRrThres);
  }

  // ---- the next direction and its weight, where the path goes on ----
  float ndx = dx, ndy = dy, ndz = dz, weight = 1.f;
  if (survive) {
    float3 nd;
    if (kind == kMeshTri) {  // mesh PBR divert (mesh/triangle.rs:190-226)
      const float3 spec = spec_dir(dx, dy, dz, nx, ny, nz);
      const float3 diff = diff_dir(dx, dy, dz, nx, ny, nz, u1, u2);
      const float r0 = 0.04f + 0.96f * metal;
      const float refl = r0 + (1.f - r0) * (1.f - pow5(fabsf(dot3(dx, dy, dz, nx, ny, nz))));
      const float3 base = u0 < 1.f - refl ? diff : spec;
      float sx = u4, sy = u5, sz = u6;
      vnorm(sx, sy, sz, 1e-20f);
      nd = make_float3(base.x + sx * rough, base.y + sy * rough, base.z + sz * rough);
      vnorm(nd.x, nd.y, nd.z, 0.f);
    } else if (mkind == 0 || (mkind == 2 && !ds_diff)) {
      nd = spec_dir(dx, dy, dz, nx, ny, nz);
    } else if (mkind == 1 || mkind == 2) {
      nd = diff_dir(dx, dy, dz, nx, ny, nz, u1, u2);
    } else {
      float w;
      nd = refract_dir(dx, dy, dz, nx, ny, nz, n_out, n_in, u3, A.cpu, w);
      if (mkind == 3) weight = w;
    }
    ndx = nd.x;
    ndy = nd.y;
    ndz = nd.z;
    if (!A.cpu) {
      inten = inten * weight;
    } else {
      const float w = weight / atten;
      cir = cir * (cr * w);
      cig = cig * (cg * w);
      cib = cib * (cb * w);
    }
  }

  // ---- direct-light sampling at the previous bounce's diffuse hit ----
  if (A.dls) {
    const float qpx = A.dls_pos[0][i], qpy = A.dls_pos[1][i], qpz = A.dls_pos[2][i];
    const float qnx = A.dls_norm[0][i], qny = A.dls_norm[1][i], qnz = A.dls_norm[2][i];
    const float qcr = A.dls_ci[0][i], qcg = A.dls_ci[1][i], qcb = A.dls_ci[2][i];
    for (int j = 0; j < A.n_emit; ++j) {
      const size_t at = static_cast<size_t>(j) * A.n + i;
      bool ok = A.flags[at];
      if (A.sgid != nullptr) ok = ok && A.sgid[at] < 0;
      const int e = __ldg(A.emitters + j);
      float lx = __ldg(A.sph_c + 3 * e) - qpx, ly = __ldg(A.sph_c + 3 * e + 1) - qpy,
            lz = __ldg(A.sph_c + 3 * e + 2) - qpz;
      vnorm(lx, ly, lz, 1e-20f);
      const float sc = dot3(lx, ly, lz, qnx, qny, qnz) * A.dls_normze;
      lr = lr + (ok ? qcr * (__ldg(A.sph_em + 3 * e) * sc) : 0.f);
      lg = lg + (ok ? qcg * (__ldg(A.sph_em + 3 * e + 1) * sc) : 0.f);
      lb = lb + (ok ? qcb * (__ldg(A.sph_em + 3 * e + 2) * sc) : 0.f);
    }
  }

  const Sky sky{A.face, A.sky_pool, A.sky_kind, A.sky_len};
  if (A.debug) {  // first-hit emissive only; a miss shows the sky, black without one
    if (hit) {
      lr = er;
      lg = eg;
      lb = eb;
    } else {
      const float3 c = A.face != nullptr ? sky_rgb(A.face, sky, dx, dy, dz)
                                         : make_float3(0.f, 0.f, 0.f);
      lr = c.x;
      lg = c.y;
      lb = c.z;
    }
    survive = false;
  }

  // ---- the next state, the bounce cap and the retire ----
  const int nb = bounce + (survive ? 1 : 0);
  const bool alive = survive && nb < A.cap;
  if (survive) {
    A.ro[0][i] = px;
    A.ro[1][i] = py;
    A.ro[2][i] = pz;
    A.rd[0][i] = ndx;
    A.rd[1][i] = ndy;
    A.rd[2][i] = ndz;
  }
  A.L[0][i] = lr;
  A.L[1][i] = lg;
  A.L[2][i] = lb;
  A.ci[0][i] = cir;
  A.ci[1][i] = cig;
  A.ci[2][i] = cib;
  A.inten[i] = inten;
  A.rng[i] = s;
  A.active[i] = alive;
  A.bounce[i] = nb;
  if (A.miss) {
    A.miss_d[0][i] = mdx;
    A.miss_d[1][i] = mdy;
    A.miss_d[2][i] = mdz;
    A.miss_w[0][i] = mwr;
    A.miss_w[1][i] = mwg;
    A.miss_w[2][i] = mwb;
  }
  if (A.dls) {
    A.dls_active[i] = alive && (mkind == 1 || (mkind == 2 && ds_diff));
    A.dls_pos[0][i] = px;
    A.dls_pos[1][i] = py;
    A.dls_pos[2][i] = pz;
    A.dls_norm[0][i] = nx;
    A.dls_norm[1][i] = ny;
    A.dls_norm[2][i] = nz;
    A.dls_ci[0][i] = cir;
    A.dls_ci[1][i] = cig;
    A.dls_ci[2][i] = cib;
    A.dls_self[i] = kind == kSphere ? idx : -1;
  }
  if (!alive) {  // the path ended: its radiance, with the sky where it missed
    if (A.miss) {
      const bool fetch = mwr > 0.f || mwg > 0.f || mwb > 0.f;
      if (A.sky_fetches != nullptr) {  // one atomic a warp: its fetching lanes' count
        const unsigned here = __activemask();
        const unsigned fetching = __ballot_sync(here, fetch);
        if (fetching != 0u && static_cast<int>(threadIdx.x & 31) == __ffs(here) - 1) {
          atomicAdd(reinterpret_cast<unsigned long long*>(A.sky_fetches),
                    static_cast<unsigned long long>(__popc(fetching)));
        }
      }
      if (fetch) {
        const float3 c = sky_rgb(A.face, sky, mdx, mdy, mdz);
        lr = lr + mwr * c.x;
        lg = lg + mwg * c.y;
        lb = lb + mwb * c.z;
      }
    }
    float* slot = A.slots + 3 * A.unit[i];
    slot[0] = lr;
    slot[1] = lg;
    slot[2] = lb;
  }
}

constexpr int kAssignThreads = 1024;
constexpr int kAssignWarps = kAssignThreads / 32;

__global__ void __launch_bounds__(kAssignThreads) lanes_count_kernel(const AssignArgs A) {
  const int i = blockIdx.x * kAssignThreads + threadIdx.x;
  const int dead = __syncthreads_count(i < A.n && !A.src_active[i]);
  if (threadIdx.x == 0) {
    A.scratch[blockIdx.x] = dead;
    if (blockIdx.x == 0) A.scratch[gridDim.x] = *A.q;  // q as this refill found it
  }
}

template <typename T>
__device__ __forceinline__ void keep(T* dst, const T* src, int i) {
  if (dst != src) dst[i] = src[i];
}

__global__ void __launch_bounds__(kAssignThreads) lanes_assign_kernel(const AssignArgs A) {
  __shared__ long long s_before, s_total;
  __shared__ int s_warp[kAssignWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int i = blockIdx.x * kAssignThreads + t;
  const bool in = i < A.n;
  const bool dead = in && !A.src_active[i];
  const unsigned ballot = __ballot_sync(0xffffffffu, dead);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  if (warp == 0) {  // the dead lanes of the blocks before this one, and of all
    const int blocks = gridDim.x, me = blockIdx.x;
    long long before = 0, total = 0;
    for (int b = lane; b < blocks; b += 32) {
      const long long c = A.scratch[b];
      total += c;
      if (b < me) before += c;
    }
    for (int o = 16; o > 0; o >>= 1) {
      before += __shfl_xor_sync(0xffffffffu, before, o);
      total += __shfl_xor_sync(0xffffffffu, total, o);
    }
    if (lane == 0) {
      s_before = before;
      s_total = total;
    }
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the warps' dead lanes
    const int c = s_warp[lane];
    int x = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    s_warp[lane] = x - c;
  }
  __syncthreads();
  const long long q0 = A.scratch[gridDim.x];
  if (blockIdx.x == 0 && t == 0) {
    const long long total = s_total, room = A.n_work - q0;
    const long long fresh = total < room ? total : (room > 0 ? room : 0);
    const long long live = A.n - total + fresh;  // the next iteration's lanes
    *A.q = q0 + total < A.n_work ? q0 + total : A.n_work;
    *A.flag = live > 0;
    *A.iters += live > 0 ? 1 : 0;
    *A.lane_bounces += live;
  }
  if (!in) return;
  const long long id = q0 + s_before + s_warp[warp] + __popc(ballot & ((1u << lane) - 1u));
  if (!dead || id >= A.n_work) {  // the lane keeps the bounce's state
    for (int c = 0; c < 3; ++c) {
      keep(A.ro[c], A.src_ro[c], i);
      keep(A.rd[c], A.src_rd[c], i);
      keep(A.L[c], A.src_L[c], i);
      keep(A.ci[c], A.src_ci[c], i);
      if (A.miss_d[0] != nullptr) {
        keep(A.miss_d[c], A.src_miss_d[c], i);
        keep(A.miss_w[c], A.src_miss_w[c], i);
      }
    }
    keep(A.inten, A.src_inten, i);
    keep(A.rng, A.src_rng, i);
    keep(A.bounce, A.src_bounce, i);
    if (A.dls_active != nullptr) keep(A.dls_active, A.src_dls_active, i);
    keep(A.active, A.src_active, i);
    return;
  }
  // the work unit's seed and camera ray (ops/rng.init_state, raygen.generate_paths)
  const long long pix = id % A.n_pix;
  const int x = A.xs[pix], y = A.ys[pix];
  const uint32_t sid = static_cast<uint32_t>(*A.sample_base + id / A.n_pix);
  uint32_t s = jenkins(jenkins(static_cast<uint32_t>(x) ^ (static_cast<uint32_t>(y) << 16)) ^
                       jenkins(sid ^ 0x9E3779B9u));
  auto draw = [&]() { return A.pcg ? next_f32_pcg(s) : next_f32(s); };
  const float* c = A.cam;
  const float sx = c[12] * (static_cast<float>(x) - c[14]);
  const float sy = c[13] * (static_cast<float>(y) - c[15]);
  float dx = c[3] + sx * c[9] + sy * c[6];
  float dy = c[4] + sx * c[10] + sy * c[7];
  float dz = c[5] + sx * c[11] + sy * c[8];
  float ox = c[0], oy = c[1], oz = c[2];
  if (A.has_lens) {
    const float u = draw(), v = draw();
    const float r = sqrtf(u);
    const float th = kTwoPi * v;
    const float lx = (r - 0.5f) * 2.0f * c[16] * cosf(th);
    const float ly = (r - 0.5f) * 2.0f * c[16] * sinf(th);
    const float offx = c[9] * lx + c[6] * ly, offy = c[10] * lx + c[7] * ly,
                offz = c[11] * lx + c[8] * ly;
    ox = offx + c[0];
    oy = offy + c[1];
    oz = offz + c[2];
    dx = dx - offx;
    dy = dy - offy;
    dz = dz - offz;
  }
  const float ju = draw(), jv = draw();
  const float jx = (ju - 0.5f) * c[12], jy = (jv - 0.5f) * c[13];
  dx = dx + c[9] * jx + c[6] * jy;
  dy = dy + c[10] * jx + c[7] * jy;
  dz = dz + c[11] * jx + c[8] * jy;
  vnorm(dx, dy, dz, 0.f);
  A.ro[0][i] = ox;
  A.ro[1][i] = oy;
  A.ro[2][i] = oz;
  A.rd[0][i] = dx;
  A.rd[1][i] = dy;
  A.rd[2][i] = dz;
  for (int k = 0; k < 3; ++k) {
    A.L[k][i] = 0.f;
    A.ci[k][i] = 1.f;
    if (A.miss_d[0] != nullptr) {
      A.miss_d[k][i] = 0.f;
      A.miss_w[k][i] = 0.f;
    }
  }
  A.inten[i] = 1.f;
  A.rng[i] = s;
  A.bounce[i] = 0;
  if (A.dls_active != nullptr) A.dls_active[i] = false;
  A.active[i] = true;
  A.unit[i] = id;
}

int launch(void (*kernel)(BounceArgs), const BounceArgs* a, void* stream) {
  if (a->n > 0) {
    const int blocks = (a->n + kThreads - 1) / kThreads;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bounce_prims_launch(const BounceArgs* a, void* stream) {
  if (a->emitter >= 0) return launch(bounce_prims_kernel<kShadowRays>, a, stream);
  return launch(a->flag != nullptr ? bounce_prims_kernel<kOwnAndShadowRays>
                                   : bounce_prims_kernel<kOwnRays>,
                a, stream);
}

extern "C" int bounce_shade_launch(const BounceArgs* a, void* stream) {
  return launch(bounce_shade_kernel, a, stream);
}

extern "C" int lanes_assign_launch(const AssignArgs* a, void* stream) {
  if (a->n > 0) {
    const int blocks = (a->n + kAssignThreads - 1) / kAssignThreads;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    lanes_count_kernel<<<blocks, kAssignThreads, 0, st>>>(*a);
    lanes_assign_kernel<<<blocks, kAssignThreads, 0, st>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}
