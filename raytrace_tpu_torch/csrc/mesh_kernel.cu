// Mesh kernels (Hopper, sm_90a): the path-tracing kernel of mesh scenes
// (three entry points and two yardsticks) and the integrator's nearest
// mesh hit (a fourth entry point and its yardstick).
//
// Replaces raytrace_tpu/ops/pallas/mesh_bounce_kernel.py::bounce_tiles
// (the body `_kernel`, its cluster walk `mesh_walk`) and the in-kernel MXU
// routine raytrace_tpu/ops/pallas/woop.py::mxu_mesh_hit, together with
// the XLA shade of mesh hits in raytrace_tpu/render/fused_mesh.py
// (_mesh_shade). Each thread owns one lane and runs its own bounce loop:
// counter-RNG seed and raygen, closest hit over <= 64 spheres and <= 64
// free triangles (path_common.cuh) and then the mesh, seeded with that
// best t; 8 draws per bounce for every lane (u0..u7; a mesh hit uses u0,
// u1, u2, u4, u5, u6, u7, a sphere / free-triangle hit u0-u3 and u7);
// the shading of either kind, Russian roulette, and in-place
// regeneration of `spl` consecutive sample ids. Only the radiance sum is
// written. On the TPU the kernel could not gather a mesh hit's 48-column
// attribute row and its texels, so mesh hits went back to fused_mesh.py
// pending; here the thread gathers them itself: mt_attr and the int32
// mt_desc descriptors (read as integers, no float bitcast), then up to
// three nearest texels from the pool in its dtype (packed u32, u16 or
// f32), then the PBR bounce.
//
// A path stays with its thread; the nearest mesh hit of a warp's live
// rays is found cooperatively. At every bounce the warp ballots its live
// lanes and takes their rays 32 / G at a time: group k of G threads takes
// the k-th live lane's ray and seed by shuffle, finds its least (t,
// position), and hands (t, position, u, v) back to the owner by shuffle.
// Draws, shading and regeneration stay per thread. The three routes:
//   mesh_trace        replaces bounce_tiles' walk (`mesh_walk`). G =
//                     kTraceGroup = 8 threads a ray run the group walk of
//                     mesh_hit below (`group_walk`): the 3-level slab walk
//                     over the camera-ordered tables of ops/mesh_kernel.
//                     pack_mesh_tables, each level's reached boxes visited
//                     nearest entry first under the group's running best,
//                     a cluster's rows tested G at a time.
//                     Bound on an H100: not bytes (the tables and texels
//                     once, tens of us) nor operations (the exact walk and
//                     the shade, about 8,100 FP32 instructions a
//                     lane-bounce on the a380-class frame; under -fmad=false
//                     each is one instruction, and 132 SMs x 128 lanes x
//                     1.98 GHz = 33.5 T/s make 6.4 ms a 1216x608 launch of
//                     16 samples a lane) but the latency of the walk's
//                     dependent L2 loads and divergence: a thread-per-ray
//                     walk ran, per warp, the union of 32 unrelated walks
//                     once the lanes' paths had left the camera's order.
//                     A group follows one ray, so its threads agree on
//                     every branch, and G loads are in flight a step. The
//                     rays in flight are the resident threads over G, so
//                     the kernel is held to 64 registers (kTraceBlocks = 4
//                     blocks of 256 a SM) and G is 8, not mesh_hit's 16.
//                     The blocks are persistent, as in mesh_trace_brute:
//                     a warp that has finished its lanes takes the next
//                     32-lane tile instead of idling until the slowest
//                     warp of its block is done.
//   mesh_trace_brute  replaces woop.mxu_mesh_hit: every row of the brute
//                     table in f32 Moller-Trumbore (the function the MXU
//                     pass computes, not its bf16 split), G = kBruteGroup
//                     = 32 threads a ray, so a warp spends all its lanes
//                     on its live rays however few are left. Bound: FP32
//                     instructions, 55 counted a triangle test (85 ms a
//                     launch of the 2,097-triangle surface at 1216x608 and
//                     16 samples a lane at 33.5 T/s), plus what the count
//                     leaves out: the IEEE reciprocal's sequence, the row's
//                     three shared loads and the loop. The table is
//                     resident: persistent blocks of 1,024 threads, one a
//                     SM, load it once into dynamic shared memory (up to
//                     123 KB at 2,560 rows), and their warps take 32-lane
//                     tiles from a counter in turn. No barrier in the
//                     bounce loop: a warp leaves when its ballot is empty.
//                     A group's threads test one ray against rows rank,
//                     rank + G, ... (16-byte loads, conflict-free), so a
//                     warp scans the table only for its live rays. On the
//                     H100 the walk is faster than this route on every
//                     mesh measured, so MeshTables gives it no scene
//                     (ops/mesh_kernel.MAX_BRUTE_TRIS = 0); a caller asks
//                     for it by route.
//   mesh_trace_instanced replaces bounce_tiles' two-level instancing
//                     (mesh_bounce_kernel.py:500-544, `inst_body` around
//                     `mesh_walk`): a scene of n copies of one asset, its
//                     asset-local walk tables and an (n, 24) instance table
//                     (models/scene.py). The group of mesh_trace (G =
//                     kTraceGroup) slab-tests the instances' world AABBs
//                     under its running best, one a thread, and takes the
//                     reached ones nearest entry first
//                     (`group_instances_slot`): the ray moved into the
//                     instance frame (o' = A (o - T), d' = A d; d' is not
//                     normalized, so a local t is the world t), the group
//                     walk of the asset's tables seeded with the running
//                     best, the instance's gid base added to the winner.
//                     Bound: operations, as the walk's: what an exact
//                     instanced walk must test (ops/mesh_kernel.
//                     instanced_walk_work: every instance box a live ray, a
//                     transform and the local walk's slab and triangle
//                     tests for each box it reaches under its final t) plus
//                     the shade, in FP32 instructions at 33.5 T/s; what
//                     holds it above that is, as for the walk, the latency
//                     of dependent loads, which only resident warps hide.
//                     The design is therefore about registers and where the
//                     state lives:
//                     - the group's state (the world ray and its slab
//                       reciprocals, the running best and its row, the
//                       chunk's slab entries) sits once in its InstSlot in
//                       shared memory, not on each of its G threads;
//                     - a lane's path state waits in its column of the
//                       lane stash across the search
//                       (warp_nearest_stashed reads the owners' rays and
//                       seeds there and leaves their hits);
//                     - the asset's tables are read through __ldg, as the
//                       walk's: its box levels and counts (4,896 B on the
//                       fleet, a supergroup) stay in L1 and the triangle
//                       rows (0.43 MB) in L2, so no asset is too large.
//                     So it runs 4 blocks of 256 a SM at 64 registers,
//                     against its first design's 2 at 115 (kept as the
//                     yardstick mesh_trace_instanced_first). ptxas still
//                     spills 20-48 B a thread there (20 weyl, 48 with the
//                     sky and pcg), around the shade and not in the walk
//                     (the lane index, the bounce and sample counters, two
//                     of the bounce's draws; the pixel's constants are
//                     recomputed from the stash only where a path starts,
//                     which took the spill down from 80-88 B); the 3-block
//                     build (72 registers) spills nothing but ran 6%
//                     slower.
//                     Measured (scripts/torch_instanced_variants.py, NVIDIA
//                     H100 80GB HBM3 at 700 W, 1216x608 at 16 spl, in
//                     turns): the fleet (17 instances) 113.6 ms a launch,
//                     the walk 117.6, the first design 130.8; the large
//                     fleet (144 instances, 64 MB of flattened tables)
//                     145.0, 246.0 and 170.0. Without the stash the 4-block
//                     build spilled 380-396 B and took 1.46-1.48x the walk;
//                     staging the box levels in shared memory once a block
//                     (the counterpart of the TPU kernel's SMEM box tables,
//                     mesh_bounce_kernel.py:753) moved the launch by under
//                     2% (the fleet 113.8 against 114.1 ms, the large fleet
//                     143.3 against 144.9) and capped the asset's size, so
//                     it was dropped; re-reading the local ray from the
//                     slot at each use (to free 9 registers more) made it
//                     16% slower. The
//                     instances are visited by entry, not in table order,
//                     so that on a secondary ray a near instance's hit
//                     prunes the far ones; the instance table is read with
//                     __ldg (96 B a row, 1.6 KB on the fleet).
// Exactness: each thread keeps its least (t, position) under strict-<
// updates in its own ascending order, and the group takes the
// lexicographic least by a butterfly: among the least t, the least
// position, as the plain versions' `min` (first index) and the scan-order
// resolve keep it; across instances a later one wins only at a smaller t,
// so the earlier instance keeps an exact-t tie. The entries equal
// mesh_trace_reference bitwise.
// The yardsticks, which nothing on a render path launches, are the first
// designs: mesh_trace_per_thread (each thread walks its own ray in the
// camera's scan order, `walk`), mesh_trace_brute_lockstep (the block
// stages 64-row chunks in shared memory with two barriers a chunk and
// keeps one bounce loop in step, `brute`) and mesh_trace_instanced_first
// (the instance loop's and the lane's state in registers,
// `group_instances`).
//
// ptxas (sm_90a, -fmad=false; chip_smoke.py's build phase prints it):
//   mesh_trace_kernel<kBrute, kInst, ...> (the weyl, no-sky instantiations)
//   <false, false> mesh_trace    64 registers, 120 B stack, 9,808 B smem:
//                                4 blocks, 32 resident warps a SM
//   <true, false>                64 registers, 64 B stack, 9,808 B smem +
//   (mesh_trace_brute)           the table (48 B a row, 101,376 B at
//                                2,097 triangles): 1 block, 32 warps a SM
//   <false, true>                64 registers, 48 B stack (20 B of spill
//   (mesh_trace_instanced)       stores), 9,808 B smem + 35,840 B dynamic
//                                (32 InstSlots and the lane stash): 4
//                                blocks, 32 warps a SM
//   mesh_trace_instanced_first_kernel  115 registers, 32 B stack, no
//                                spill, 9,808 B smem: 2 blocks, 16 warps
//   mesh_hit_kernel              48 registers, 24 B stack: 5 blocks, 40
//                                warps a SM
//   mesh_trace_yardstick_kernel  64 (walk, 48 B stack; 32 warps a SM) and
//                                76 registers (lockstep, 13,136 B smem;
//                                24 warps a SM)
//
// The draws, the two normalizes (raygen rsqrt, mesh shade sqrt-then-
// divide with eps 1e-20) and every reference quirk (the raw [0, 1]
// normal-map texel, metal from blue and rough from green, the nearest
// fetch trunc(clip(u * w, 0, w - 1)) without a v flip, zero mesh
// emissive, divert weight 1) follow the JAX package; only float rounding
// (FMA contraction, sinf/cosf, rsqrtf) may differ.
//
// The third entry point, mesh_hit, replaces
// raytrace_tpu/ops/pallas/mesh_hit_kernel.py::mesh_hit_tiles (body
// `_kernel`): the nearest mesh hit (t, global triangle id, u, v) of each
// ray of the integrator and the wavefront driver
// (render/integrator.closest_hit, at every bounce and for every shadow ray
// of direct-light sampling), seeded with the sphere / free-triangle best
// t; a hit counts at t_min <= t < seed (EPS in gpu semantics; the cpu
// semantics' 20*EPS self-hit guard, which the TPU kernel left out). See
// the note at group_walk below for its design.
//
// The cube map (mesh_trace_kernel<kBrute, true>, which the entries
// mesh_trace and mesh_trace_brute launch when given a face table): a live
// lane that hits nothing adds (throughput * inten) * sky(direction) to its
// radiance there, the texel fetched from the sky pool (cubemap.cuh) under
// the face table the block stages; the JAX driver adds the same term per bounce from the kernel's
// miss records (raytrace_tpu/render/fused_mesh.py:343-353). Like the rest of
// this file, it equals mesh_trace_reference bitwise.
//
// Built by raytrace_tpu_torch/kernels/build.py (nvcc -arch sm_90a, no
// --use_fast_math); called through ctypes from ops/mesh_kernel.py. A
// launch the card refuses (too much shared memory, too many threads)
// returns its CUDA error, and the wrapper raises.

#include <math_constants.h>

#include "cubemap.cuh"
#include "mesh_common.cuh"
#include "path_common.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 256;
constexpr int kGroup = 16;   // clusters per supercluster
constexpr int kSGroup = 8;   // superclusters per supergroup
constexpr int kBruteChunk = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;

constexpr int kRayGroup = 16;    // mesh_hit: threads per ray
constexpr int kTraceGroup = 8;   // mesh_trace: threads per ray of the group walk
constexpr int kTraceBlocks = 4;  // mesh_trace: resident blocks an SM asked of ptxas
constexpr int kBruteGroup = 32;  // mesh_trace_brute: threads per ray of the scan
constexpr int kBruteThreads = 1024;  // mesh_trace_brute: one persistent block per SM
constexpr int kInstBlocks = 4;   // mesh_trace_instanced: resident blocks an SM asked of ptxas
constexpr int kInstChunk = 32;   // mesh_trace_instanced: instances ordered together
constexpr int kInstFirstBlocks = 2;  // mesh_trace_instanced_first: resident blocks an SM

struct Mesh {
  const float* sgbounds;  // (n_sg, 8)  [lo xyz, hi xyz, 0, 0]
  const float* sbounds;   // (n_sg * 8, 8)
  const float* bounds;    // (n_sg * 128, 8)
  const int* count;       // valid rows of each cluster
  const float4* tri;      // (Cp, W, 3) float4: v0 xyz e1x | e1yz e2xy | e2z 0 0 0
  const int* gid;         // (Cp, W)
  int n_sg, width;
  const float4* btri;     // (n_brute, 3) float4, the brute route's rows
  const int* bgid;        // (n_brute,), -1 padding
  int n_brute;
  const float* attr;      // (M, 48)
  const int* desc;        // (M, 9) texture [offset, width, height] x 3
  const void* pool;
  int pool_kind;
  long long pool_len;
};

// an instanced scene's instance table and the asset's walk tables (the
// walk's fields of a Mesh); rows null and n 0 elsewhere
struct Inst {
  const float4* rows;  // (n, 6) float4: A (9) | T (3) | AABB lo xyz, hi xyz | gid base | 0
  int n;
  Mesh asset;
};

__device__ __forceinline__ float slab_dir(float d) {
  return fabsf(d) < kEps ? (d < 0.f ? -kEps : kEps) : d;
}

// the slab span [entry, exit] of one [lo xyz, hi xyz, 0, 0] box, loaded
// as two float4 a, b (mesh_bounce_kernel.py:380-396)
__device__ __forceinline__ void slab_span(float4 a, float4 b, const Ray& r, float fx, float fy,
                                          float fz, float& entry, float& exit_) {
  const float t0x = (a.x - r.ox) * fx, t1x = (a.w - r.ox) * fx;
  const float t0y = (a.y - r.oy) * fy, t1y = (b.x - r.oy) * fy;
  const float t0z = (a.z - r.oz) * fz, t1z = (b.y - r.oz) * fz;
  entry = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  exit_ = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
}

// slab test of the box at `box`, pruned by entry < tt
__device__ __forceinline__ bool reach(const float* box, const Ray& r, float fx, float fy,
                                      float fz, float tt) {
  float entry, exit_;
  slab_span(__ldg(reinterpret_cast<const float4*>(box)),
            __ldg(reinterpret_cast<const float4*>(box) + 1), r, fx, fy, fz, entry, exit_);
  return entry <= exit_ && exit_ >= 0.f && entry < tt;
}

__device__ __forceinline__ void test_tri(const Ray& r, float4 a, float4 b, float4 c, int g,
                                         float& tt, int& gid, float& bu, float& bv) {
  float t, u, w;
  if (tri_hit(r, a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, t, u, w) && t < tt) {
    tt = t;
    gid = g;
    bu = u;
    bv = w;
  }
}

// the 3-level cluster walk of one lane (the yardsticks'); tt in: the
// sphere / free-triangle best; a hit counts at t_min <= t < tt (tri_hit
// already implies t >= EPS)
__device__ void walk(const Mesh& m, const Ray& r, float t_min, float& tt, int& gid, float& bu,
                     float& bv) {
  const float fx = 1.f / slab_dir(r.dx);
  const float fy = 1.f / slab_dir(r.dy);
  const float fz = 1.f / slab_dir(r.dz);
  for (int g = 0; g < m.n_sg; ++g) {
    if (!reach(m.sgbounds + 8 * g, r, fx, fy, fz, tt)) continue;
    for (int s = g * kSGroup; s < (g + 1) * kSGroup; ++s) {
      if (!reach(m.sbounds + 8 * s, r, fx, fy, fz, tt)) continue;
      for (int c = s * kGroup; c < (s + 1) * kGroup; ++c) {
        const int cnt = __ldg(m.count + c);
        if (cnt == 0 || !reach(m.bounds + 8 * c, r, fx, fy, fz, tt)) continue;
        const float4* rows = m.tri + static_cast<size_t>(c) * m.width * 3;
        const int* ids = m.gid + static_cast<size_t>(c) * m.width;
        for (int w = 0; w < cnt; ++w) {
          float t, u, v;
          const float4 a = __ldg(rows + 3 * w), b = __ldg(rows + 3 * w + 1),
                       cc = __ldg(rows + 3 * w + 2);
          if (tri_hit(r, a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, cc.x, t, u, v) && t >= t_min &&
              t < tt) {
            tt = t;
            gid = __ldg(ids + w);
            bu = u;
            bv = v;
          }
        }
      }
    }
  }
}

// every triangle of the brute table, staged chunk by chunk (the lockstep
// yardstick's); ALL threads of the block call it (inactive ones only help
// staging)
__device__ void brute(const Mesh& m, const Ray& r, bool active, float4* s_tri, int* s_gid,
                      float& tt, int& gid, float& bu, float& bv) {
  for (int base = 0; base < m.n_brute; base += kBruteChunk) {
    __syncthreads();
    for (int k = threadIdx.x; k < kBruteChunk * 3; k += blockDim.x)
      s_tri[k] = __ldg(m.btri + static_cast<size_t>(base) * 3 + k);
    for (int k = threadIdx.x; k < kBruteChunk; k += blockDim.x)
      s_gid[k] = __ldg(m.bgid + base + k);
    __syncthreads();
    if (!active) continue;
    for (int w = 0; w < kBruteChunk; ++w) {
      const int g = s_gid[w];
      if (g >= 0) test_tri(r, s_tri[3 * w], s_tri[3 * w + 1], s_tri[3 * w + 2], g, tt, gid, bu, bv);
    }
  }
}

// the nearest fetch of descriptor d from the mesh's pool (mesh_common.cuh)
__device__ __forceinline__ bool fetch(const Mesh& m, const int* d, float u, float v,
                                      float3& rgb) {
  return fetch(MeshShade{m.attr, m.desc, m.pool, m.pool_kind, m.pool_len}, d, u, v, rgb);
}

// Shade a mesh hit (integrator.mesh_attrs_dense + fused_mesh._mesh_shade):
// attributes and texels, PBR divert, throughput, RR. Returns survival.
__device__ bool shade_mesh(Path& p, const Mesh& m, int gid, float t, float bu, float bv,
                           float u0, float u1, float u2, float u4, float u5, float u6,
                           float u7, int assured, float max_thres, float inv_thres) {
  const float* a = m.attr + static_cast<size_t>(gid) * kAttrCols;
  const int* d = m.desc + static_cast<size_t>(gid) * kDescCols;
  const float b0 = 1.f - bu - bv;
  auto interp = [&](int c, float& uu, float& vv) {
    uu = b0 * __ldg(a + c) + bu * __ldg(a + c + 2) + bv * __ldg(a + c + 4);
    vv = b0 * __ldg(a + c + 1) + bu * __ldg(a + c + 3) + bv * __ldg(a + c + 5);
  };
  float uu, vv;
  float3 tx;
  float nx = __ldg(a), ny = __ldg(a + 1), nz = __ldg(a + 2);
  if (__ldg(a + 18) > 0.5f) {  // normal map: the raw texel, no 2x-1 remap
    interp(25, uu, vv);
    fetch(m, d + 3, uu, vv, tx);
    const float s = __ldg(a + 12);
    nx = (__ldg(a + 3) * tx.x + __ldg(a + 4) * tx.y + __ldg(a + 5) * tx.z) * s;
    ny = (__ldg(a + 6) * tx.x + __ldg(a + 7) * tx.y + __ldg(a + 8) * tx.z) * s;
    nz = (__ldg(a + 9) * tx.x + __ldg(a + 10) * tx.y + __ldg(a + 11) * tx.z) * s;
    vnorm(nx, ny, nz, 1e-20f);
  }
  float rr = __ldg(a + 13), rg = __ldg(a + 14), rb = __ldg(a + 15);
  interp(19, uu, vv);
  if (fetch(m, d, uu, vv, tx)) {
    rr *= tx.x;
    rg *= tx.y;
    rb *= tx.z;
  }
  float metal = __ldg(a + 16), rough = __ldg(a + 17);
  interp(31, uu, vv);
  if (fetch(m, d + 6, uu, vv, tx)) {  // metal scales blue, rough green
    metal *= tx.z;
    rough *= tx.y;
  }

  const float dx = p.ray.dx, dy = p.ray.dy, dz = p.ray.dz;
  const float px = p.ray.ox + dx * t + nx * kEps;
  const float py = p.ray.oy + dy * t + ny * kEps;
  const float pz = p.ray.oz + dz * t + nz * kEps;
  const float dn = dx * nx + dy * ny + dz * nz;
  const float k2 = 2.f * dn;
  float sx = dx - nx * k2, sy = dy - ny * k2, sz = dz - nz * k2;
  vnorm(sx, sy, sz, 0.f);
  float xdx = dx - nx * dn, xdy = dy - ny * dn, xdz = dz - nz * dn;
  vnorm(xdx, xdy, xdz, 1e-20f);
  const float ydx = ny * xdz - nz * xdy;
  const float ydy = nz * xdx - nx * xdz;
  const float ydz = nx * xdy - ny * xdx;
  const float r_ = sqrtf(u1);
  const float th = kTwoPi * u2;
  const float ca = r_ * cosf(th), sa = r_ * sinf(th);
  const float zz = sqrtf(fmaxf(1.f - u1, 0.f));
  // PBR divert (mesh/triangle.rs:190-226): r0 = 0.04 + 0.96 metal,
  // refl = r0 + (1 - r0)(1 - |d.n|^5); diffuse when u0 < 1 - refl
  const float r0 = 0.04f + 0.96f * metal;
  const float adn = fabsf(dn);
  const float a2 = adn * adn;
  const float refl = r0 + (1.f - r0) * (1.f - a2 * a2 * adn);
  float bx = sx, by = sy, bz = sz;
  if (u0 < 1.f - refl) {
    bx = xdx * ca + ydx * sa + nx * zz;
    by = xdy * ca + ydy * sa + ny * zz;
    bz = xdz * ca + ydz * sa + nz * zz;
  }
  float scx = u4, scy = u5, scz = u6;
  vnorm(scx, scy, scz, 1e-20f);
  float ndx = bx + scx * rough, ndy = by + scy * rough, ndz = bz + scz * rough;
  vnorm(ndx, ndy, ndz, 0.f);

  // mesh emissive is zero (trace.wgsl:509); divert weight 1
  p.cir *= rr;
  p.cig *= rg;
  p.cib *= rb;
  if (p.depth >= assured && u7 > max_thres) {
    p.lr += p.cir * inv_thres * p.inten;
    p.lg += p.cig * inv_thres * p.inten;
    p.lb += p.cib * inv_thres * p.inten;
    p.cir *= inv_thres;
    p.cig *= inv_thres;
    p.cib *= inv_thres;
    return false;
  }
  p.ray.ox = px;
  p.ray.oy = py;
  p.ray.oz = pz;
  p.ray.dx = ndx;
  p.ray.dy = ndy;
  p.ray.dz = ndz;
  p.depth += 1;
  return true;
}

// ---- the group walk: one ray, G threads of one warp ----
//
// mesh_hit (below) replaces raytrace_tpu/ops/pallas/mesh_hit_kernel.py::
// mesh_hit_tiles and is this walk alone, a group of kRayGroup threads per
// ray; mesh_trace runs it for the rays of its warp. What bounds it on an
// H100 is neither bytes nor operations: a mesh_hit launch of the
// wavefront's 131,072 a380-class rays moves about 12.7 MB (the tables
// once, 28 B in and 16 B out per ray: about 4 us at 3.35 TB/s), and the
// walk any exact traversal needs on such rays (counted by
// ops/mesh_kernel.walk_work) is tens of microseconds at the FP32 peak of
// single instructions (33.5 T/s under -fmad=false). The time goes to the
// latency of the walk's dependent loads and to divergence. The design:
//  - divergence: a group of G threads of one warp follows one ray, so the
//    threads of a group agree on every branch of the walk. The
//    wavefront's pool holds rays of unrelated pixels and bounce depths;
//    with a thread per ray a warp ran the union of 32 rays' walks;
//  - latency and occupancy: the children of a node are contiguous 32 B
//    rows, tested by the group's threads at once (one box a thread), and
//    a cluster's rows are tested in rounds of G 48 B rows; the launch has
//    G threads a ray, enough loads in flight to cover L2 latency on all
//    SMs;
//  - order: at each level the group visits the reached children nearest
//    slab entry first (a group argmin) and re-tests each against the
//    running best t before it descends; the best is shared by a shuffle
//    reduction after every cluster. The walk so follows the ray's own
//    order, not the camera's order of pack_mesh_tables, and the nearest
//    hit, found early, prunes the rest with the same slab test as `walk`;
//  - exactness: each thread keeps its best (t, scan position cluster * W
//    + row) under the same tri_hit arithmetic, and a final reduction takes
//    the least (t, position). The winner does not depend on the visiting
//    order and equals mesh_hit_walk's except where an exact-t tie (or an
//    ulp-level slab / triangle disagreement) straddles a box whose entry
//    equals the running best;
//  - dead lanes (no seed above t_min, as a -INF seed) write their result
//    before any table load.
// The top levels (4.6 KB on the a380-class scene) are read through __ldg
// and stay in L1; they are not staged in shared memory.

constexpr int kSgChunk = 16;  // supergroups ordered together at the top level

template <int G>
struct Group {
  static_assert(32 % G == 0, "a group lies within one warp");
  unsigned mask;  // this group's lanes of its warp
  int rank;       // 0 .. G - 1
};

// the group of G threads this thread belongs to (lanes G k .. G k + G - 1)
template <int G>
__device__ __forceinline__ Group<G> lane_group() {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const unsigned bits = G == 32 ? kFull : (1u << G) - 1u;
  return Group<G>{bits << (lane & ~(G - 1)), lane & (G - 1)};
}

// per-thread slots of a level of F children: child k * G + rank in slot k
template <int G, int F>
struct Slots {
  static constexpr int K = (F + G - 1) / G;
  float e[K];  // slab entry of a reached child; +inf otherwise, or once visited
};

template <int G>
__device__ __forceinline__ float group_min(const Group<G>& g, float v) {
#pragma unroll
  for (int s = G / 2; s > 0; s >>= 1) v = fminf(v, __shfl_xor_sync(g.mask, v, s, G));
  return v;
}

// The group's least (t, position) with its (u, v), on every thread of the
// group: a butterfly over the threads' own bests.
template <int G>
__device__ __forceinline__ void group_least(const Group<G>& g, float& ct, int& cpos, float& cu,
                                            float& cv) {
#pragma unroll
  for (int sh = G / 2; sh > 0; sh >>= 1) {
    const float ot = __shfl_xor_sync(g.mask, ct, sh, G);
    const int op = __shfl_xor_sync(g.mask, cpos, sh, G);
    const float ou = __shfl_xor_sync(g.mask, cu, sh, G);
    const float ov = __shfl_xor_sync(g.mask, cv, sh, G);
    if (ot < ct || (ot == ct && op < cpos)) {
      ct = ot;
      cpos = op;
      cu = ou;
      cv = ov;
    }
  }
}

// Slab test of boxes first .. first + n - 1 (n <= F) into the slots, pruned
// by entry < best; with `counts`, empty (padding) clusters stay +inf untested.
template <int G, int F>
__device__ __forceinline__ void test_level(Slots<G, F>& s, const Group<G>& g, const float* boxes,
                                           const int* counts, int first, int n, const Ray& r,
                                           float fx, float fy, float fz, float best) {
#pragma unroll
  for (int k = 0; k < Slots<G, F>::K; ++k) {
    const int j = k * G + g.rank;
    float e = CUDART_INF_F;
    if (j < n && (counts == nullptr || __ldg(counts + first + j) > 0)) {
      const float4* b = reinterpret_cast<const float4*>(boxes) + 2 * (first + j);
      float entry, exit_;
      slab_span(__ldg(b), __ldg(b + 1), r, fx, fy, fz, entry, exit_);
      if (entry <= exit_ && exit_ >= 0.f && entry < best) e = entry;
    }
    s.e[k] = e;
  }
}

// The reached child of least entry (ties to the least index) that still
// has entry < best, taken out of the slots; -1 when none is left. The
// same on every thread of the group.
template <int G, int F>
__device__ __forceinline__ int pop_nearest(Slots<G, F>& s, const Group<G>& g, float best) {
  float e = s.e[0];
  int j = g.rank;
#pragma unroll
  for (int k = 1; k < Slots<G, F>::K; ++k) {
    if (s.e[k] < e) {
      e = s.e[k];
      j = k * G + g.rank;
    }
  }
#pragma unroll
  for (int sh = G / 2; sh > 0; sh >>= 1) {
    const float oe = __shfl_xor_sync(g.mask, e, sh, G);
    const int oj = __shfl_xor_sync(g.mask, j, sh, G);
    if (oe < e || (oe == e && oj < j)) {
      e = oe;
      j = oj;
    }
  }
  if (!(e < best)) return -1;
#pragma unroll
  for (int k = 0; k < Slots<G, F>::K; ++k)
    if (k * G + g.rank == j) s.e[k] = CUDART_INF_F;
  return j;
}

// A group's state in mesh_trace_instanced's instance loop, in shared
// memory: the same on all G threads, so it is kept once and not in each
// thread's registers across the nested group walk. The world ray and its
// slab reciprocals, the running best hit (t, global gid, u, v) and its
// instance row (-1: the seed stands), the gid base of the instance walked,
// and the slab entries of the chunk's instances (+inf: not reached, or
// visited). Padded to kSlotWords, 8 modulo 32, so that the four groups of
// a warp read a field from four different banks.
constexpr int kSlotFields = 15;
constexpr int kSlotWords = (kSlotFields + kInstChunk - 8 + 31) / 32 * 32 + 8;

struct InstSlot {
  float ox, oy, oz, dx, dy, dz;
  float fx, fy, fz;
  float ct, cu, cv;
  int gid, crow, gbase;
  float e[kInstChunk];
  float pad[kSlotWords - kSlotFields - kInstChunk];
};
static_assert(sizeof(InstSlot) == 4 * kSlotWords, "InstSlot is kSlotWords words");

// The nearest hit of ray r (the same on every thread of the group) with
// t_min <= t < t_seed: (t, scan position, u, v) on every thread of the
// group; position -1 and t = t_seed, u = v = 0 without one.
template <int G>
__device__ __forceinline__ void group_walk(const Mesh& m, const Group<G>& g, const Ray& r,
                                           float t_seed, float t_min, float& ct, int& cpos,
                                           float& cu, float& cv) {
  const float fx = 1.f / slab_dir(r.dx);
  const float fy = 1.f / slab_dir(r.dy);
  const float fz = 1.f / slab_dir(r.dz);
  float best = t_seed;  // the group's running best t
  ct = t_seed;          // this thread's best hit, its scan position (-1:
  cpos = -1;            // none, the seed) and barycentrics
  cu = cv = 0.f;

  for (int base = 0; base < m.n_sg; base += kSgChunk) {
    Slots<G, kSgChunk> s1;
    test_level(s1, g, m.sgbounds, nullptr, base, min(kSgChunk, m.n_sg - base), r, fx, fy, fz,
               best);
    for (int j1; (j1 = pop_nearest(s1, g, best)) >= 0;) {
      const int sg = base + j1;
      Slots<G, kSGroup> s2;
      test_level(s2, g, m.sbounds, nullptr, sg * kSGroup, kSGroup, r, fx, fy, fz, best);
      for (int j2; (j2 = pop_nearest(s2, g, best)) >= 0;) {
        const int sc = sg * kSGroup + j2;
        Slots<G, kGroup> s3;
        test_level(s3, g, m.bounds, m.count, sc * kGroup, kGroup, r, fx, fy, fz, best);
        for (int j3; (j3 = pop_nearest(s3, g, best)) >= 0;) {
          const int c = sc * kGroup + j3;
          const int cnt = __ldg(m.count + c);
          for (int w = g.rank; w < cnt; w += G) {
            const int pos = c * m.width + w;
            const float4* row = m.tri + 3 * static_cast<size_t>(pos);
            const float4 a = __ldg(row), b = __ldg(row + 1), cc = __ldg(row + 2);
            float t, u, v;
            if (tri_hit(r, a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, cc.x, t, u, v) &&
                t >= t_min && (t < ct || (t == ct && pos < cpos))) {
              ct = t;
              cpos = pos;
              cu = u;
              cv = v;
            }
          }
          best = group_min(g, ct);
        }
      }
    }
  }
  // the least (t, scan position) of the group; hits all lie below the seed
  group_least(g, ct, cpos, cu, cv);
}

// One ray against every row of the resident brute table: the group's
// threads test rows rank, rank + G, ... in ascending order (strict <, so
// each keeps its least row among equal t), then the group takes the least
// (t, row). Rows past the mesh are zero triangles (det 0), never a hit.
template <int G>
__device__ __forceinline__ void group_brute(const Group<G>& g, const float4* rows, int n_rows,
                                            const Ray& r, float& ct, int& cpos, float& cu,
                                            float& cv) {
  for (int w = g.rank; w < n_rows; w += G) {
    const float4 a = rows[3 * w], b = rows[3 * w + 1], c = rows[3 * w + 2];
    float t, u, v;
    if (tri_hit(r, a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, t, u, v) && t < ct) {
      ct = t;
      cpos = w;
      cu = u;
      cv = v;
    }
  }
  group_least(g, ct, cpos, cu, cv);
}

// The nearest hit of ray r (the same on every thread of the group) over
// the instances of an instanced scene, hits below t_seed: (t, global gid,
// u, v) on every thread of the group; gid -1 and t = t_seed, u = v = 0
// without one. The group slab-tests the world AABBs of kInstChunk
// instances at once (one a thread, as test_level) and visits the reached
// ones nearest entry first, each re-tested against the running best (as
// the walk visits its boxes): the ray moved into the instance frame (the
// JAX order of terms, mesh_bounce_kernel.py:532-540), the group walk of the
// asset's tables seeded with the running best, the instance's gid base
// added to the local id. The result is the plain version's, which takes
// the instances in table order with strict <: the least (t, table row,
// scan position), since an instance of an earlier row than the winning
// instance's walks with its seed one ulp above the best, so it takes an
// exact-t tie (a t equal to the seed t_seed itself stays out, as there).
template <int G>
__device__ __forceinline__ void group_instances(const Inst& in, const Group<G>& g, const Ray& r,
                                                float t_seed, float& ct, int& gid, float& cu,
                                                float& cv) {
  const float fx = 1.f / slab_dir(r.dx);
  const float fy = 1.f / slab_dir(r.dy);
  const float fz = 1.f / slab_dir(r.dz);
  ct = t_seed;
  gid = -1;
  cu = cv = 0.f;
  int crow = -1;  // the winning instance's table row; -1: none (the seed stands)
  for (int base = 0; base < in.n; base += kInstChunk) {
    Slots<G, kInstChunk> s;
    const float reach_t = nextafterf(ct, CUDART_INF_F);  // entry <= the best
#pragma unroll
    for (int k = 0; k < Slots<G, kInstChunk>::K; ++k) {
      const int j = k * G + g.rank;
      float e = CUDART_INF_F;
      if (base + j < in.n) {
        const float4* row = in.rows + 6 * (base + j);
        float entry, exit_;
        slab_span(__ldg(row + 3), __ldg(row + 4), r, fx, fy, fz, entry, exit_);
        if (entry <= exit_ && exit_ >= 0.f && entry < reach_t) e = entry;
      }
      s.e[k] = e;
    }
    for (int j; (j = pop_nearest(s, g, nextafterf(ct, CUDART_INF_F))) >= 0;) {
      const int k = base + j;
      const float4* row = in.rows + 6 * k;
      const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);  // A 0:9, T c.yzw
      const float rx = r.ox - c.y, ry = r.oy - c.z, rz = r.oz - c.w;
      const Ray q{a.x * rx + a.y * ry + a.z * rz,
                  a.w * rx + b.x * ry + b.y * rz,
                  b.z * rx + b.w * ry + c.x * rz,
                  a.x * r.dx + a.y * r.dy + a.z * r.dz,
                  a.w * r.dx + b.x * r.dy + b.y * r.dz,
                  b.z * r.dx + b.w * r.dy + c.x * r.dz};
      float t, u, v;
      int pos;
      const bool earlier = crow >= 0 && k < crow;  // takes an exact-t tie from the winner
      group_walk(in.asset, g, q, earlier ? nextafterf(ct, CUDART_INF_F) : ct, kEps, t, pos, u, v);
      if (pos >= 0) {  // below the seed: the same on every thread of the group
        ct = t;
        crow = k;
        gid = __ldg(in.asset.gid + pos) + static_cast<int>(__ldg(row + 4).z);
        cu = u;
        cv = v;
      }
    }
  }
}

// The chunk's reached instance of least slab entry (ties to the least
// index) that still has entry <= the running best, marked visited; -1 when
// none is left. pop_nearest's choice, on the slot's entries; the same on
// every thread of the group.
template <int G>
__device__ __forceinline__ int pop_entry(InstSlot& s, const Group<G>& g) {
  float e = s.e[g.rank];
  int j = g.rank;
#pragma unroll
  for (int k = 1; k < kInstChunk / G; ++k) {
    if (s.e[k * G + g.rank] < e) {
      e = s.e[k * G + g.rank];
      j = k * G + g.rank;
    }
  }
#pragma unroll
  for (int sh = G / 2; sh > 0; sh >>= 1) {
    const float oe = __shfl_xor_sync(g.mask, e, sh, G);
    const int oj = __shfl_xor_sync(g.mask, j, sh, G);
    if (oe < e || (oe == e && oj < j)) {
      e = oe;
      j = oj;
    }
  }
  if (!(e < nextafterf(s.ct, CUDART_INF_F))) return -1;
  if (g.rank == 0) s.e[j] = CUDART_INF_F;  // read by all before the butterfly
  return j;
}

// group_instances with the group's state in its shared-memory slot `s`:
// the same instances in the same order under the same seeds, so the same
// result, left in s (ct, gid, cu, cv). Nothing of the instance loop is
// live in registers across the nested group walk but the chunk's base:
// each pop re-reads the entries and the running best from the slot. Every
// write is rank 0's, followed by __syncwarp before the group reads it.
template <int G>
__device__ __forceinline__ void group_instances_slot(const Inst& in, const Group<G>& g,
                                                     InstSlot& s, const Ray& r, float t_seed) {
  static_assert(kInstChunk % G == 0, "a chunk is whole rounds of the group");
  if (g.rank == 0) {
    s.ox = r.ox;
    s.oy = r.oy;
    s.oz = r.oz;
    s.dx = r.dx;
    s.dy = r.dy;
    s.dz = r.dz;
    s.fx = 1.f / slab_dir(r.dx);
    s.fy = 1.f / slab_dir(r.dy);
    s.fz = 1.f / slab_dir(r.dz);
    s.ct = t_seed;
    s.cu = s.cv = 0.f;
    s.gid = s.crow = -1;
  }
  __syncwarp(g.mask);
  for (int base = 0; base < in.n; base += kInstChunk) {
    const float reach_t = nextafterf(s.ct, CUDART_INF_F);  // entry <= the best
    const Ray w{s.ox, s.oy, s.oz, s.dx, s.dy, s.dz};
#pragma unroll
    for (int k = 0; k < kInstChunk / G; ++k) {
      const int j = k * G + g.rank;
      float e = CUDART_INF_F;
      if (base + j < in.n) {
        const float4* row = in.rows + 6 * (base + j);
        float entry, exit_;
        slab_span(__ldg(row + 3), __ldg(row + 4), w, s.fx, s.fy, s.fz, entry, exit_);
        if (entry <= exit_ && exit_ >= 0.f && entry < reach_t) e = entry;
      }
      s.e[j] = e;
    }
    __syncwarp(g.mask);
    for (int j; (j = pop_entry(s, g)) >= 0;) {
      const int k = base + j;
      const float4* row = in.rows + 6 * k;
      const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);  // A 0:9, T c.yzw
      const float rx = s.ox - c.y, ry = s.oy - c.z, rz = s.oz - c.w;
      const float dx = s.dx, dy = s.dy, dz = s.dz;
      const Ray q{a.x * rx + a.y * ry + a.z * rz,
                  a.w * rx + b.x * ry + b.y * rz,
                  b.z * rx + b.w * ry + c.x * rz,
                  a.x * dx + a.y * dy + a.z * dz,
                  a.w * dx + b.x * dy + b.y * dz,
                  b.z * dx + b.w * dy + c.x * dz};
      if (g.rank == 0) s.gbase = static_cast<int>(__ldg(row + 4).z);
      const float ct = s.ct;
      const bool earlier = s.crow >= 0 && k < s.crow;  // takes an exact-t tie from the winner
      float t, u, v;
      int pos;
      group_walk(in.asset, g, q, earlier ? nextafterf(ct, CUDART_INF_F) : ct, kEps, t, pos, u,
                 v);
      if (pos >= 0 && g.rank == 0) {  // below the seed: the same on every thread of the group
        s.ct = t;
        s.crow = k;
        s.gid = __ldg(in.asset.gid + pos) + s.gbase;
        s.cu = u;
        s.cv = v;
      }
      __syncwarp(g.mask);
    }
  }
}

// The groups' InstSlots: the start of the block's (writable) dynamic shared
// memory.
__device__ __forceinline__ InstSlot* inst_slots(const float4* rows) {
  return reinterpret_cast<InstSlot*>(const_cast<float4*>(rows));
}

// mesh_trace_instanced's lane stash: what a lane holds across
// the nearest-hit search, in shared memory past the InstSlots, a field's
// kThreads values together (lane t of field f at f * kThreads + t, so a
// warp's accesses are conflict-free). trace_lane stores it before the
// search and reloads it after, so no register carries it across the
// nested walk; warp_nearest_stashed reads the owners' rays and seeds from
// it and leaves their hits there.
enum StashField {
  kStOx, kStOy, kStOz, kStDx, kStDy, kStDz,  // the path's ray
  kStCir, kStCig, kStCib, kStInten, kStLr, kStLg, kStLb, kStDepth, kStState, kStSk,
  kStX, kStY, kStSamp0,        // the pixel and the first sample id (stored once)
  kStTBest, kStKind, kStBest,  // the sphere / free-triangle hit
  kStT, kStPos, kStU, kStV,    // the search's seed in, the mesh hit out
  kStashFields
};

// lane t's column of the stash
__device__ __forceinline__ float* lane_stash(const float4* rows, int t) {
  return reinterpret_cast<float*>(inst_slots(rows) + kThreads / kTraceGroup) + t;
}

__device__ __forceinline__ void stash_lane(float* c, const Path& p, uint32_t state, int sk,
                                           float t_best, int kind, int best) {
  int* ci = reinterpret_cast<int*>(c);
  c[kStOx * kThreads] = p.ray.ox;
  c[kStOy * kThreads] = p.ray.oy;
  c[kStOz * kThreads] = p.ray.oz;
  c[kStDx * kThreads] = p.ray.dx;
  c[kStDy * kThreads] = p.ray.dy;
  c[kStDz * kThreads] = p.ray.dz;
  c[kStCir * kThreads] = p.cir;
  c[kStCig * kThreads] = p.cig;
  c[kStCib * kThreads] = p.cib;
  c[kStInten * kThreads] = p.inten;
  c[kStLr * kThreads] = p.lr;
  c[kStLg * kThreads] = p.lg;
  c[kStLb * kThreads] = p.lb;
  ci[kStDepth * kThreads] = p.depth;
  ci[kStState * kThreads] = static_cast<int>(state);
  ci[kStSk * kThreads] = sk;
  c[kStTBest * kThreads] = t_best;
  ci[kStKind * kThreads] = kind;
  ci[kStBest * kThreads] = best;
  c[kStT * kThreads] = t_best;  // the seed; the search leaves (t, pos, u, v) of a mesh hit
  ci[kStPos * kThreads] = -1;
  c[kStU * kThreads] = 0.f;
  c[kStV * kThreads] = 0.f;
}

__device__ __forceinline__ void unstash_lane(const float* c, Path& p, uint32_t& state, int& sk,
                                             float& t_best, int& kind, int& best, float& tm,
                                             int& pos, float& bu, float& bv) {
  const int* ci = reinterpret_cast<const int*>(c);
  p.ray = Ray{c[kStOx * kThreads], c[kStOy * kThreads], c[kStOz * kThreads],
              c[kStDx * kThreads], c[kStDy * kThreads], c[kStDz * kThreads]};
  p.cir = c[kStCir * kThreads];
  p.cig = c[kStCig * kThreads];
  p.cib = c[kStCib * kThreads];
  p.inten = c[kStInten * kThreads];
  p.lr = c[kStLr * kThreads];
  p.lg = c[kStLg * kThreads];
  p.lb = c[kStLb * kThreads];
  p.depth = ci[kStDepth * kThreads];
  state = static_cast<uint32_t>(ci[kStState * kThreads]);
  sk = ci[kStSk * kThreads];
  t_best = c[kStTBest * kThreads];
  kind = ci[kStKind * kThreads];
  best = ci[kStBest * kThreads];
  tm = c[kStT * kThreads];
  pos = ci[kStPos * kThreads];
  bu = c[kStU * kThreads];
  bv = c[kStV * kThreads];
}

// warp_nearest for mesh_trace_instanced with the lane stash: group k of the
// warp takes the k-th lowest live lane left, reads its ray and seed from
// the owner's stash column, searches the instances (group_instances_slot)
// and rank 0 leaves (t, gid, u, v) in that column. Every lane of the warp
// calls it, after stashing its own state.
template <int G>
__device__ __forceinline__ void warp_nearest_stashed(unsigned live, const float4* rows,
                                                     const Inst& inst) {
  const Group<G> g = lane_group<G>();
  const int slot = static_cast<int>(threadIdx.x & 31) / G;
  const int warp0 = static_cast<int>(threadIdx.x & ~31u);
  InstSlot& s = inst_slots(rows)[threadIdx.x / G];
  __syncwarp();  // the owners' stashes are written
  unsigned todo = live;
  while (todo) {  // the same on every lane of the warp
    int owner = -1;
#pragma unroll
    for (int k = 0; k < 32 / G; ++k) {
      const unsigned low = todo & (0u - todo);  // lowest live lane left, 0 when none
      if (k == slot && low) owner = __ffs(low) - 1;
      todo ^= low;
    }
    if (owner >= 0) {
      float* c = lane_stash(rows, warp0 + owner);
      const float seed = c[kStT * kThreads];
      if (seed > kEps) {  // a seed at or below EPS leaves no t to find
        const Ray q{c[kStOx * kThreads], c[kStOy * kThreads], c[kStOz * kThreads],
                    c[kStDx * kThreads], c[kStDy * kThreads], c[kStDz * kThreads]};
        group_instances_slot(inst, g, s, q, seed);
        if (g.rank == 0) {
          c[kStT * kThreads] = s.ct;
          reinterpret_cast<int*>(c)[kStPos * kThreads] = s.gid;
          c[kStU * kThreads] = s.cu;
          c[kStV * kThreads] = s.cv;
        }
      }
    }
    __syncwarp();
  }
}

// The instanced walk's designs (the template argument kInst of warp_nearest
// and trace_lane): none, mesh_trace_instanced's (the group's state in its
// InstSlot and the lane's in the stash, warp_nearest_stashed) and the first
// design's (in registers, warp_nearest; the yardstick)
enum InstDesign { kNoInst = 0, kInstSlots = 1, kInstFirst = 2 };

// The nearest mesh hits of the warp's live rays (bit k of `live`: lane
// k's ray r, seeded with tm), G threads a ray and 32 / G rays a round:
// group k of the warp takes the k-th lowest live lane left, its ray and
// seed by shuffle, and rank 0 of the group hands (t, position, u, v)
// back to the owner by shuffle. Every lane of the warp calls it; on
// return each live lane holds its own in (tm, pos, bu, bv), position -1
// without a hit. kBrute: the resident table `rows` (n_rows); kInst: the
// instances of `inst` (kInstFirst: group_instances), pos then the global
// gid; else the walk of m, t_min EPS.
template <int G, bool kBrute, int kInst>
__device__ __forceinline__ void warp_nearest(unsigned live, const Ray& r, const Mesh& m,
                                             const float4* rows, int n_rows, const Inst& inst,
                                             float& tm, int& pos, float& bu, float& bv) {
  static_assert(!(kBrute && kInst), "the brute route and instancing exclude each other");
  static_assert(kInst != kInstSlots, "mesh_trace_instanced searches in warp_nearest_stashed");
  const Group<G> g = lane_group<G>();
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int slot = lane / G;
  const unsigned below = (1u << lane) - 1u;
  unsigned todo = live;
  while (todo) {  // the same on every lane of the warp
    unsigned taken = 0u;
    int owner = -1;
#pragma unroll
    for (int k = 0; k < 32 / G; ++k) {
      const unsigned low = todo & (0u - todo);  // lowest live lane left, 0 when none
      if (k == slot && low) owner = __ffs(low) - 1;
      taken |= low;
      todo ^= low;
    }
    const int src = owner < 0 ? lane : owner;
    const Ray q{__shfl_sync(kFull, r.ox, src), __shfl_sync(kFull, r.oy, src),
                __shfl_sync(kFull, r.oz, src), __shfl_sync(kFull, r.dx, src),
                __shfl_sync(kFull, r.dy, src), __shfl_sync(kFull, r.dz, src)};
    const float seed = __shfl_sync(kFull, tm, src);
    float ct = seed, cu = 0.f, cv = 0.f;
    int cpos = -1;
    if (owner >= 0 && seed > kEps) {  // a seed at or below EPS leaves no t to find
      if constexpr (kBrute) {
        group_brute(g, rows, n_rows, q, ct, cpos, cu, cv);
      } else if constexpr (kInst == kInstFirst) {
        group_instances(inst, g, q, seed, ct, cpos, cu, cv);
      } else {
        group_walk(m, g, q, seed, kEps, ct, cpos, cu, cv);
      }
    }
    __syncwarp();
    const bool mine = (taken >> lane) & 1u;
    const int from = mine ? __popc(taken & below) * G : lane;  // rank 0 of my ray's group
    ct = __shfl_sync(kFull, ct, from);
    cpos = __shfl_sync(kFull, cpos, from);
    cu = __shfl_sync(kFull, cu, from);
    cv = __shfl_sync(kFull, cv, from);
    if (mine) {
      tm = ct;
      pos = cpos;
      bu = cu;
      bv = cv;
    }
  }
}

// The sphere / free-triangle tables and the camera, staged by the block.
__device__ __forceinline__ void stage_scene(float* sph, const float* sph_g, int n_sph, float* ft,
                                            const float* ft_g, int n_ft, float* cam,
                                            const float* cam_g) {
  for (int k = threadIdx.x; k < n_sph * kSphCols; k += blockDim.x) sph[k] = sph_g[k];
  for (int k = threadIdx.x; k < n_ft * kFtCols; k += blockDim.x) ft[k] = ft_g[k];
  for (int k = threadIdx.x; k < kCamLen; k += blockDim.x) cam[k] = cam_g[k];
}

struct Lanes {
  const int32_t* xs;
  const int32_t* ys;
  const int32_t* samp;
  int n, n_sph, n_ft, has_lens, assured, max_bounces, spl;
  float* out;
};

// The whole path of lane i (inactive when i >= n), its nearest mesh hits
// found with the rest of its warp (warp_nearest); every lane of the warp
// calls it. kInst (an InstDesign): the nearest mesh hit over the instances
// of `inst`; kSky: a lane that hits nothing adds the sky's term (s_face the
// staged face table); kPcg: the draws from the pcg generator, else weyl.
template <bool kBrute, int kInst, bool kSky, bool kPcg>
__device__ __forceinline__ void trace_lane(int i, const Lanes& L, const float* sph,
                                           const float* ft, const float* cam, const Mesh& m,
                                           const float4* rows, const Inst& inst, const Sky& sky,
                                           const int* s_face) {
  bool active = i < L.n;
  int xi = active ? L.xs[i] : 0, yi = active ? L.ys[i] : 0;
  uint32_t hpix = jenkins(static_cast<uint32_t>(xi) ^ (static_cast<uint32_t>(yi) << 16));
  float s_x = cam[12] * (static_cast<float>(xi) - cam[14]);
  float s_y = cam[13] * (static_cast<float>(yi) - cam[15]);
  float bdx = cam[3] + s_x * cam[9] + s_y * cam[6];
  float bdy = cam[4] + s_x * cam[10] + s_y * cam[7];
  float bdz = cam[5] + s_x * cam[11] + s_y * cam[8];
  float max_thres = cam[17];
  float inv_thres = 1.0f / max_thres;

  uint32_t samp0 = active ? static_cast<uint32_t>(L.samp[i]) : 0u;
  uint32_t state;
  Path p;
  p.ray = start_sample<kPcg>(hpix, samp0, state, bdx, bdy, bdz, cam, L.has_lens);
  p.lr = p.lg = p.lb = 0.f;
  p.cir = p.cig = p.cib = p.inten = 1.f;
  p.depth = 0;
  int sk = 0;
  if constexpr (kInst == kInstSlots) {
    int* c = reinterpret_cast<int*>(lane_stash(rows, threadIdx.x));
    c[kStX * kThreads] = xi;
    c[kStY * kThreads] = yi;
    c[kStSamp0 * kThreads] = static_cast<int>(samp0);
  }

  const int n_iter = L.max_bounces * L.spl;  // never cuts a lane short (trace_kernel.cu)
  for (int it = 0; it < n_iter; ++it) {
    const unsigned live = __ballot_sync(kFull, active);
    if (!live) break;  // the warp leaves together; it never waits on another warp
    float t_best = kInf;
    int kind = 0, best = 0;
    if (active) closest_sph_ft(p.ray, sph, L.n_sph, ft, L.n_ft, t_best, kind, best);
    float tm = t_best, bu = 0.f, bv = 0.f;
    int pos = -1;
    if constexpr (kInst == kInstSlots) {
      // the lane's state waits in its stash column (the pixel's constants
      // are recomputed from it where a path starts, below)
      float* c = lane_stash(rows, threadIdx.x);
      stash_lane(c, p, state, sk, t_best, kind, best);
      warp_nearest_stashed<kTraceGroup>(live, rows, inst);
      unstash_lane(c, p, state, sk, t_best, kind, best, tm, pos, bu, bv);
      max_thres = cam[17];
      inv_thres = 1.0f / max_thres;
    } else {
      warp_nearest<kBrute ? kBruteGroup : kTraceGroup, kBrute, kInst>(live, p.ray, m, rows,
                                                                       m.n_brute, inst, tm, pos,
                                                                       bu, bv);
    }
    if (!active) continue;
    const int mgid = kInst ? pos : pos < 0 ? -1 : __ldg((kBrute ? m.bgid : m.gid) + pos);

    // ---- the 8 draws of every bounce of a mesh scene ----
    const float u0 = next_uniform<kPcg>(state);
    const float u1 = next_uniform<kPcg>(state);
    const float u2 = next_uniform<kPcg>(state);
    const float u3 = next_uniform<kPcg>(state);  // drawn, used by sphere / free-triangle hits only
    const float u4 = next_uniform<kPcg>(state);
    const float u5 = next_uniform<kPcg>(state);
    const float u6 = next_uniform<kPcg>(state);
    const float u7 = next_uniform<kPcg>(state);

    bool survive = false;
    if (mgid >= 0) {
      survive = shade_mesh(p, m, mgid, tm, bu, bv, u0, u1, u2, u4, u5, u6, u7, L.assured,
                           max_thres, inv_thres);
    } else if (kind != 0) {
      survive = shade_sph_ft(p, sph, ft, kind, best, t_best, u0, u1, u2, u3, u7, L.assured,
                             max_thres, inv_thres);
    } else if constexpr (kSky) {  // a miss: L += (ci * inten) * sky(d), the path ends
      const float3 c = sky_rgb(s_face, sky, p.ray.dx, p.ray.dy, p.ray.dz);
      p.lr += p.cir * p.inten * c.x;
      p.lg += p.cig * p.inten * c.y;
      p.lb += p.cib * p.inten * c.z;
    }

    if (L.spl > 1) {
      const bool alive = survive && p.depth < L.max_bounces;
      const bool regen = !alive && sk + 1 < L.spl;
      if (regen) {
        ++sk;
        if constexpr (kInst == kInstSlots) {  // as at the top, from the stash
          const int* c = reinterpret_cast<const int*>(lane_stash(rows, threadIdx.x));
          xi = c[kStX * kThreads];
          yi = c[kStY * kThreads];
          samp0 = static_cast<uint32_t>(c[kStSamp0 * kThreads]);
          hpix = jenkins(static_cast<uint32_t>(xi) ^ (static_cast<uint32_t>(yi) << 16));
          s_x = cam[12] * (static_cast<float>(xi) - cam[14]);
          s_y = cam[13] * (static_cast<float>(yi) - cam[15]);
          bdx = cam[3] + s_x * cam[9] + s_y * cam[6];
          bdy = cam[4] + s_x * cam[10] + s_y * cam[7];
          bdz = cam[5] + s_x * cam[11] + s_y * cam[8];
        }
        p.ray = start_sample<kPcg>(hpix, samp0 + static_cast<uint32_t>(sk), state, bdx, bdy,
                                   bdz, cam, L.has_lens);
        p.cir = p.cig = p.cib = p.inten = 1.f;
        p.depth = 0;
      }
      active = alive || regen;
    } else {
      active = survive;
    }
  }

  if (i < L.n) {
    L.out[0 * L.n + i] = p.lr;
    L.out[1 * L.n + i] = p.lg;
    L.out[2 * L.n + i] = p.lb;
  }
}

// The body of the persistent mesh_trace kernels: blocks, as many as the
// SMs hold, whose warps take 32-lane tiles from the counter `work` (0 at
// launch) until the lanes run out, so no warp waits for the others of its
// block. The brute route's table is resident in dynamic shared memory (3
// float4 a row), loaded once a block; for kInst == kInstSlots it holds the
// groups' InstSlots and the lane stash. kSky: the cube map's face table is
// staged too.
template <bool kBrute, int kInst, bool kSky, bool kPcg>
__device__ __forceinline__ void trace_tiles_of_block(const Lanes& L,
                                                     const float* __restrict__ sph_g,
                                                     const float* __restrict__ ft_g,
                                                     const float* __restrict__ cam_g,
                                                     const Mesh& m, int* __restrict__ work,
                                                     const Sky& sky, const Inst& inst) {
  extern __shared__ float4 rows[];
  __shared__ float sph[kMaxPrims * kSphCols];
  __shared__ float ft[kMaxPrims * kFtCols];
  __shared__ float cam[kCamLen];
  __shared__ int s_face[kSky ? 6 * kFaceCols : 1];
  stage_scene(sph, sph_g, L.n_sph, ft, ft_g, L.n_ft, cam, cam_g);
  if (kBrute) {
    for (int k = threadIdx.x; k < m.n_brute * 3; k += blockDim.x) rows[k] = __ldg(m.btri + k);
  }
  if constexpr (kSky) stage_sky(s_face, sky.face);
  __syncthreads();  // the only barrier
  const int lane = static_cast<int>(threadIdx.x & 31);
  for (;;) {
    int tile = 0;
    if (lane == 0) tile = atomicAdd(work, 1);
    tile = __shfl_sync(kFull, tile, 0);
    if (tile >= (L.n + 31) / 32) break;
    trace_lane<kBrute, kInst, kSky, kPcg>(tile * 32 + lane, L, sph, ft, cam, m, rows, inst, sky,
                                          s_face);
  }
}

// mesh_trace (kBrute false) and mesh_trace_brute (true), and kInst, the
// instanced route (mesh_trace_instanced, the walk's launch shape); kSky:
// the sky entries; kPcg: the pcg generator's draws. `inst` is the last
// parameter, so the other instantiations keep their parameters' offsets.
template <bool kBrute, bool kInst, bool kSky, bool kPcg>
__global__ void __launch_bounds__(kBrute ? kBruteThreads : kThreads,
                                  kBrute ? 1 : kInst ? kInstBlocks : kTraceBlocks)
mesh_trace_kernel(const Lanes L, const float* __restrict__ sph_g, const float* __restrict__ ft_g,
                  const float* __restrict__ cam_g, const Mesh m, int* __restrict__ work,
                  const Sky sky, const Inst inst) {
  trace_tiles_of_block<kBrute, kInst ? kInstSlots : kNoInst, kSky, kPcg>(L, sph_g, ft_g, cam_g, m,
                                                                       work, sky, inst);
}

// The yardstick mesh_trace_instanced is timed against: the entry's first
// design, the group's instance state and the lane's path state in
// registers (group_instances), weyl without the sky. Nothing on a render
// path launches it.
__global__ void __launch_bounds__(kThreads, kInstFirstBlocks)
mesh_trace_instanced_first_kernel(const Lanes L, const float* __restrict__ sph_g,
                                  const float* __restrict__ ft_g, const float* __restrict__ cam_g,
                                  const Mesh m, int* __restrict__ work, const Sky sky,
                                  const Inst inst) {
  trace_tiles_of_block<false, kInstFirst, false, false>(L, sph_g, ft_g, cam_g, m, work, sky, inst);
}

// The yardsticks mesh_trace_kernel<false, false> and <true, false> are timed
// against: the first designs of the two entries (a thread per lane, its
// own walk in the camera's scan order, or the block in lockstep over
// staged 64-row chunks). Nothing on a render path launches them.
template <bool kBrute>
__global__ void __launch_bounds__(kThreads)
mesh_trace_yardstick_kernel(const Lanes L, const float* __restrict__ sph_g,
                            const float* __restrict__ ft_g, const float* __restrict__ cam_g,
                            const Mesh m) {
  __shared__ float sph[kMaxPrims * kSphCols];
  __shared__ float ft[kMaxPrims * kFtCols];
  __shared__ float cam[kCamLen];
  __shared__ float4 s_tri[kBrute ? kBruteChunk * 3 : 1];
  __shared__ int s_gid[kBrute ? kBruteChunk : 1];
  stage_scene(sph, sph_g, L.n_sph, ft, ft_g, L.n_ft, cam, cam_g);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // threads past n stay in the block's loop (the brute route stages with
  // every thread) but never trace
  bool active = i < L.n;
  const int xi = active ? L.xs[i] : 0, yi = active ? L.ys[i] : 0;
  const uint32_t hpix = jenkins(static_cast<uint32_t>(xi) ^ (static_cast<uint32_t>(yi) << 16));
  const float s_x = cam[12] * (static_cast<float>(xi) - cam[14]);
  const float s_y = cam[13] * (static_cast<float>(yi) - cam[15]);
  const float bdx = cam[3] + s_x * cam[9] + s_y * cam[6];
  const float bdy = cam[4] + s_x * cam[10] + s_y * cam[7];
  const float bdz = cam[5] + s_x * cam[11] + s_y * cam[8];
  const float max_thres = cam[17];
  const float inv_thres = 1.0f / max_thres;

  const uint32_t samp0 = active ? static_cast<uint32_t>(L.samp[i]) : 0u;
  uint32_t state;
  Path p;
  p.ray = start_sample(hpix, samp0, state, bdx, bdy, bdz, cam, L.has_lens);
  p.lr = p.lg = p.lb = 0.f;
  p.cir = p.cig = p.cib = p.inten = 1.f;
  p.depth = 0;
  int sk = 0;

  const int n_iter = L.max_bounces * L.spl;
  for (int it = 0; it < n_iter; ++it) {
    if (kBrute) {
      if (!__syncthreads_or(active)) break;
    } else if (!active) {
      break;
    }
    float t_best = kInf;
    int kind = 0, best = 0;
    if (active) closest_sph_ft(p.ray, sph, L.n_sph, ft, L.n_ft, t_best, kind, best);
    float tm = t_best, bu = 0.f, bv = 0.f;
    int mgid = -1;
    if (kBrute) {
      brute(m, p.ray, active, s_tri, s_gid, tm, mgid, bu, bv);
    } else {
      walk(m, p.ray, kEps, tm, mgid, bu, bv);
    }
    if (!active) continue;

    const float u0 = next_f32(state);
    const float u1 = next_f32(state);
    const float u2 = next_f32(state);
    const float u3 = next_f32(state);
    const float u4 = next_f32(state);
    const float u5 = next_f32(state);
    const float u6 = next_f32(state);
    const float u7 = next_f32(state);

    bool survive = false;
    if (mgid >= 0) {
      survive = shade_mesh(p, m, mgid, tm, bu, bv, u0, u1, u2, u4, u5, u6, u7, L.assured,
                           max_thres, inv_thres);
    } else if (kind != 0) {
      survive = shade_sph_ft(p, sph, ft, kind, best, t_best, u0, u1, u2, u3, u7, L.assured,
                             max_thres, inv_thres);
    }

    if (L.spl > 1) {
      const bool alive = survive && p.depth < L.max_bounces;
      const bool regen = !alive && sk + 1 < L.spl;
      if (regen) {
        ++sk;
        p.ray = start_sample(hpix, samp0 + static_cast<uint32_t>(sk), state, bdx, bdy, bdz, cam,
                             L.has_lens);
        p.cir = p.cig = p.cib = p.inten = 1.f;
        p.depth = 0;
      }
      active = alive || regen;
    } else {
      active = survive;
    }
  }

  if (i < L.n) {
    L.out[0 * L.n + i] = p.lr;
    L.out[1 * L.n + i] = p.lg;
    L.out[2 * L.n + i] = p.lb;
  }
}

enum TraceEntry {
  kEntryWalk,
  kEntryBrute,
  kEntryInstanced,
  kEntryPerThread,
  kEntryLockstep,
  kEntryInstancedFirst
};

// A CUDA error as the C interface's return code; the sticky "last error"
// is cleared so that it is not reported again by a later launch.
int fail(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

// One persistent launch of `kernel` (a mesh_trace_kernel instantiation or
// mesh_trace_instanced_first_kernel) with `threads` threads a block: as many
// blocks as the SMs hold with `smem` bytes of dynamic shared memory, at
// most one a 32-lane tile.
template <typename Kernel>
int launch_persistent(Kernel kernel, int threads, const Lanes& L, const float* sph,
                      const float* ft, const float* cam, const Mesh& m, int* work, size_t smem,
                      cudaStream_t s, const Sky& sky, const Inst& inst) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return fail(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return fail(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return fail(e);
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return fail(e);
  const int tiles = (L.n + 31) / 32, warps = threads / 32;
  const int resident = (per_sm > 1 ? per_sm : 1) * sms, needed = (tiles + warps - 1) / warps;
  kernel<<<resident < needed ? resident : needed, threads, smem, s>>>(L, sph, ft, cam, m, work, sky,
                                                                      inst);
  return static_cast<int>(cudaGetLastError());
}

// A route entry's instantiation: kBrute's or kInst's, with the sky when
// sky.face is set
template <bool kBrute, bool kInst, bool kPcg>
int launch_route(const Lanes& L, const float* sph, const float* ft, const float* cam,
                 const Mesh& m, int* work, size_t smem, cudaStream_t s, const Sky& sky,
                 const Inst& inst) {
  static_assert(!(kBrute && kInst), "the brute route and instancing exclude each other");
  constexpr int threads = kBrute ? kBruteThreads : kThreads;
  return sky.face != nullptr
             ? launch_persistent(mesh_trace_kernel<kBrute, kInst, true, kPcg>, threads, L, sph,
                                 ft, cam, m, work, smem, s, sky, inst)
             : launch_persistent(mesh_trace_kernel<kBrute, kInst, false, kPcg>, threads, L, sph,
                                 ft, cam, m, work, smem, s, sky, inst);
}

// sky.face nullptr: the entries without the cube map; else the route
// entries' sky instantiations; pcg: the route entries' pcg instantiations
// (the yardsticks take neither); inst: the instanced entries' tables
// (refused when missing)
int launch_trace(TraceEntry entry, const Lanes& L, const float* sph, const float* ft,
                 const float* cam, const Mesh& m, int* work, void* stream, const Sky& sky,
                 bool pcg, const Inst& inst) {
  if (L.n <= 0) return 0;
  const bool with_sky = sky.face != nullptr;
  const bool route = entry == kEntryWalk || entry == kEntryBrute || entry == kEntryInstanced;
  const bool instanced = entry == kEntryInstanced || entry == kEntryInstancedFirst;
  const Mesh& a = inst.asset;
  if (L.n_sph > kMaxPrims || L.n_ft > kMaxPrims || m.n_brute % kBruteChunk ||
      (work == nullptr && (route || instanced)) || (pcg && !route) ||
      (with_sky && (sky.pool == nullptr || sky.len < 1 || !route)) ||
      (instanced &&
       (inst.rows == nullptr || inst.n < 1 || a.sgbounds == nullptr || a.sbounds == nullptr ||
        a.bounds == nullptr || a.count == nullptr || a.tri == nullptr || a.gid == nullptr ||
        a.n_sg < 1 || a.width < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (L.n + kThreads - 1) / kThreads;
  const size_t brute_smem = static_cast<size_t>(m.n_brute) * 3 * sizeof(float4);
  const size_t inst_smem = kThreads / kTraceGroup * sizeof(InstSlot) +
                           static_cast<size_t>(kStashFields) * kThreads * sizeof(float);
  switch (entry) {
    case kEntryWalk:
      return pcg ? launch_route<false, false, true>(L, sph, ft, cam, m, work, 0, s, sky, inst)
                 : launch_route<false, false, false>(L, sph, ft, cam, m, work, 0, s, sky, inst);
    case kEntryBrute:
      return pcg ? launch_route<true, false, true>(L, sph, ft, cam, m, work, brute_smem, s, sky,
                                                   inst)
                 : launch_route<true, false, false>(L, sph, ft, cam, m, work, brute_smem, s, sky,
                                                    inst);
    case kEntryInstanced:
      return pcg ? launch_route<false, true, true>(L, sph, ft, cam, m, work, inst_smem, s, sky,
                                                   inst)
                 : launch_route<false, true, false>(L, sph, ft, cam, m, work, inst_smem, s, sky,
                                                    inst);
    case kEntryInstancedFirst:
      return launch_persistent(mesh_trace_instanced_first_kernel, kThreads, L, sph, ft, cam, m,
                               work, 0, s, sky, inst);
    case kEntryPerThread:
      mesh_trace_yardstick_kernel<false><<<blocks, kThreads, 0, s>>>(L, sph, ft, cam, m);
      break;
    case kEntryLockstep:
      mesh_trace_yardstick_kernel<true><<<blocks, kThreads, 0, s>>>(L, sph, ft, cam, m);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- mesh_hit: the integrator's nearest mesh hit, a group walk per ray ----

__global__ void __launch_bounds__(kThreads)
mesh_hit_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                const float* __restrict__ oz, const float* __restrict__ dx,
                const float* __restrict__ dy, const float* __restrict__ dz,
                const float* __restrict__ seed, int n, float t_min, const Mesh m,
                float* __restrict__ t_out, int* __restrict__ gid_out, float* __restrict__ u_out,
                float* __restrict__ v_out) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / kRayGroup;  // this group's ray
  if (i >= n) return;  // whole groups
  const Group<kRayGroup> g = lane_group<kRayGroup>();
  const float t_seed = seed[i];
  if (!(t_seed > t_min)) {  // dead: no t has t_min <= t < seed
    if (g.rank == 0) {
      t_out[i] = t_seed;
      gid_out[i] = -1;
      u_out[i] = 0.f;
      v_out[i] = 0.f;
    }
    return;
  }
  const Ray r{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
  float ct, cu, cv;
  int cpos;
  group_walk(m, g, r, t_seed, t_min, ct, cpos, cu, cv);
  if (g.rank == 0) {
    t_out[i] = ct;
    gid_out[i] = cpos >= 0 ? __ldg(m.gid + cpos) : -1;
    u_out[i] = cu;
    v_out[i] = cv;
  }
}

// The yardstick mesh_hit_kernel is timed against: one thread per ray runs
// the per-thread `walk` in the camera's scan order (the first design of
// this entry). Nothing on a render path launches it.
__global__ void __launch_bounds__(kThreads)
mesh_hit_per_thread_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                           const float* __restrict__ oz, const float* __restrict__ dx,
                           const float* __restrict__ dy, const float* __restrict__ dz,
                           const float* __restrict__ seed, int n, float t_min, const Mesh m,
                           float* __restrict__ t_out, int* __restrict__ gid_out,
                           float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
  float tt = seed[i], bu = 0.f, bv = 0.f;
  int gid = -1;
  walk(m, r, t_min, tt, gid, bu, bv);
  t_out[i] = tt;
  gid_out[i] = gid;
  u_out[i] = bu;
  v_out[i] = bv;
}

template <typename HitKernel>
int launch_hit(HitKernel kernel, int threads_per_ray, const float* ox, const float* oy,
               const float* oz, const float* dx, const float* dy, const float* dz,
               const float* seed, int n, float t_min, const float* sgbounds,
               const float* sbounds, const float* bounds, const int* count, const float* tri,
               const int* gid, int n_sg, int width, float* t_out, int* gid_out, float* u_out,
               float* v_out, void* stream) {
  if (n <= 0) return 0;
  const Mesh m{sgbounds, sbounds, bounds, count, reinterpret_cast<const float4*>(tri), gid,
               n_sg, width, nullptr, nullptr, 0, nullptr, nullptr, nullptr, 0, 0};
  const long long threads = static_cast<long long>(n) * threads_per_ray;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, seed, n, t_min, m, t_out, gid_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MESH_HIT_ARGS                                                                        \
  const float *ox, const float *oy, const float *oz, const float *dx, const float *dy,       \
      const float *dz, const float *seed, int n, float t_min, const float *sgbounds,         \
      const float *sbounds, const float *bounds, const int *count, const float *tri,         \
      const int *gid, int n_sg, int width, float *t_out, int *gid_out, float *u_out,         \
      float *v_out, void *stream
#define MESH_HIT_PASS                                                                        \
  ox, oy, oz, dx, dy, dz, seed, n, t_min, sgbounds, sbounds, bounds, count, tri, gid, n_sg,  \
      width, t_out, gid_out, u_out, v_out, stream

extern "C" int mesh_hit_launch(MESH_HIT_ARGS) {
  return launch_hit(mesh_hit_kernel, kRayGroup, MESH_HIT_PASS);
}

extern "C" int mesh_hit_per_thread_launch(MESH_HIT_ARGS) {
  return launch_hit(mesh_hit_per_thread_kernel, 1, MESH_HIT_PASS);
}

// The six mesh_trace entries share one C signature; `work` is a zeroed
// int32 the warps of the route entries and of mesh_trace_instanced_first
// take their tiles from (unused by the other yardsticks). The cube map's arguments are null (sky_face nullptr)
// without one: the (6, kFaceCols) int32 face table and the sky pool of
// sky_len elements in its dtype sky_kind; pcg != 0 asks for the pcg
// generator. The yardsticks take neither. The last ten are the instanced
// entries' (null and 0 for the others): the (n_inst, 24) f32 instance
// table and the asset's walk tables (l_*, the layout of the walk's).
#define MESH_TRACE_ARGS                                                                      \
  const int32_t *xs, const int32_t *ys, const int32_t *samp, int n, const float *sph,        \
      const float *ft, const float *cam, int n_sph, int n_ft, int has_lens, int assured,     \
      int max_bounces, int spl, const float *sgbounds, const float *sbounds,                 \
      const float *bounds, const int *count, const float *tri, const int *gid, int n_sg,     \
      int width, const float *btri, const int *bgid, int n_brute, const float *attr,         \
      const int *desc, const void *pool, int pool_kind, long long pool_len, float *out,      \
      int *work, void *stream, const int *sky_face, const void *sky_pool, int sky_kind,      \
      long long sky_len, int pcg, const float *inst, int n_inst, const float *l_sgbounds,    \
      const float *l_sbounds, const float *l_bounds, const int *l_count, const float *l_tri, \
      const int *l_gid, int l_n_sg, int l_width
#define MESH_TRACE_PASS(entry)                                                               \
  launch_trace(entry, Lanes{xs, ys, samp, n, n_sph, n_ft, has_lens, assured, max_bounces,    \
                            spl, out},                                                       \
               sph, ft, cam,                                                                 \
               Mesh{sgbounds, sbounds, bounds, count, reinterpret_cast<const float4*>(tri),  \
                    gid, n_sg, width, reinterpret_cast<const float4*>(btri), bgid, n_brute,  \
                    attr, desc, pool, pool_kind, pool_len},                                  \
               work, stream, Sky{sky_face, sky_pool, sky_kind, sky_len}, pcg != 0,          \
               Inst{reinterpret_cast<const float4*>(inst), n_inst,                           \
                    Mesh{l_sgbounds, l_sbounds, l_bounds, l_count,                           \
                         reinterpret_cast<const float4*>(l_tri), l_gid, l_n_sg, l_width,     \
                         nullptr, nullptr, 0, nullptr, nullptr, nullptr, 0, 0}})

extern "C" int mesh_trace_launch(MESH_TRACE_ARGS) { return MESH_TRACE_PASS(kEntryWalk); }

extern "C" int mesh_trace_brute_launch(MESH_TRACE_ARGS) { return MESH_TRACE_PASS(kEntryBrute); }

extern "C" int mesh_trace_instanced_launch(MESH_TRACE_ARGS) {
  return MESH_TRACE_PASS(kEntryInstanced);
}

extern "C" int mesh_trace_instanced_first_launch(MESH_TRACE_ARGS) {
  return MESH_TRACE_PASS(kEntryInstancedFirst);
}

extern "C" int mesh_trace_per_thread_launch(MESH_TRACE_ARGS) {
  return MESH_TRACE_PASS(kEntryPerThread);
}

extern "C" int mesh_trace_brute_lockstep_launch(MESH_TRACE_ARGS) {
  return MESH_TRACE_PASS(kEntryLockstep);
}
