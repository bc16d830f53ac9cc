// Path-tracing kernel for mesh scenes (Hopper, sm_90a): two entry points.
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
// The two mesh nearest-hit routes:
//   mesh_trace        per-thread 3-level slab walk (supergroup of 8
//                     superclusters of 16 clusters of W triangles) over the
//                     camera-ordered tables of ops/mesh_kernel.
//                     pack_mesh_tables, each level pruned by its slab test
//                     `entry <= exit && exit >= 0 && entry < t_best`, the
//                     triangles of a reached cluster tested in row order
//                     with strict-< updates. Tables stay in global memory,
//                     read through the read-only path (__ldg); a triangle
//                     is three float4 loads and its id an int32.
//   mesh_trace_brute  meshes of <= 2,560 triangles (the JAX gate,
//                     woop.MAX_TRIS): the block stages 64-triangle chunks
//                     of the brute table in shared memory and every active
//                     thread runs f32 Moller-Trumbore against each chunk,
//                     the function the MXU pass computes, not its bf16
//                     split. The block's threads keep one bounce loop in
//                     step (__syncthreads_or) so all take part in staging.
//
// What bounds it on an H100: the walk is latency-bound on dependent,
// data-dependent global loads (the slab tests of reached nodes, then 48 B
// per tested triangle) and on warp divergence, as lanes of a warp reach
// different clusters; the brute route is FP32-ALU bound (every lane tests
// every triangle from broadcast shared-memory reads). This first version
// keeps each lane's own walk and ordering for exactness with the plain
// torch version; ray sorting, wide BVH nodes and tensor-core tests are
// later work.
//
// The draws, the two normalizes (raygen rsqrt, mesh shade sqrt-then-
// divide with eps 1e-20) and every reference quirk (the raw [0, 1]
// normal-map texel, metal from blue and rough from green, the nearest
// fetch trunc(clip(u * w, 0, w - 1)) without a v flip, zero mesh
// emissive, divert weight 1) follow the JAX package; only float rounding
// (FMA contraction, sinf/cosf, rsqrtf) may differ.
//
// Built by raytrace_tpu_torch/kernels/build.py (nvcc -arch sm_90a, no
// --use_fast_math); called through ctypes from ops/mesh_kernel.py.

#include "path_common.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 256;
constexpr int kGroup = 16;   // clusters per supercluster
constexpr int kSGroup = 8;   // superclusters per supergroup
constexpr int kBruteChunk = 64;
constexpr int kAttrCols = 48;
constexpr int kPoolU16 = 1, kPoolU32 = 2;  // else f32 (ops/texture.py)

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

__device__ __forceinline__ float slab_dir(float d) {
  return fabsf(d) < kEps ? (d < 0.f ? -kEps : kEps) : d;
}

// slab test of one [lo xyz, hi xyz, 0, 0] box (mesh_bounce_kernel.py:380-396)
__device__ __forceinline__ bool reach(const float* box, const Ray& r, float fx, float fy,
                                      float fz, float tt) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(box));
  const float4 b = __ldg(reinterpret_cast<const float4*>(box) + 1);
  const float t0x = (a.x - r.ox) * fx, t1x = (a.w - r.ox) * fx;
  const float t0y = (a.y - r.oy) * fy, t1y = (b.x - r.oy) * fy;
  const float t0z = (a.z - r.oz) * fz, t1z = (b.y - r.oz) * fz;
  const float entry = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float exit_ = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
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

// the 3-level cluster walk of one lane; tt in: the sphere / free-triangle best
__device__ void walk(const Mesh& m, const Ray& r, float& tt, int& gid, float& bu, float& bv) {
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
          if (tri_hit(r, a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, cc.x, t, u, v) && t < tt) {
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

// every triangle of the brute table, staged chunk by chunk; ALL threads
// of the block call it (inactive ones only help staging)
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

// sqrt-then-divide normalize (the JAX package's ops/vec.normalize)
__device__ __forceinline__ void vnorm(float& x, float& y, float& z, float eps) {
  const float n2 = x * x + y * y + z * z;
  float n = sqrtf(n2 > 1e-30f ? n2 : 1e-30f);
  if (eps > 0.f) n = fmaxf(n, eps);
  const float inv = 1.f / n;
  x *= inv;
  y *= inv;
  z *= inv;
}

// the three components at flat offset base3, converted after the gather
__device__ __forceinline__ float3 texel(const Mesh& m, int base3) {
  if (m.pool_kind == kPoolU32) {
    long long k = base3 / 3;
    k = k < 0 ? 0 : (k > m.pool_len - 1 ? m.pool_len - 1 : k);
    const uint32_t w = __ldg(static_cast<const uint32_t*>(m.pool) + k);
    return make_float3(static_cast<float>(w & 0xFFu) / 255.f,
                       static_cast<float>((w >> 8) & 0xFFu) / 255.f,
                       static_cast<float>((w >> 16) & 0xFFu) / 255.f);
  }
  long long k = base3;
  k = k < 0 ? 0 : (k > m.pool_len - 3 ? m.pool_len - 3 : k);
  if (m.pool_kind == kPoolU16) {
    const uint16_t* p = static_cast<const uint16_t*>(m.pool) + k;
    return make_float3(static_cast<float>(__ldg(p)) / 65535.f,
                       static_cast<float>(__ldg(p + 1)) / 65535.f,
                       static_cast<float>(__ldg(p + 2)) / 65535.f);
  }
  const float* p = static_cast<const float*>(m.pool) + k;
  return make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

// nearest fetch of descriptor d = [offset, width, height] (uv_image.rs:10-23):
// false (and black) when the width is 0
__device__ __forceinline__ bool fetch(const Mesh& m, const int* d, float u, float v,
                                      float3& rgb) {
  const int off = __ldg(d), wid = __ldg(d + 1), hei = __ldg(d + 2);
  if (wid <= 0) {
    rgb = make_float3(0.f, 0.f, 0.f);
    return false;
  }
  const float wf = static_cast<float>(wid), hf = static_cast<float>(hei);
  const int px = static_cast<int>(fminf(fmaxf(u * wf, 0.f), fmaxf(wf - 1.f, 0.f)));
  const int py = static_cast<int>(fminf(fmaxf(v * hf, 0.f), fmaxf(hf - 1.f, 0.f)));
  rgb = texel(m, off + 3 * (px + py * wid));
  return true;
}

// Shade a mesh hit (integrator.mesh_attrs_dense + fused_mesh._mesh_shade):
// attributes and texels, PBR divert, throughput, RR. Returns survival.
__device__ bool shade_mesh(Path& p, const Mesh& m, int gid, float t, float bu, float bv,
                           float u0, float u1, float u2, float u4, float u5, float u6,
                           float u7, int assured, float max_thres, float inv_thres) {
  const float* a = m.attr + static_cast<size_t>(gid) * kAttrCols;
  const int* d = m.desc + static_cast<size_t>(gid) * 9;
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

template <bool kBrute>
__global__ void __launch_bounds__(kThreads)
mesh_trace_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
                  const int32_t* __restrict__ samp, int n,
                  const float* __restrict__ sph_g, const float* __restrict__ ft_g,
                  const float* __restrict__ cam_g, int n_sph, int n_ft, int has_lens,
                  int assured, int max_bounces, int spl, const Mesh m,
                  float* __restrict__ out) {
  __shared__ float sph[kMaxPrims * kSphCols];
  __shared__ float ft[kMaxPrims * kFtCols];
  __shared__ float cam[kCamLen];
  __shared__ float4 s_tri[kBrute ? kBruteChunk * 3 : 1];
  __shared__ int s_gid[kBrute ? kBruteChunk : 1];
  for (int k = threadIdx.x; k < n_sph * kSphCols; k += blockDim.x) sph[k] = sph_g[k];
  for (int k = threadIdx.x; k < n_ft * kFtCols; k += blockDim.x) ft[k] = ft_g[k];
  for (int k = threadIdx.x; k < kCamLen; k += blockDim.x) cam[k] = cam_g[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // threads past n stay in the block's loop (the brute route stages with
  // every thread) but never trace
  bool active = i < n;
  const int xi = active ? xs[i] : 0, yi = active ? ys[i] : 0;
  const uint32_t hpix = jenkins(static_cast<uint32_t>(xi) ^ (static_cast<uint32_t>(yi) << 16));
  const float s_x = cam[12] * (static_cast<float>(xi) - cam[14]);
  const float s_y = cam[13] * (static_cast<float>(yi) - cam[15]);
  const float bdx = cam[3] + s_x * cam[9] + s_y * cam[6];
  const float bdy = cam[4] + s_x * cam[10] + s_y * cam[7];
  const float bdz = cam[5] + s_x * cam[11] + s_y * cam[8];
  const float max_thres = cam[17];
  const float inv_thres = 1.0f / max_thres;

  const uint32_t samp0 = active ? static_cast<uint32_t>(samp[i]) : 0u;
  uint32_t state;
  Path p;
  p.ray = start_sample(hpix, samp0, state, bdx, bdy, bdz, cam, has_lens);
  p.lr = p.lg = p.lb = 0.f;
  p.cir = p.cig = p.cib = p.inten = 1.f;
  p.depth = 0;
  int sk = 0;

  const int n_iter = max_bounces * spl;  // never cuts a lane short (trace_kernel.cu)
  for (int it = 0; it < n_iter; ++it) {
    if (kBrute) {
      if (!__syncthreads_or(active)) break;
    } else if (!active) {
      break;
    }
    float t_best = kInf;
    int kind = 0, best = 0;
    if (active) closest_sph_ft(p.ray, sph, n_sph, ft, n_ft, t_best, kind, best);
    float tm = t_best, bu = 0.f, bv = 0.f;
    int mgid = -1;
    if (kBrute) {
      brute(m, p.ray, active, s_tri, s_gid, tm, mgid, bu, bv);
    } else {
      walk(m, p.ray, tm, mgid, bu, bv);
    }
    if (!active) continue;

    // ---- the 8 draws of every bounce of a mesh scene ----
    const float u0 = next_f32(state);
    const float u1 = next_f32(state);
    const float u2 = next_f32(state);
    const float u3 = next_f32(state);  // drawn, used by sphere / free-triangle hits only
    const float u4 = next_f32(state);
    const float u5 = next_f32(state);
    const float u6 = next_f32(state);
    const float u7 = next_f32(state);

    bool survive = false;
    if (mgid >= 0) {
      survive = shade_mesh(p, m, mgid, tm, bu, bv, u0, u1, u2, u4, u5, u6, u7, assured,
                           max_thres, inv_thres);
    } else if (kind != 0) {
      survive = shade_sph_ft(p, sph, ft, kind, best, t_best, u0, u1, u2, u3, u7, assured,
                             max_thres, inv_thres);
    }

    if (spl > 1) {
      const bool alive = survive && p.depth < max_bounces;
      const bool regen = !alive && sk + 1 < spl;
      if (regen) {
        ++sk;
        p.ray = start_sample(hpix, samp0 + static_cast<uint32_t>(sk), state, bdx, bdy, bdz, cam,
                             has_lens);
        p.cir = p.cig = p.cib = p.inten = 1.f;
        p.depth = 0;
      }
      active = alive || regen;
    } else {
      active = survive;
    }
  }

  if (i < n) {
    out[0 * n + i] = p.lr;
    out[1 * n + i] = p.lg;
    out[2 * n + i] = p.lb;
  }
}

template <bool kBrute>
int launch(const int32_t* xs, const int32_t* ys, const int32_t* samp, int n, const float* sph,
           const float* ft, const float* cam, int n_sph, int n_ft, int has_lens, int assured,
           int max_bounces, int spl, const float* sgbounds, const float* sbounds,
           const float* bounds, const int* count, const float* tri, const int* gid, int n_sg,
           int width, const float* btri, const int* bgid, int n_brute, const float* attr,
           const int* desc, const void* pool, int pool_kind, long long pool_len, float* out,
           void* stream) {
  if (n <= 0) return 0;
  if (n_sph > kMaxPrims || n_ft > kMaxPrims || n_brute % kBruteChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mesh m{sgbounds, sbounds, bounds, count, reinterpret_cast<const float4*>(tri), gid,
               n_sg, width, reinterpret_cast<const float4*>(btri), bgid, n_brute, attr, desc,
               pool, pool_kind, pool_len};
  const int blocks = (n + kThreads - 1) / kThreads;
  mesh_trace_kernel<kBrute><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xs, ys, samp, n, sph, ft, cam, n_sph, n_ft, has_lens, assured, max_bounces, spl, m, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MESH_TRACE_ARGS                                                                      \
  const int32_t *xs, const int32_t *ys, const int32_t *samp, int n, const float *sph,        \
      const float *ft, const float *cam, int n_sph, int n_ft, int has_lens, int assured,     \
      int max_bounces, int spl, const float *sgbounds, const float *sbounds,                 \
      const float *bounds, const int *count, const float *tri, const int *gid, int n_sg,     \
      int width, const float *btri, const int *bgid, int n_brute, const float *attr,         \
      const int *desc, const void *pool, int pool_kind, long long pool_len, float *out,      \
      void *stream
#define MESH_TRACE_PASS                                                                      \
  xs, ys, samp, n, sph, ft, cam, n_sph, n_ft, has_lens, assured, max_bounces, spl, sgbounds, \
      sbounds, bounds, count, tri, gid, n_sg, width, btri, bgid, n_brute, attr, desc, pool,  \
      pool_kind, pool_len, out, stream

extern "C" int mesh_trace_launch(MESH_TRACE_ARGS) { return launch<false>(MESH_TRACE_PASS); }

extern "C" int mesh_trace_brute_launch(MESH_TRACE_ARGS) { return launch<true>(MESH_TRACE_PASS); }
