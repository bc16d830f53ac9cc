// Device code shared by the path-tracing kernels (trace_kernel.cu,
// mesh_kernel.cu): the counter RNG, camera raygen, the brute-force
// closest hit over the packed sphere / free-triangle tables and the
// shading of such a hit (uniform-material BSDF, gpu radiance update,
// Russian roulette). Each follows the JAX package's fused kernels
// (raytrace_tpu/ops/pallas/trace_kernel.py) and the port's plain torch
// versions (ops/rng.py, ops/raygen.py, ops/intersect.py, ops/bsdf.py);
// only float rounding (FMA contraction, sinf/cosf, rsqrtf) may differ.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr int kSphCols = 15;
constexpr int kFtCols = 23;
constexpr int kCamLen = 18;
constexpr int kMaxPrims = 64;
constexpr float kEps = 1e-4f;
constexpr float kInf = 3.4e38f;       // sentinel, not inf (trace_kernel.py:41)
constexpr float kTwoPi = 6.28318548f;  // float32(2 pi)
constexpr float kInv24 = 0x1.000002p-24f;  // float32(1 / 16777215)

// sphere columns: c xyz 0-2, r 3, rgb 4-6, em 7-9, has_em 10, kind 11,
// diffp 12, n_out 13, n_in 14
// free-triangle columns: v0 0-2, e1 3-5, e2 6-8, n 9-11, rgb 12-14,
// em 15-17, has_em 18, kind 19, diffp 20, n_out 21, n_in 22

__device__ __forceinline__ uint32_t jenkins(uint32_t x) {
  x += x << 10;
  x ^= x >> 6;
  x += x << 3;
  x ^= x >> 11;
  x += x << 15;
  return x;
}

// one uniform in [0, 1]: ops/rng.py next_f32 with the default `weyl`
// generator (Weyl increment + lowbias32 finalizer), bit-equal
__device__ __forceinline__ float next_f32(uint32_t& s) {
  s += 0x9E3779B9u;
  uint32_t w = s ^ (s >> 16);
  w *= 0x21F0AAADu;
  w ^= w >> 15;
  w *= 0x735A2D97u;
  w ^= w >> 15;
  return static_cast<float>(static_cast<int>(w >> 8)) * kInv24;
}

// x * rsqrt(max(|x|^2, 1e-30)): raygen's and the sphere normal's normalize
__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
  float n2 = x * x + y * y + z * z;
  float inv = rsqrtf(n2 > 1e-30f ? n2 : 1e-30f);
  x *= inv;
  y *= inv;
  z *= inv;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// rng seed + lens + jitter for sample id `sid` (ops/raygen.py start)
__device__ __forceinline__ Ray start_sample(uint32_t hpix, uint32_t sid, uint32_t& state,
                                            float bdx, float bdy, float bdz,
                                            const float* cam, int has_lens) {
  state = jenkins(hpix ^ jenkins(sid ^ 0x9E3779B9u));
  Ray r;
  r.dx = bdx;
  r.dy = bdy;
  r.dz = bdz;
  const float ux = cam[6], uy = cam[7], uz = cam[8];
  const float rx = cam[9], ry = cam[10], rz = cam[11];
  if (has_lens) {
    float u = next_f32(state);
    float v = next_f32(state);
    float rr = sqrtf(u);
    float th = kTwoPi * v;
    float lx = (rr - 0.5f) * 2.0f * cam[16] * cosf(th);
    float ly = (rr - 0.5f) * 2.0f * cam[16] * sinf(th);
    float offx = rx * lx + ux * ly, offy = ry * lx + uy * ly, offz = rz * lx + uz * ly;
    r.ox = offx + cam[0];
    r.oy = offy + cam[1];
    r.oz = offz + cam[2];
    r.dx -= offx;
    r.dy -= offy;
    r.dz -= offz;
  } else {
    r.ox = cam[0];
    r.oy = cam[1];
    r.oz = cam[2];
  }
  float ju = next_f32(state);
  float jv = next_f32(state);
  float jx = (ju - 0.5f) * cam[12], jy = (jv - 0.5f) * cam[13];
  r.dx = r.dx + rx * jx + ux * jy;
  r.dy = r.dy + ry * jx + uy * jy;
  r.dz = r.dz + rz * jx + uz * jy;
  norm3(r.dx, r.dy, r.dz);
  return r;
}

// The radiance state of one path.
struct Path {
  Ray ray;
  float cir, cig, cib, inten;  // throughput colour and dielectric weight
  float lr, lg, lb;            // radiance sum
  int depth;
};

// Moller-Trumbore against (v0, e1, e2) with the |det| >= EPS and t >= EPS
// guards (the JAX integrator's _triangle_t); true on a hit.
__device__ __forceinline__ bool tri_hit(const Ray& r, float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        float& t, float& u, float& w) {
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  if (!(fabsf(det) >= kEps)) return false;
  const float inv_det = 1.0f / det;
  const float hx = r.ox - v0x, hy = r.oy - v0y, hz = r.oz - v0z;
  u = inv_det * (hx * pvx + hy * pvy + hz * pvz);
  const float qx = hy * e1z - hz * e1y;
  const float qy = hz * e1x - hx * e1z;
  const float qz = hx * e1y - hy * e1x;
  w = inv_det * (r.dx * qx + r.dy * qy + r.dz * qz);
  t = inv_det * (e2x * qx + e2y * qy + e2z * qz);
  return u >= 0.f && u <= 1.f && w >= 0.f && u + w <= 1.f && t >= kEps;
}

// Closest hit: running strict-< over spheres, then free triangles, in
// packed row order. kind 0 none / 1 sphere / 2 free triangle; best = row.
__device__ __forceinline__ void closest_sph_ft(const Ray& ray, const float* sph, int n_sph,
                                               const float* ft, int n_ft, float& t_best,
                                               int& kind, int& best) {
  t_best = kInf;
  kind = 0;
  best = 0;
  for (int s = 0; s < n_sph; ++s) {
    const float* r = sph + s * kSphCols;
    float ocx = ray.ox - r[0], ocy = ray.oy - r[1], ocz = ray.oz - r[2];
    float dirv = ray.dx * ocx + ray.dy * ocy + ray.dz * ocz;
    float consts = ocx * ocx + ocy * ocy + ocz * ocz - r[3] * r[3];
    float disc = dirv * dirv - consts;
    if (disc > 0.f) {
      float t_near = -dirv - sqrtf(disc);
      if (t_near > 0.f && t_near < t_best) {
        t_best = t_near;
        kind = 1;
        best = s;
      }
    }
  }
  for (int f = 0; f < n_ft; ++f) {
    const float* r = ft + f * kFtCols;
    float t, u, w;
    if (tri_hit(ray, r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], t, u, w) &&
        t < t_best) {
      t_best = t;
      kind = 2;
      best = f;
    }
  }
}

// Shade a sphere / free-triangle hit (kind 1 / 2, row `best`, at t_best):
// emissive add and the colour twice (quirk), throughput *= colour, RR
// with u7 (termination ADDS throughput / max_thres, quirk), else the
// BSDF lobe of the hit's material with u0..u3 and the next ray. Returns
// whether the path survives.
__device__ __forceinline__ bool shade_sph_ft(Path& p, const float* sph, const float* ft,
                                             int kind, int best, float t_best, float u0,
                                             float u1, float u2, float u3, float u7,
                                             int assured, float max_thres, float inv_thres) {
  const float* row = kind == 1 ? sph + best * kSphCols : ft + best * kFtCols;
  const int a = kind == 1 ? 4 : 12;  // rgb column; em, has_em, kind, diffp, n follow
  const float rgb_r = row[a], rgb_g = row[a + 1], rgb_b = row[a + 2];
  const float px = p.ray.ox + p.ray.dx * t_best;
  const float py = p.ray.oy + p.ray.dy * t_best;
  const float pz = p.ray.oz + p.ray.dz * t_best;
  float nx, ny, nz;
  if (kind == 1) {
    nx = px - row[0];
    ny = py - row[1];
    nz = pz - row[2];
    norm3(nx, ny, nz);
  } else {
    nx = row[9];
    ny = row[10];
    nz = row[11];
  }

  if (row[a + 6] > 0.5f) {  // emissive: add, then the colour twice (quirk)
    p.lr += row[a + 3] * (p.cir * p.inten);
    p.lg += row[a + 4] * (p.cig * p.inten);
    p.lb += row[a + 5] * (p.cib * p.inten);
    p.cir *= rgb_r;
    p.cig *= rgb_g;
    p.cib *= rgb_b;
  }
  p.cir *= rgb_r;
  p.cig *= rgb_g;
  p.cib *= rgb_b;

  if (p.depth >= assured && u7 > max_thres) {  // RR termination ADDS throughput (quirk)
    p.lr += p.cir * inv_thres * p.inten;
    p.lg += p.cig * inv_thres * p.inten;
    p.lb += p.cib * inv_thres * p.inten;
    p.cir *= inv_thres;
    p.cig *= inv_thres;
    p.cib *= inv_thres;
    return false;
  }
  // ---- BSDF: only the lobe of this material ----
  const float mkind = row[a + 7];
  const float dx = p.ray.dx, dy = p.ray.dy, dz = p.ray.dz;
  const float dn = dx * nx + dy * ny + dz * nz;
  float ndx, ndy, ndz, weight = 1.f;
  if (mkind == 3.f) {
    // gpu-mode dielectric (trace.wgsl:570-576 quirks kept)
    const float n_out = row[a + 9], n_in = row[a + 10];
    const bool into = dn < 0.f;
    const float n1 = into ? n_out : n_in;
    const float n2 = into ? n_in : n_out;
    const float c1 = fabsf(dn);
    const float nrx = into ? nx : -nx, nry = into ? ny : -ny, nrz = into ? nz : -nz;
    const float n_over = n1 / n2;
    const float c22 = 1.f - n_over * n_over * (1.f - c1 * c1);
    const bool tir = c22 < 0.f;
    float tx = dx, ty = dy, tz = dz;
    if (!tir) {
      const float k_t = n_over * c1 - sqrtf(c22 > 0.f ? c22 : 1.f);
      tx = dx * n_over + nrx * k_t;
      ty = dy * n_over + nry * k_t;
      tz = dz * n_over + nrz * k_t;
    }
    float r0 = (n1 - n2) / (n1 + n2);
    r0 = r0 * r0;
    const float ct = 1.f - (tx * nx + ty * ny + tz * nz);
    const float ct2 = ct * ct;
    const float re = r0 + (1.f + r0) * (ct2 * ct2 * ct);
    if (tir || u3 < re) {
      const float dnr = dx * nrx + dy * nry + dz * nrz;
      ndx = dx - nrx * (2.f * dnr);
      ndy = dy - nry * (2.f * dnr);
      ndz = dz - nrz * (2.f * dnr);
    } else {
      ndx = tx;
      ndy = ty;
      ndz = tz;
      weight = 1.f - re;
    }
  } else if (mkind == 1.f || (mkind == 2.f && u0 < row[a + 8])) {
    // cosine-weighted diffuse in the frame (xd, n x xd, n)
    float xdx = dx - nx * dn, xdy = dy - ny * dn, xdz = dz - nz * dn;
    norm3(xdx, xdy, xdz);
    const float ydx = ny * xdz - nz * xdy;
    const float ydy = nz * xdx - nx * xdz;
    const float ydz = nx * xdy - ny * xdx;
    const float r_ = sqrtf(u1);
    const float th = kTwoPi * u2;
    const float ca = r_ * cosf(th), sa = r_ * sinf(th);
    const float zz = sqrtf(fmaxf(1.f - u1, 0.f));
    ndx = xdx * ca + ydx * sa + nx * zz;
    ndy = xdy * ca + ydy * sa + ny * zz;
    ndz = xdz * ca + ydz * sa + nz * zz;
  } else {
    // mirror (not renormalized: d and n are unit)
    ndx = dx - nx * (2.f * dn);
    ndy = dy - ny * (2.f * dn);
    ndz = dz - nz * (2.f * dn);
  }
  p.inten *= weight;
  p.ray.ox = px + nx * kEps;
  p.ray.oy = py + ny * kEps;
  p.ray.oz = pz + nz * kEps;
  p.ray.dx = ndx;
  p.ray.dy = ndy;
  p.ray.dz = ndz;
  p.depth += 1;
  return true;
}

}  // namespace rt
