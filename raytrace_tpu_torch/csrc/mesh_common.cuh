// Device code of a mesh hit's shading, shared by the mesh kernels
// (mesh_kernel.cu) and the bounce kernels (bounce_kernel.cu): the
// sqrt-then-divide normalize and the nearest texel fetch of a descriptor;
// and the bounce kernels' shading attributes of a mesh triangle
// (mesh_kernel.cu's shade_mesh keeps the same code inline, where moving
// it here changed one instantiation's SASS; ops/mesh_kernel.mesh_attrs,
// the JAX integrator's mesh_attrs_dense, :546-630): the shading normal
// (normal-mapped: the raw [0, 1] texel taken as the tangent-space vector,
// no 2x-1 remap), the base colour times its texel, metal from the blue
// texel channel and rough from the green. Both files build with
// -fmad=false, where each multiply and add is rounded as torch rounds it,
// and equal their plain versions bitwise.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "cubemap.cuh"

namespace rt {

constexpr int kAttrCols = 48;  // mt_attr's row
constexpr int kDescCols = 9;   // mt_desc's row: [offset, width, height] x 3 textures

// sqrt-then-divide normalize (the JAX package's ops/vec.normalize;
// ops/raygen.normalize): n = sqrt(max(|v|^2, 1e-30)), clamped to eps
// when eps > 0, then v * (1 / n)
__device__ __forceinline__ void vnorm(float& x, float& y, float& z, float eps) {
  const float n2 = x * x + y * y + z * z;
  float n = sqrtf(n2 > 1e-30f ? n2 : 1e-30f);
  if (eps > 0.f) n = fmaxf(n, eps);
  const float inv = 1.f / n;
  x *= inv;
  y *= inv;
  z *= inv;
}

// A mesh's shading tables: attr (M, 48) f32, the int32 descriptors (M,
// 9) and the texel pool in its dtype (kind, `len` elements).
struct MeshShade {
  const float* attr;
  const int* desc;
  const void* pool;
  int pool_kind;
  long long pool_len;
};

// nearest fetch of descriptor d = [offset, width, height] (uv_image.rs:10-23):
// false (and black) when the width is 0
__device__ __forceinline__ bool fetch(const MeshShade& m, const int* d, float u, float v,
                                      float3& rgb) {
  const int off = __ldg(d), wid = __ldg(d + 1), hei = __ldg(d + 2);
  if (wid <= 0) {
    rgb = make_float3(0.f, 0.f, 0.f);
    return false;
  }
  const float wf = static_cast<float>(wid), hf = static_cast<float>(hei);
  const int px = static_cast<int>(fminf(fmaxf(u * wf, 0.f), fmaxf(wf - 1.f, 0.f)));
  const int py = static_cast<int>(fminf(fmaxf(v * hf, 0.f), fmaxf(hf - 1.f, 0.f)));
  rgb = pool_texel(m.pool, m.pool_kind, m.pool_len, off + 3 * (px + py * wid));
  return true;
}

struct MeshAttrs {
  float nx, ny, nz;  // shading normal
  float r, g, b;     // colour
  float metal, rough;
};

// The shading attributes of triangle gid at barycentrics (bu, bv).
__device__ __forceinline__ MeshAttrs mesh_attrs(const MeshShade& m, int gid, float bu, float bv) {
  const float* a = m.attr + static_cast<size_t>(gid) * kAttrCols;
  const int* d = m.desc + static_cast<size_t>(gid) * kDescCols;
  const float b0 = 1.f - bu - bv;
  auto interp = [&](int c, float& uu, float& vv) {
    uu = b0 * __ldg(a + c) + bu * __ldg(a + c + 2) + bv * __ldg(a + c + 4);
    vv = b0 * __ldg(a + c + 1) + bu * __ldg(a + c + 3) + bv * __ldg(a + c + 5);
  };
  MeshAttrs at;
  float uu, vv;
  float3 tx;
  at.nx = __ldg(a);
  at.ny = __ldg(a + 1);
  at.nz = __ldg(a + 2);
  if (__ldg(a + 18) > 0.5f) {  // normal map: the raw texel, no 2x-1 remap
    interp(25, uu, vv);
    fetch(m, d + 3, uu, vv, tx);
    const float s = __ldg(a + 12);
    at.nx = (__ldg(a + 3) * tx.x + __ldg(a + 4) * tx.y + __ldg(a + 5) * tx.z) * s;
    at.ny = (__ldg(a + 6) * tx.x + __ldg(a + 7) * tx.y + __ldg(a + 8) * tx.z) * s;
    at.nz = (__ldg(a + 9) * tx.x + __ldg(a + 10) * tx.y + __ldg(a + 11) * tx.z) * s;
    vnorm(at.nx, at.ny, at.nz, 1e-20f);
  }
  at.r = __ldg(a + 13);
  at.g = __ldg(a + 14);
  at.b = __ldg(a + 15);
  interp(19, uu, vv);
  if (fetch(m, d, uu, vv, tx)) {
    at.r *= tx.x;
    at.g *= tx.y;
    at.b *= tx.z;
  }
  at.metal = __ldg(a + 16);
  at.rough = __ldg(a + 17);
  interp(31, uu, vv);
  if (fetch(m, d + 6, uu, vv, tx)) {  // metal scales blue, rough green
    at.metal *= tx.z;
    at.rough *= tx.y;
  }
  return at;
}

}  // namespace rt
