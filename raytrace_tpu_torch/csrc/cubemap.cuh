// The distant cube map inside the kernels (trace_kernel.cu, mesh_kernel.cu):
// the sky texel a ray that leaves the scene adds, and the pool fetch both
// the sky and the mesh textures use.
//
// sky_rgb is ops/cubemap.py `sample` (the JAX package's ops/cubemap.sample
// and integrator.sample_cubemap) bit for bit: the direction normalized by
// a square root and a multiply by 1 / n, the face of the dominant |axis|
// with the WGSL's >= ties (x beats y beats z), uv = 0.5 (minor us / major)
// + 0.5, texel trunc(clip(uv size, 0, size - 1)), black where the face's
// width is 0. Every operation that picks the face or the texel is an
// intrinsic rounded on its own (__fmul_rn, __fdiv_rn, __fadd_rn,
// __fsqrt_rn), as torch rounds it: trace_kernel.cu builds with FMA
// contraction, and a contracted 0.5 (u us / fact) + 0.5 or sum of squares
// would move texel boundaries. Kept out of path_common.cuh, whose code the
// no-sky kernels compile unchanged.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr int kPoolU16 = 1, kPoolU32 = 2;  // else f32 (ops/texture.py)
constexpr int kFaceCols = 5;  // offset, width, height, u_scale bits, v_scale bits (cubemap.face_table)

// The cube map as a launch gets it: the (6, kFaceCols) face table and the
// sky pool, in its dtype, of `len` elements (texels for kPoolU32).
struct Sky {
  const int* face;
  const void* pool;
  int kind;
  long long len;
};

// The three components of the texel whose R component is at flat offset
// base3 of a pool (ops/texture.fetch_rgb), converted after the load; the
// offset clamped to the pool as the plain versions clamp it.
__device__ __forceinline__ float3 pool_texel(const void* pool, int kind, long long len, int base3) {
  if (kind == kPoolU32) {  // one packed word per texel, R | G << 8 | B << 16
    long long k = base3 / 3;
    k = k < 0 ? 0 : (k > len - 1 ? len - 1 : k);
    const uint32_t w = __ldg(static_cast<const uint32_t*>(pool) + k);
    return make_float3(__fdiv_rn(static_cast<float>(w & 0xFFu), 255.f),
                       __fdiv_rn(static_cast<float>((w >> 8) & 0xFFu), 255.f),
                       __fdiv_rn(static_cast<float>((w >> 16) & 0xFFu), 255.f));
  }
  long long k = base3;
  k = k < 0 ? 0 : (k > len - 3 ? len - 3 : k);
  if (kind == kPoolU16) {
    const uint16_t* p = static_cast<const uint16_t*>(pool) + k;
    return make_float3(__fdiv_rn(static_cast<float>(__ldg(p)), 65535.f),
                       __fdiv_rn(static_cast<float>(__ldg(p + 1)), 65535.f),
                       __fdiv_rn(static_cast<float>(__ldg(p + 2)), 65535.f));
  }
  const float* p = static_cast<const float*>(pool) + k;
  return make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

// The block copies the face table into shared memory (6 * kFaceCols ints).
__device__ __forceinline__ void stage_sky(int* s_face, const int* face) {
  for (int k = threadIdx.x; k < 6 * kFaceCols; k += blockDim.x) s_face[k] = face[k];
}

// The sky in direction (dx, dy, dz), not necessarily unit; s_face the
// staged face table.
__device__ __forceinline__ float3 sky_rgb(const int* s_face, const Sky& sky, float dx, float dy,
                                          float dz) {
  const float n2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(n2 > 1e-30f ? n2 : 1e-30f));
  const float x = __fmul_rn(dx, inv), y = __fmul_rn(dy, inv), z = __fmul_rn(dz, inv);
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  int f;
  float u, v, fact;
  if (ax >= ay && ax >= az) {
    f = x < 0.f ? 2 : 3;
    u = z;
    v = y;
    fact = x;
  } else if (ay >= ax && ay >= az) {
    f = y < 0.f ? 4 : 5;
    u = x;
    v = z;
    fact = y;
  } else {
    f = z < 0.f ? 0 : 1;
    u = x;
    v = y;
    fact = z;
  }
  const int* row = s_face + kFaceCols * f;
  const int wid = row[1];
  if (wid <= 0) return make_float3(0.f, 0.f, 0.f);
  const float su = __fadd_rn(__fmul_rn(0.5f, __fdiv_rn(__fmul_rn(u, __int_as_float(row[3])), fact)),
                             0.5f);
  const float sv = __fadd_rn(__fmul_rn(0.5f, __fdiv_rn(__fmul_rn(v, __int_as_float(row[4])), fact)),
                             0.5f);
  const float wf = static_cast<float>(wid), hf = static_cast<float>(row[2]);
  const int px = static_cast<int>(fminf(fmaxf(__fmul_rn(su, wf), 0.f), fmaxf(wf - 1.f, 0.f)));
  const int py = static_cast<int>(fminf(fmaxf(__fmul_rn(sv, hf), 0.f), fmaxf(hf - 1.f, 0.f)));
  return pool_texel(sky.pool, sky.kind, sky.len, row[0] + 3 * (px + py * wid));
}

}  // namespace rt
