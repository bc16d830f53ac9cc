"""Scene packing: scheme members -> numpy SoA.

Mirrors `raytrace_tpu/models/scene.py` (`SceneArrays` :39-153,
`_TexPool` :188, `_mesh_triangle_arrays` :297, `build_scene` :496-748)
for spheres, free triangles, glTF meshes and the cube map: the same
field names, padding (spheres and free triangles to a multiple of 8 rows) and
values, so `ops.trace_kernel.pack_scene_tables` and
`ops.mesh_kernel.pack_mesh_tables` pack the same tables as the JAX
package. Mesh fields are left unpadded (the JAX package pads them to a
multiple of 2,048 for its TPU chunking); `mt_tri12` and the MXU Woop
table are not built (see ops/mesh_kernel.py). A scene of >= 4 copies of
one glTF asset also gets the two-level instancing tables of
`_try_build_instancing` (:404-493): the (I, 24) instance table mk_inst
and the asset's own clusters in its local frame (inst_cl_*), beside the
flattened world-space fields, which stay as they are (shading, mesh_hit,
the differentiable tier and the flattened routes read them). The JAX
package's RTPU_INSTANCING switch is not ported. The cube map's six faces
go into a texel pool of their own, `sky_pool` (:525-545), with the face
tables cm_offsets, cm_dims and cm_uv_scales in the WGSL face order
(config.FACE_ORDER).

`SceneTensors` is the scene on the device for the integrator and the
wavefront driver (render/integrator.py): the JAX Renderer's one
`jax.device_put(self.scene)` per Renderer (renderer.py:828-830). Its
`replace` is the JAX `scene.replace(**diff)` of the differentiable tier.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field, fields
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..utils import profiling
from . import gltf
from .config import (FACE_ORDER, CubeMapMember, FreeTriangleMember, ModelMember, Scheme,
                     SphereMember, resolve_asset_path)

ATTR_COLS = 48  # mt_attr width, the JAX layout (integrator.py:757-759)


def _zeros(*shape, dtype=np.float32):
    return field(default_factory=lambda: np.zeros(shape, dtype))


@dataclass
class SceneArrays:
    # --- spheres ---
    sph_c: np.ndarray  # (S, 3)
    sph_r: np.ndarray  # (S,)
    sph_rgb: np.ndarray  # (S, 3)
    sph_emissive: np.ndarray  # (S, 3)
    sph_has_em: np.ndarray  # (S,) bool
    sph_kind: np.ndarray  # (S,) i32: 0 Spec / 1 Diff / 2 DiffSpec / 3 Dielectric
    sph_diffp: np.ndarray
    sph_n_out: np.ndarray
    sph_n_in: np.ndarray
    sph_valid: np.ndarray  # (S,) bool
    # --- free triangles ---
    ft_v0: np.ndarray
    ft_e1: np.ndarray
    ft_e2: np.ndarray
    ft_norm: np.ndarray
    ft_rgb: np.ndarray
    ft_emissive: np.ndarray
    ft_has_em: np.ndarray
    ft_kind: np.ndarray
    ft_diffp: np.ndarray
    ft_n_out: np.ndarray
    ft_n_in: np.ndarray
    ft_valid: np.ndarray
    # --- mesh triangles (M rows, unpadded) ---
    mt_v0: np.ndarray = _zeros(0, 3)
    mt_e1: np.ndarray = _zeros(0, 3)
    mt_e2: np.ndarray = _zeros(0, 3)
    # (M, 48) f32: 0:3 const_norm | 3:12 nrm_mat row-major | 12 norm_scale |
    # 13:16 rgb_factor | 16 metal | 17 rough | 18 has_norm_map | 19:25 uv_rgb |
    # 25:31 uv_norm | 31:37 uv_mr | 37:48 zero (the JAX package bitcasts
    # mt_desc into 38:47; the port reads mt_desc as int32 instead)
    mt_attr: np.ndarray = _zeros(0, ATTR_COLS)
    # (M, 9) int32: rgb / norm / mr texture [offset, width, height]; width 0 = none
    mt_desc: np.ndarray = _zeros(0, 9, dtype=np.int32)
    # --- mesh clusters (accel/builder.py), cluster-major dense views ---
    cl_v0: np.ndarray = _zeros(0, 8, 3)  # (C, W, 3)
    cl_e1: np.ndarray = _zeros(0, 8, 3)
    cl_e2: np.ndarray = _zeros(0, 8, 3)
    cl_idx: np.ndarray = _zeros(0, 8, dtype=np.int32)  # (C, W) mesh-tri id, -1 pad
    cl_lo: np.ndarray = _zeros(0, 3)  # (C, 3) cluster AABB
    cl_hi: np.ndarray = _zeros(0, 3)
    # --- two-level instancing (n_inst >= 4 copies of one asset): the JAX
    # package's (max(n_inst, 1), 24) f32 instance table, zeros without
    # instancing, rows [A = (1/s) R^T row-major (9) | T (3) | world AABB lo
    # (3) hi (3) | gid base i * inst_tris (1) | 0 (5)] sorted front to back
    # from the camera; and the port's own: the asset's clusters in its
    # local frame (instance 0's triangles mapped by its A, T), local
    # triangle ids in inst_cl_idx, empty without instancing ---
    mk_inst: np.ndarray = _zeros(1, 24)
    inst_cl_v0: np.ndarray = _zeros(0, 8, 3)
    inst_cl_e1: np.ndarray = _zeros(0, 8, 3)
    inst_cl_e2: np.ndarray = _zeros(0, 8, 3)
    inst_cl_idx: np.ndarray = _zeros(0, 8, dtype=np.int32)
    inst_cl_lo: np.ndarray = _zeros(0, 3)
    inst_cl_hi: np.ndarray = _zeros(0, 3)
    # --- cube map faces, in config.FACE_ORDER (JAX defaults without one) ---
    cm_offsets: np.ndarray = _zeros(6, dtype=np.int32)  # R offset of each face in sky_pool
    cm_dims: np.ndarray = _zeros(6, 2, dtype=np.int32)  # (w, h)
    cm_uv_scales: np.ndarray = field(default_factory=lambda: np.ones((6, 2), np.float32))
    # --- texel pools: flat RGB, packed u32 | u16 | f32 (see _TexPool); the
    # mesh textures and the cube map's faces in separate pools ---
    tex_pool: np.ndarray = _zeros(1, dtype=np.uint32)
    sky_pool: np.ndarray = _zeros(1, dtype=np.uint32)
    # --- static metadata ---
    n_spheres: int = 0
    n_free_tris: int = 0
    n_mesh_tris: int = 0
    n_clusters: int = 0
    has_cubemap: bool = False
    n_inst: int = 0  # instances (0: no instancing tables)
    inst_tris: int = 0  # triangles of the asset, the gid base's stride


_ARRAY_FIELDS = tuple(f.name for f in fields(SceneArrays) if f.name.startswith(("sph_", "ft_")))
_MESH_FIELDS = tuple(f.name for f in fields(SceneArrays)
                     if f.name.startswith(("mt_", "cl_")) or f.name == "tex_pool")
_SKY_FIELDS = ("cm_offsets", "cm_dims", "cm_uv_scales", "sky_pool")


def _pad(arr: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    if arr.shape[0] == n:
        return arr
    pad_shape = (n - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0)


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _mat_cols(mats: list, n_pad: int):
    """Material list -> padded column arrays (em, has_em, kind, diffp,
    n_out, n_in); padding rows keep n_out = n_in = 1."""
    n = len(mats)
    em = np.zeros((n, 3), np.float32)
    has = np.zeros((n,), bool)
    kind = np.zeros((n,), np.int32)
    diffp = np.zeros((n,), np.float32)
    n_out = np.ones((n,), np.float32)
    n_in = np.ones((n,), np.float32)
    for i, m in enumerate(mats):
        if m.emissive is not None:
            em[i] = m.emissive
            has[i] = True
        kind[i] = m.kind
        diffp[i] = m.diffp
        n_out[i] = m.n_out
        n_in[i] = m.n_in
    return (_pad(em, n_pad), _pad(has, n_pad), _pad(kind, n_pad),
            _pad(diffp, n_pad), _pad(n_out, n_pad, 1.0), _pad(n_in, n_pad, 1.0))


class _TexPool:
    """Packs images into one flat RGB texel array, deduplicated by array
    identity (instances of one asset share decodes).

    Pool dtype, as the JAX package chooses it (scene.py:188-249): when
    every image has integer source texels, one PACKED u32 word per texel
    (R | G<<8 | B<<16) if all are 8-bit, else u16 (8-bit sources scaled
    by 257); any float source forces f32. Fetch sites convert after the
    gather (ops/texture.py), bit-identical to an all-f32 pool."""

    def __init__(self):
        self.chunks: list = []  # (f32 flat, raw flat or None)
        self.offsets: dict = {}
        self.cursor = 0

    def add(self, pixels: np.ndarray, raw: Optional[np.ndarray] = None):
        key = id(pixels)
        if key in self.offsets:
            return self.offsets[key]
        h, w = pixels.shape[:2]
        flat = np.ascontiguousarray(pixels[:, :, :3], dtype=np.float32).reshape(-1)
        flat_raw = None
        if raw is not None and raw.dtype in (np.uint8, np.uint16):
            flat_raw = np.ascontiguousarray(raw[:, :, :3]).reshape(-1)
            if flat_raw.size != flat.size:
                raise ValueError(f"raw texels {flat_raw.size} != f32 texels {flat.size}")
        entry = (self.cursor, w, h)
        self.offsets[key] = entry
        self.chunks.append((flat, flat_raw))
        self.cursor += flat.size
        return entry

    def finalize(self) -> np.ndarray:
        if not self.chunks:
            return np.zeros((1,), np.uint32)
        if all(r is not None for _, r in self.chunks):
            if all(r.dtype == np.uint8 for _, r in self.chunks):
                flat = np.concatenate([r for _, r in self.chunks])
                return (flat[0::3].astype(np.uint32)
                        | (flat[1::3].astype(np.uint32) << np.uint32(8))
                        | (flat[2::3].astype(np.uint32) << np.uint32(16)))
            return np.concatenate([r.astype(np.uint16) * np.uint16(257) if r.dtype == np.uint8
                                   else r for _, r in self.chunks])
        return np.concatenate([f for f, _ in self.chunks])


def _normalize_rows(a: np.ndarray, eps: float = 1e-20) -> np.ndarray:
    n = np.linalg.norm(a, axis=-1, keepdims=True)
    return a / np.maximum(n, eps)


def _mesh_triangle_arrays(meshes: list, pool: _TexPool):
    """LoadedMesh primitives -> per-triangle columns, as the JAX package
    builds them (scene.py:297-401, the reference's
    NormFromMesh::generate_norm_type, mesh/triangle.rs:45-122):

    * trans_mat3 = (world^-1)^T upper 3x3, the normal transform;
    * normal map + tangents: frame [trans_mat3 @ [sum-tangents,
      tan x face_norm]] with column 2 the world face normal, columns
      normalized;
    * normal map, no tangents: the frame from the base-colour uvs,
      trans_mat3 where the uvs are singular or absent;
    * no normal map: the constant shading normal
      normalize(trans_mat3 @ (n0 + n1 + n2)) (the reference sums the
      vertex normals without barycentric weights)."""
    cols = {k: [] for k in ("v0", "v1", "v2", "const_norm", "nrm_mat", "norm_scale",
                            "has_norm_map", "rgb_factor", "uv_rgb", "uv_norm", "uv_mr",
                            "rgb_tex", "norm_tex", "mr_tex", "metal", "rough")}
    for lm in meshes:
        trans_mat3 = np.linalg.inv(lm.trans_mat.astype(np.float64)).T[:3, :3].astype(np.float32)
        for prim in lm.primitives:
            idx = prim.indices
            T = idx.shape[0]
            if T == 0:
                continue
            v = prim.poses[idx]
            v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
            face_norm = _normalize_rows(np.cross(v1 - v0, v2 - v0))
            nsum = prim.norms[idx].sum(axis=1)
            has_nm = prim.norm_tex is not None
            if not has_nm:
                nmat = np.broadcast_to(trans_mat3, (T, 3, 3)).copy()
                const_norm = _normalize_rows(nsum @ trans_mat3.T)
            else:
                const_norm = face_norm.copy()
                if prim.tangents is not None:
                    tan = _normalize_rows(prim.tangents[idx].sum(axis=1))
                    m = np.zeros((T, 3, 3), np.float32)
                    m[:, :, 0] = tan
                    m[:, :, 1] = np.cross(tan, face_norm)
                    m = np.einsum("ab,tbc->tac", trans_mat3, m)
                    m[:, :, 2] = face_norm
                    nmat = m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-20)
                elif prim.rgb_tex is not None:
                    uv = prim.rgb_tex.coords[idx]
                    t1 = uv[:, 1] - uv[:, 0]
                    t2 = uv[:, 2] - uv[:, 0]
                    det = t1[:, 0] * t2[:, 1] - t1[:, 1] * t2[:, 0]
                    ok = np.abs(det) > 1e-12
                    inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
                    e1, e2 = v1 - v0, v2 - v0
                    tcol = (e1 * t2[:, 1:2] - e2 * t1[:, 1:2]) * inv_det[:, None]
                    bcol = (e2 * t1[:, 0:1] - e1 * t2[:, 0:1]) * inv_det[:, None]
                    m = np.zeros((T, 3, 3), np.float32)
                    m[:, :, 0] = _normalize_rows(tcol)
                    m[:, :, 1] = _normalize_rows(bcol)
                    m = np.einsum("ab,tbc->tac", trans_mat3, m)
                    m[:, :, 2] = face_norm
                    m = m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-20)
                    nmat = np.where(ok[:, None, None], m, trans_mat3[None])
                else:
                    nmat = np.broadcast_to(trans_mat3, (T, 3, 3)).copy()

            def tex_entry(tex):
                if tex is None:
                    return (0, 0, 0), np.zeros((T, 3, 2), np.float32)
                return pool.add(tex.pixels, raw=tex.pixels_raw), tex.coords[idx].astype(np.float32)

            rgb_entry, uv_rgb = tex_entry(prim.rgb_tex)
            norm_entry, uv_norm = tex_entry(prim.norm_tex)
            mr_entry, uv_mr = tex_entry(prim.mr_tex)
            for k, val in (("v0", v0), ("v1", v1), ("v2", v2), ("const_norm", const_norm),
                           ("nrm_mat", nmat.astype(np.float32)),
                           ("norm_scale", np.full((T,), prim.norm_scale, np.float32)),
                           ("has_norm_map", np.full((T,), has_nm, bool)),
                           ("rgb_factor", np.broadcast_to(prim.rgb_factor, (T, 3)).copy()),
                           ("uv_rgb", uv_rgb), ("uv_norm", uv_norm), ("uv_mr", uv_mr),
                           ("metal", np.full((T,), prim.metal_factor, np.float32)),
                           ("rough", np.full((T,), prim.rough_factor, np.float32))):
                cols[k].append(val)
            for k, entry in (("rgb_tex", rgb_entry), ("norm_tex", norm_entry),
                             ("mr_tex", mr_entry)):
                cols[k].append(np.broadcast_to(np.array(entry, np.int32), (T, 3)).copy())
    if not cols["v0"]:
        return None
    return {k: np.concatenate(vs, axis=0) for k, vs in cols.items()}


def _mesh_fields(mt: dict) -> dict:
    """Per-triangle columns -> the SceneArrays mesh and cluster fields."""
    from ..accel.builder import build_clusters_bvh

    M = mt["v0"].shape[0]
    v0, v1, v2 = mt["v0"], mt["v1"], mt["v2"]
    lo3 = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi3 = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    with profiling.span("scene.clusters"):
        cp, cl_lo, cl_hi = build_clusters_bvh(lo3, hi3, leaf_target=64)
    safe = np.maximum(cp, 0)
    attr = np.zeros((M, ATTR_COLS), np.float32)
    attr[:, 0:3] = mt["const_norm"]
    attr[:, 3:12] = mt["nrm_mat"].reshape(M, 9)
    attr[:, 12] = mt["norm_scale"]
    attr[:, 13:16] = mt["rgb_factor"]
    attr[:, 16] = mt["metal"]
    attr[:, 17] = mt["rough"]
    attr[:, 18] = mt["has_norm_map"].astype(np.float32)
    attr[:, 19:25] = mt["uv_rgb"].reshape(M, 6)
    attr[:, 25:31] = mt["uv_norm"].reshape(M, 6)
    attr[:, 31:37] = mt["uv_mr"].reshape(M, 6)
    return dict(
        mt_v0=v0.astype(np.float32),
        mt_e1=(v1 - v0).astype(np.float32),
        mt_e2=(v2 - v0).astype(np.float32),
        mt_attr=attr,
        mt_desc=np.concatenate([mt["rgb_tex"], mt["norm_tex"], mt["mr_tex"]], axis=1
                               ).astype(np.int32),
        cl_v0=v0[safe].astype(np.float32),
        cl_e1=(v1 - v0)[safe].astype(np.float32),
        cl_e2=(v2 - v0)[safe].astype(np.float32),
        cl_idx=cp.astype(np.int32), cl_lo=cl_lo, cl_hi=cl_hi,
        n_mesh_tris=M, n_clusters=int(cp.shape[0]),
    )


def _asset_clusters(lv0, lv1, lv2) -> dict:
    """The asset's local triangles (f64) -> its inst_cl_* fields: f32
    vertices and edges, clusters by accel/builder.py over their bounds
    (scene.py:448-455 of the JAX package)."""
    from ..accel.builder import build_clusters_bvh

    l0 = lv0.astype(np.float32)
    e1 = (lv1 - lv0).astype(np.float32)
    e2 = (lv2 - lv0).astype(np.float32)
    lo3 = np.minimum(np.minimum(l0, l0 + e1), l0 + e2)
    hi3 = np.maximum(np.maximum(l0, l0 + e1), l0 + e2)
    with profiling.span("scene.clusters"):
        cp, cl_lo, cl_hi = build_clusters_bvh(lo3, hi3, leaf_target=64)
    safe = np.maximum(cp, 0)
    return dict(inst_cl_v0=l0[safe], inst_cl_e1=e1[safe], inst_cl_e2=e2[safe],
                inst_cl_idx=cp.astype(np.int32), inst_cl_lo=cl_lo, inst_cl_hi=cl_hi)


def _try_build_instancing(model_members: list, mt: dict, cam_o) -> Optional[dict]:
    """The JAX package's `_try_build_instancing` (scene.py:404-493): a
    scene of I >= 4 Model members of one asset (one resolved path, or for
    in-memory members one `path` string) that together own all M mesh
    triangles in member order, M % I == 0, and whose instances all map to
    instance 0's local geometry within 1e-3 of the asset's scale on a
    64-row probe. Returns the instancing fields (mk_inst sorted by the
    camera's distance to each instance's AABB centre, n_inst, inst_tris,
    the asset's local clusters), or None when any rule fails."""
    from .camera import euler_matrix

    if len(model_members) < 4 or len({p for p, _ in model_members}) != 1:
        return None
    I, M = len(model_members), mt["v0"].shape[0]
    if M % I:
        return None
    Ml = M // I
    v0, v1, v2 = (mt[k].astype(np.float64) for k in ("v0", "v1", "v2"))
    # inverse transforms A_i = (1/s) R^T, T_i (the placement p_w = s R p + T)
    As, Ts = [], []
    for _, m in model_members:
        R = euler_matrix(*(float(v) for v in m.euler_angles))
        As.append(R.T / float(m.uniform_scale))
        Ts.append(np.asarray(m.translation, np.float64))
    lv0, lv1, lv2 = ((v[:Ml] - Ts[0]) @ As[0].T for v in (v0, v1, v2))
    scale = max(np.abs(lv0).max(), 1e-6)
    probe = np.linspace(0, Ml - 1, num=min(64, Ml), dtype=np.int64)
    for i in range(1, I):
        if np.abs((v0[i * Ml + probe] - Ts[i]) @ As[i].T - lv0[probe]).max() > 1e-3 * scale:
            return None
    inst = np.zeros((I, 24), np.float32)
    for i in range(I):
        w = slice(i * Ml, (i + 1) * Ml)
        inst[i, 0:9] = As[i].reshape(9)
        inst[i, 9:12] = Ts[i]
        inst[i, 12:15] = np.minimum(np.minimum(v0[w], v1[w]), v2[w]).min(axis=0)
        inst[i, 15:18] = np.maximum(np.maximum(v0[w], v1[w]), v2[w]).max(axis=0)
        inst[i, 18] = i * Ml  # the gid base rides the row through the sort
    # front to back: a near instance's hit prunes the later instances' walks
    centers = (inst[:, 12:15] + inst[:, 15:18]) / 2.0
    order = np.argsort(np.linalg.norm(centers - np.asarray(cam_o, np.float64), axis=1))
    return dict(mk_inst=inst[order], n_inst=I, inst_tris=Ml, **_asset_clusters(lv0, lv1, lv2))


def _sky_fields(cubemap: CubeMapMember, scheme_dir: str) -> dict:
    """The cube map's faces -> the SceneArrays sky fields (scene.py:525-545
    of the JAX package): each face decoded once per resolved path with
    PIL's convert("RGB") as u8, into a pool of its own."""
    from PIL import Image

    sky = _TexPool()
    offsets = np.zeros((6,), np.int32)
    dims = np.zeros((6, 2), np.int32)
    scales = np.ones((6, 2), np.float32)
    decoded: dict = {}  # repeated face paths share one decode
    for i, name in enumerate(FACE_ORDER):
        face = getattr(cubemap, name)
        p = resolve_asset_path(face.path, scheme_dir)
        if p not in decoded:
            with Image.open(p) as im:
                raw = np.asarray(im.convert("RGB"), dtype=np.uint8)
            decoded[p] = (raw.astype(np.float32) / 255.0, raw)
        img, raw = decoded[p]
        off, w, h = sky.add(img, raw=raw)
        offsets[i] = off
        dims[i] = (w, h)
        scales[i] = (face.u_scale, face.v_scale)
    return dict(cm_offsets=offsets, cm_dims=dims, cm_uv_scales=scales, sky_pool=sky.finalize())


def build_scene(scheme: Scheme, pad_small: int = 8) -> SceneArrays:
    """Members -> SceneArrays (spheres, free triangles, glTF meshes, the
    cube map: the last one, as the reference keeps only one)."""
    with profiling.span("scene.build"):
        return _build_scene(scheme, pad_small)


def _build_scene(scheme: Scheme, pad_small: int) -> SceneArrays:
    spheres, tris, meshes, model_members = [], [], [], []
    cubemap = None
    image_cache: dict = {}  # one decode per (file, image) across instances
    for m in scheme.scene_members:
        if isinstance(m, SphereMember):
            spheres.append(m)
        elif isinstance(m, FreeTriangleMember):
            tris.append(m)
        elif isinstance(m, ModelMember):
            if m.loaded is not None:
                model_members.append((m.path, m))
                meshes.extend(gltf.place_meshes(m.loaded, m.translation, m.uniform_scale,
                                                m.euler_angles))
            else:
                path = resolve_asset_path(m.path, scheme.scheme_dir)
                model_members.append((path, m))
                meshes.extend(gltf.load_model(path, m.translation, m.uniform_scale,
                                              m.euler_angles, image_cache=image_cache))
        elif isinstance(m, CubeMapMember):
            cubemap = m
        else:
            raise TypeError(f"unknown member {m!r}")

    S, F = len(spheres), len(tris)
    Sp, Fp = _pad_to(S, pad_small), _pad_to(F, pad_small)
    sph_c = np.stack([s.c for s in spheres]) if S else np.zeros((0, 3), np.float32)
    sph_rgb = np.stack([s.rgb for s in spheres]) if S else np.zeros((0, 3), np.float32)
    sph_r = np.array([s.r for s in spheres], np.float32)
    if F:
        verts = np.stack([t.verts for t in tris])  # (F, 3, 3)
        norm = np.stack([t.norm for t in tris])
        # normalized at build (the reference's builder/inner.rs:48)
        norm = norm / np.maximum(np.linalg.norm(norm, axis=-1, keepdims=True), 1e-20)
        ft_rgb = np.stack([t.rgb for t in tris])
    else:
        verts = np.zeros((0, 3, 3), np.float32)
        norm = np.zeros((0, 3), np.float32)
        ft_rgb = np.zeros((0, 3), np.float32)
    sm = _mat_cols([s.mat for s in spheres], Sp)
    fm = _mat_cols([t.mat for t in tris], Fp)
    f32 = lambda a, n: _pad(a.astype(np.float32), n)
    with profiling.span("scene.meshes"):
        pool = _TexPool()
        mt = _mesh_triangle_arrays(meshes, pool)
        tex_pool = pool.finalize()
    mesh = _mesh_fields(mt) if mt else {}
    if mt:
        with profiling.span("scene.instancing"):
            mesh.update(_try_build_instancing(model_members, mt, scheme.cam.o) or {})
    sky = {}
    if cubemap is not None:
        with profiling.span("scene.sky"):
            sky = _sky_fields(cubemap, scheme.scheme_dir)
    return SceneArrays(
        sph_c=f32(sph_c, Sp), sph_r=_pad(sph_r, Sp), sph_rgb=f32(sph_rgb, Sp),
        sph_emissive=sm[0], sph_has_em=sm[1], sph_kind=sm[2],
        sph_diffp=sm[3], sph_n_out=sm[4], sph_n_in=sm[5],
        sph_valid=_pad(np.ones((S,), bool), Sp),
        ft_v0=f32(verts[:, 0], Fp),
        ft_e1=f32(verts[:, 1] - verts[:, 0], Fp),
        ft_e2=f32(verts[:, 2] - verts[:, 0], Fp),
        ft_norm=f32(norm, Fp), ft_rgb=f32(ft_rgb, Fp),
        ft_emissive=fm[0], ft_has_em=fm[1], ft_kind=fm[2],
        ft_diffp=fm[3], ft_n_out=fm[4], ft_n_in=fm[5],
        ft_valid=_pad(np.ones((F,), bool), Fp),
        tex_pool=tex_pool,
        n_spheres=S, n_free_tris=F, has_cubemap=cubemap is not None,
        **mesh, **sky,
    )


def from_reference(ref_fields: Mapping) -> SceneArrays:
    """The JAX package's SceneArrays, given as a mapping of field name to
    numpy array (e.g. `{f: np.asarray(getattr(s, f)) ...}`), -> this
    package's SceneArrays, mesh fields included: the JAX package's
    padded mesh rows are dropped and mt_attr's bitcast descriptor
    columns zeroed, and the cube map's face tables and sky pool with
    has_cubemap. The instance table mk_inst, n_inst and inst_tris are
    carried; the asset's local clusters are rebuilt here from the JAX
    scene's instance 0 (the row of gid base 0) and its world triangles,
    and its packed kernel and Woop tables are not carried: the port packs
    its kernel tables from the cl_* and inst_cl_* fields."""
    kw = {k: np.array(ref_fields[k]) for k in _ARRAY_FIELDS + _SKY_FIELDS}
    M = int(ref_fields.get("n_mesh_tris", 0))
    if M:
        kw.update({k: np.array(ref_fields[k]) for k in _MESH_FIELDS})
        for k in ("mt_v0", "mt_e1", "mt_e2", "mt_attr", "mt_desc"):
            if kw[k].shape[0] < M:
                raise ValueError(f"{k} holds {kw[k].shape[0]} rows, n_mesh_tris is {M}")
            kw[k] = kw[k][:M]
        kw["mt_attr"][:, 37:] = 0.0
        kw["n_clusters"] = int(ref_fields["n_clusters"])
        I = int(ref_fields.get("n_inst", 0))
        kw["mk_inst"] = np.array(ref_fields.get("mk_inst", np.zeros((1, 24), np.float32)))
        if I:
            inst = np.array(ref_fields["mk_inst"], np.float32)
            Ml = int(ref_fields["inst_tris"])
            row = inst[int(np.argmin(inst[:I, 18]))]
            A, T = row[0:9].reshape(3, 3).astype(np.float64), row[9:12].astype(np.float64)
            v0 = kw["mt_v0"][:Ml].astype(np.float64)
            lv = [(v - T) @ A.T for v in (v0, v0 + kw["mt_e1"][:Ml], v0 + kw["mt_e2"][:Ml])]
            kw.update(mk_inst=inst, n_inst=I, inst_tris=Ml, **_asset_clusters(*lv))
    return SceneArrays(
        **kw,
        n_spheres=int(ref_fields["n_spheres"]),
        n_free_tris=int(ref_fields["n_free_tris"]),
        n_mesh_tris=M,
        has_cubemap=bool(ref_fields["has_cubemap"]),
    )


_SPH_TENSORS = ("sph_c", "sph_r", "sph_rgb", "sph_emissive", "sph_has_em", "sph_kind",
                "sph_diffp", "sph_n_out", "sph_n_in")
_FT_TENSORS = ("ft_v0", "ft_e1", "ft_e2", "ft_norm", "ft_rgb", "ft_emissive", "ft_has_em",
               "ft_kind", "ft_diffp", "ft_n_out", "ft_n_in")
_MT_TENSORS = ("mt_v0", "mt_e1", "mt_e2")  # the differentiable tier's mesh hit (integrator.py)
# the fields `replace` takes besides the buffers above
_ATTR_LEAVES = {"mt_const_norm": (0, 3), "mt_rgb_factor": (13, 16)}  # mt_attr columns
_POOL_LEAVES = ("tex_pool", "sky_pool")


def _view(module: nn.Module, **buffers) -> nn.Module:
    """A shallow copy of `module` whose buffers and submodules can be set
    without touching the original; `buffers` set on it."""
    view = copy.copy(module)
    view._buffers = dict(module._buffers)
    view._modules = dict(module._modules)
    for k, t in buffers.items():
        view._buffers[k] = t
    return view


class SceneTensors(nn.Module):
    """Every SceneArrays field the integrator reads, as buffers moved
    once with `.to(device)`: the sphere and free-triangle columns
    without their padding rows (their rows keep the SceneArrays order,
    so sphere indices are the JAX integrator's), and for a mesh scene
    `mesh`, the flattened, camera-ordered walk tables and shading
    attributes of `ops.mesh_kernel.MeshTables` (None without a mesh), and
    `sky`, the cube map's `ops.cubemap.SkyTables` (None without one).
    `cam` is the camera row as Python floats (raygen's constants) and
    `emitters` the indices of the emissive spheres that direct-light
    sampling sums over. A mesh scene also holds the mesh's own vertex
    tables mt_v0, mt_e1, mt_e2, which the differentiable tier's mesh hit
    reads."""

    def __init__(self, scene: SceneArrays, cam, max_thres: float):
        super().__init__()
        from ..ops.cubemap import SkyTables
        from ..ops.mesh_kernel import MeshTables
        from ..ops.trace_kernel import make_cam_vec

        self.n_spheres = S = int(scene.n_spheres)
        self.n_free_tris = F = int(scene.n_free_tris)
        self.n_mesh_tris = int(scene.n_mesh_tris)
        for names, n in ((_SPH_TENSORS, S), (_FT_TENSORS, F)):
            for k in names:
                a = np.ascontiguousarray(getattr(scene, k)[:n])
                self.register_buffer(k, torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                                                         else a))
        if self.n_mesh_tris:
            for k in _MT_TENSORS:
                self.register_buffer(k, torch.from_numpy(np.ascontiguousarray(getattr(scene, k))))
        self.mesh = MeshTables(scene, cam, max_thres) if self.n_mesh_tris else None
        # a mesh scene's sky rides in its MeshTables: one copy on the device
        self.sky = (self.mesh.sky if self.mesh is not None
                    else SkyTables(scene) if scene.has_cubemap else None)
        self.cam = [float(v) for v in make_cam_vec(cam, max_thres).reshape(-1)]
        self.has_lens = cam.lens_r is not None
        self.emitters = [e for e in range(S) if bool(scene.sph_has_em[e])]

    def replace(self, **leaves) -> "SceneTensors":
        """A view of this scene whose fields named in `leaves` are the
        given tensors, and whose other buffers are this scene's own (the
        JAX package's `scene.replace(**diff)`): the sph_*, ft_* and
        mt_v0 / mt_e1 / mt_e2 columns as they are; mt_const_norm (M, 3)
        and mt_rgb_factor (M, 3) as the columns 0:3 and 13:16 of the
        mesh's attr table, which the shading reads (the JAX package's
        mt_const_norm / mt_rgb_factor fields are copies that its shading
        never reads); tex_pool and sky_pool as flat (3T,) f32 RGB pools,
        as texture.pool_to_f32_flat gives them."""
        from ..ops.texture import POOL_F32

        known = _SPH_TENSORS + _FT_TENSORS + _MT_TENSORS + tuple(_ATTR_LEAVES) + _POOL_LEAVES
        unknown = sorted(set(leaves) - set(known))
        if unknown:
            raise ValueError(f"SceneTensors.replace takes none of {unknown}")
        needs_mesh = set(leaves) & (set(_MT_TENSORS) | set(_ATTR_LEAVES) | {"tex_pool"})
        if needs_mesh and self.mesh is None:
            raise ValueError(f"{sorted(needs_mesh)}: the scene has no mesh")
        if "sky_pool" in leaves and self.sky is None:
            raise ValueError("sky_pool: the scene has no cube map")
        view = _view(self, **{k: v for k, v in leaves.items()
                              if k in _SPH_TENSORS + _FT_TENSORS + _MT_TENSORS})
        if self.mesh is None:
            if "sky_pool" in leaves:
                view.sky = _view(self.sky, pool=leaves["sky_pool"])
                view.sky.kind = POOL_F32
            return view
        mesh = view.mesh = _view(self.mesh)
        if set(leaves) & set(_ATTR_LEAVES):
            a = self.mesh.attr
            cols, at = [], 0
            for name, (lo, hi) in _ATTR_LEAVES.items():
                cols += [a[:, at:lo], leaves.get(name, a[:, lo:hi])]
                at = hi
            mesh.attr = torch.cat(cols + [a[:, at:]], dim=1)
        if "tex_pool" in leaves:
            mesh.pool, mesh.pool_kind = leaves["tex_pool"], POOL_F32
        if "sky_pool" in leaves:
            mesh.sky = _view(self.sky, pool=leaves["sky_pool"])
            mesh.sky.kind = POOL_F32
        view.sky = mesh.sky
        return view
