"""Scene packing for the meshless subset: scheme members -> numpy SoA.

Mirrors the sphere and free-triangle part of
`raytrace_tpu/models/scene.py` (`SceneArrays` :39-153, `build_scene`
:496-612): the same field names, padding (to a multiple of 8 rows) and
values, so `ops.trace_kernel.pack_scene_tables` packs bit-equal tables.
Meshes and the cube map are not ported yet; `build_scene` rejects them.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Mapping

import numpy as np

from .config import CubeMapMember, FreeTriangleMember, ModelMember, Scheme, SphereMember


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
    # --- static metadata ---
    n_spheres: int = 0
    n_free_tris: int = 0
    has_cubemap: bool = False


_ARRAY_FIELDS = tuple(f.name for f in fields(SceneArrays) if f.name.startswith(("sph_", "ft_")))


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


def build_scene(scheme: Scheme, pad_small: int = 8) -> SceneArrays:
    """Members -> SceneArrays (spheres and free triangles only)."""
    spheres, tris = [], []
    for m in scheme.scene_members:
        if isinstance(m, SphereMember):
            spheres.append(m)
        elif isinstance(m, FreeTriangleMember):
            tris.append(m)
        elif isinstance(m, ModelMember):
            raise NotImplementedError(
                "glTF meshes are not ported yet (ROADMAP queue 1, items 7-11)")
        elif isinstance(m, CubeMapMember):
            raise NotImplementedError(
                "the cube map is not ported yet (ROADMAP queue 1, item 2: cubemap.sample)")
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
        n_spheres=S, n_free_tris=F, has_cubemap=False,
    )


def from_reference(ref_fields: Mapping) -> SceneArrays:
    """The JAX package's SceneArrays, given as a mapping of field name to
    numpy array (e.g. `{f: np.asarray(getattr(s, f)) ...}`), -> this
    package's SceneArrays. Mesh scenes are rejected."""
    if int(ref_fields.get("n_mesh_tris", 0)):
        raise NotImplementedError("glTF meshes are not ported yet (ROADMAP queue 1, items 7-11)")
    kw = {k: np.array(ref_fields[k]) for k in _ARRAY_FIELDS}
    return SceneArrays(
        **kw,
        n_spheres=int(ref_fields["n_spheres"]),
        n_free_tris=int(ref_fields["n_free_tris"]),
        has_cubemap=bool(ref_fields["has_cubemap"]),
    )
