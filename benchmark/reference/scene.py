"""The reference's own tables, worked out from the raw scene
(benchmark.scenes.RawScene): sphere columns, the camera row, and for a
mesh its per-triangle shading columns, its textures and its cluster walk
tables (geometry.build_tables)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .camera import camera_row
from .geometry import build_tables

KINDS = {"Spec": 0, "Diff": 1, "DiffSpec": 2, "Dielectric": 3}


@dataclass
class RefScene:
    dtype: torch.dtype
    cam: list  # 18 floats (camera.camera_row)
    sph_rows: list  # (cx, cy, cz, r) a sphere, floats
    sph: dict  # columns of the spheres, (S,) or (S, 3) tensors
    mesh: Optional[dict]


def _material(mat: dict):
    """(kind, diffp, n_out, n_in, emissive or None) of a sphere's mat."""
    dr = mat.get("divert_ray", "Spec")
    if isinstance(dr, str):
        tag, val = dr, {}
    else:
        (tag, val), = dr.items()
    return (KINDS[tag], float(val.get("diffp", 0.0)), float(val.get("n_out", 1.0)),
            float(val.get("n_in", 1.0)), mat.get("emissive"))


def _normalize_rows(a: np.ndarray, eps: float = 1e-20) -> np.ndarray:
    return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), eps)


IMPLEMENTED = {"dir_light_samp": False, "debug_single_ray": False}  # rad_info flags as followed


def build(raw, device, dtype=torch.float32) -> RefScene:
    for k, v in raw.rad_info.items():
        if k not in IMPLEMENTED or bool(v) != IMPLEMENTED[k]:
            raise NotImplementedError(f"the reference does not follow rad_info {k}: {v!r}")
    rnd = (lambda v: float(torch.tensor(v, dtype=dtype))) if dtype != torch.float32 else float
    f32 = lambda a: np.asarray(a, np.float32)
    cam = dict(raw.cam, up=f32(raw.cam["up"]) / np.linalg.norm(f32(raw.cam["up"])))
    row = camera_row(cam, raw.width, raw.height, raw.max_thres)
    S = len(raw.spheres)
    cols = {k: np.zeros((S,), np.float32) for k in ("r", "kind", "diffp", "has_em")}
    cols.update(n_out=np.ones((S,), np.float32), n_in=np.ones((S,), np.float32))
    c, rgb, em = (np.zeros((S, 3), np.float32) for _ in range(3))
    for i, s in enumerate(raw.spheres):
        kind, diffp, n_out, n_in, emissive = _material(s.get("mat", {}))
        c[i], rgb[i], cols["r"][i] = f32(s["c"]), f32(s["rgb"]), s["r"]
        cols["kind"][i], cols["diffp"][i], cols["n_out"][i], cols["n_in"][i] = \
            kind, diffp, n_out, n_in
        if emissive is not None:
            em[i], cols["has_em"][i] = f32(emissive), 1.0
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    sph = {k: put(v).to(dtype) for k, v in cols.items()}
    sph["c"] = put(c).to(dtype)
    sph["kind_i"] = put(cols["kind"].astype(np.int64))
    for k in range(3):
        sph[f"rgb{k}"], sph[f"em{k}"] = put(rgb[:, k]).to(dtype), put(em[:, k]).to(dtype)
    sph_rows = [[rnd(v) for v in (*c[i], cols["r"][i])] for i in range(S)]
    return RefScene(dtype=dtype, cam=[rnd(v) for v in row], sph_rows=sph_rows, sph=sph,
                    mesh=_mesh(raw.primitives, row[0:3], device, dtype) if raw.primitives
                    else None)


def _mesh(prims: list, cam_o, device, dtype) -> dict:
    cols = {k: [] for k in ("v0", "v1", "v2", "const_norm", "rgb_factor", "metal", "rough", "uv",
                            "tex_id")}
    textures = []
    for p in prims:
        idx = p["indices"]
        T = idx.shape[0]
        v = p["poses"][idx]
        nsum = p["norms"][idx].sum(axis=1)
        const_norm = _normalize_rows(nsum @ np.eye(3, dtype=np.float32).T)
        if p["texture"] is not None:
            tex_id, uv = len(textures), p["coords"][idx].astype(np.float32).reshape(T, 6)
            textures.append(p["texture"])
        else:
            tex_id, uv = -1, np.zeros((T, 6), np.float32)
        for k, val in (("v0", v[:, 0]), ("v1", v[:, 1]), ("v2", v[:, 2]),
                       ("const_norm", const_norm),
                       ("rgb_factor", np.broadcast_to(p["rgb_factor"], (T, 3))),
                       ("metal", np.full((T,), p["metal"], np.float32)),
                       ("rough", np.full((T,), p["rough"], np.float32)), ("uv", uv),
                       ("tex_id", np.full((T,), tex_id, np.int64))):
            cols[k].append(val)
    m = {k: np.concatenate(v, axis=0) for k, v in cols.items()}
    tables = build_tables(m["v0"], m["v1"], m["v2"], cam_o)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = {k: to(m[k]).to(dtype) for k in ("const_norm", "rgb_factor", "metal", "rough", "uv")}
    out["tex_id"] = to(m["tex_id"])
    out["textures"] = to(np.stack(textures)) if textures else torch.zeros(
        (1, 1, 1, 3), dtype=torch.uint8, device=device)
    out["tables"] = {k: to(a).to(dtype) if a.dtype == np.float32 else to(a)
                     for k, a in tables.items()}
    out["n_tris"] = int(m["v0"].shape[0])
    return out
