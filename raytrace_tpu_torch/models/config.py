"""Scheme schema: the reference's YAML scheme files, parsed to dataclasses.

Mirrors `raytrace_tpu/models/config.py` (same field names, defaults and
parsing rules) for what the port renders: render info, camera, spheres
free triangles and `!Model` glTF members. `!DistantCubeMap` parses to a
placeholder that `models.scene.build_scene` rejects until its ROADMAP
item lands; keyframe animation is not parsed (static schemes only).

PyYAML is imported only by `load_scheme`, so building a scheme from a
dict (`parse_scheme`) needs nothing beyond numpy.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class Tagged:
    """A YAML node that carried a local tag like !Sphere."""

    __slots__ = ("tag", "value")

    def __init__(self, tag, value):
        self.tag = tag
        self.value = value

    def __repr__(self):
        return f"Tagged(!{self.tag}, {self.value!r})"


@dataclass
class RussRoullInfo:
    assured_depth: int = 5
    max_thres: float = 0.5


@dataclass
class RadianceInfo:
    debug_single_ray: bool = False
    dir_light_samp: bool = False
    russ_roull_info: RussRoullInfo = field(default_factory=RussRoullInfo)


@dataclass
class RenderInfo:
    width: int
    height: int
    samps_per_pix: int
    rad_info: RadianceInfo
    kd_tree_depth: int = 17
    render_batch: Optional[int] = None  # the scheme's gpu_render_batch
    use_gpu: bool = True
    animation: bool = False


DIVERT_KINDS = {"Spec": 0, "Diff": 1, "DiffSpec": 2, "Dielectric": 3}


@dataclass
class Material:
    kind: int = 0  # Spec
    diffp: float = 0.0
    n_out: float = 1.0
    n_in: float = 1.0
    emissive: Optional[np.ndarray] = None


@dataclass
class SphereMember:
    c: np.ndarray
    r: float
    rgb: np.ndarray
    mat: Material


@dataclass
class FreeTriangleMember:
    verts: np.ndarray  # (3, 3)
    norm: np.ndarray  # normalized at scene build
    rgb: np.ndarray
    mat: Material


@dataclass
class CubeMapMember:
    """Placeholder: the cube map is not ported yet."""

    faces: dict


@dataclass
class ModelMember:
    """A glTF model placed by T(translation) @ S(uniform_scale) @
    R(euler_angles). `loaded` holds in-memory meshes (a list of
    models.gltf.LoadedMesh, already in world space) that stand in for
    the file, as the procedural a380-class scene does."""

    path: str
    uniform_scale: float = 1.0
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    euler_angles: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    loaded: Optional[list] = None


@dataclass
class CamConfig:
    d: np.ndarray
    o: np.ndarray
    up: np.ndarray
    screen_width: float
    screen_height: float
    view_eulers: np.ndarray
    lens_r: Optional[float] = None


@dataclass
class Scheme:
    render_info: RenderInfo
    cam: CamConfig
    scene_members: list
    scheme_dir: str = "."


def _vec(x):
    return np.asarray(x, dtype=np.float32)


def _parse_material(m) -> Material:
    mat = Material()
    if m is None:
        return mat
    if m.get("emissive") is not None:
        mat.emissive = _vec(m["emissive"])
    dr = m.get("divert_ray")
    if isinstance(dr, str):
        mat.kind = DIVERT_KINDS[dr]
    elif isinstance(dr, Tagged):
        mat.kind = DIVERT_KINDS[dr.tag]
        if dr.tag == "DiffSpec":
            mat.diffp = float(dr.value["diffp"])
        elif dr.tag == "Dielectric":
            mat.n_out = float(dr.value["n_out"])
            mat.n_in = float(dr.value["n_in"])
    elif dr is not None:
        raise ValueError(f"bad divert_ray: {dr!r}")
    return mat


def _parse_coloring(c) -> np.ndarray:
    if isinstance(c, Tagged) and c.tag == "Solid":
        return _vec(c.value)
    raise ValueError(f"unsupported coloring {c!r}")


def parse_member(m):
    if not isinstance(m, Tagged):
        raise ValueError(f"scene member must be tagged: {m!r}")
    v = m.value
    if m.tag == "Sphere":
        return SphereMember(
            c=_vec(v["c"]), r=float(v["r"]),
            rgb=_parse_coloring(v["coloring"]), mat=_parse_material(v.get("mat")),
        )
    if m.tag == "FreeTriangle":
        return FreeTriangleMember(
            verts=_vec(v["verts"]).reshape(3, 3), norm=_vec(v["norm"]),
            rgb=_vec(v["rgb"]), mat=_parse_material(v.get("mat")),
        )
    if m.tag == "DistantCubeMap":
        return CubeMapMember(faces=dict(v))
    if m.tag == "Model":
        if v.get("animation") is not None:
            raise NotImplementedError("animated models are not ported yet (ROADMAP queue 1, item 14)")
        return ModelMember(
            path=v["path"], uniform_scale=float(v["uniform_scale"]),
            translation=_vec(v["translation"]), euler_angles=_vec(v["euler_angles"]),
        )
    raise ValueError(f"unknown member tag !{m.tag}")


def resolve_asset_path(path: str, scheme_dir: str) -> str:
    """An asset path as the JAX package resolves it
    (raytrace_tpu/models/config.py:309-323): as given, relative to the
    scheme, or as <scheme_dir>/../assets/<suffix> for the reference's
    '../../assets/...' forms."""
    candidates = [path, os.path.join(scheme_dir, path)]
    if "assets/" in path:
        suffix = path.split("assets/", 1)[1]
        candidates.append(os.path.join(scheme_dir, "..", "assets", suffix))
        candidates.append(os.path.join(scheme_dir, "assets", suffix))
    for cand in candidates:
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"asset {path!r} not found (searched {candidates})")


def load_scheme(path: str) -> Scheme:
    import yaml

    class _Loader(yaml.SafeLoader):
        pass

    def _tagged(loader, tag_suffix, node):
        if isinstance(node, yaml.MappingNode):
            value = loader.construct_mapping(node, deep=True)
        elif isinstance(node, yaml.SequenceNode):
            value = loader.construct_sequence(node, deep=True)
        else:
            value = loader.construct_scalar(node)
        return Tagged(tag_suffix, value)

    _Loader.add_multi_constructor("!", _tagged)
    with open(path) as f:
        raw = yaml.load(f, Loader=_Loader)
    return parse_scheme(raw, scheme_dir=os.path.dirname(os.path.abspath(path)))


def parse_scheme(raw: dict, scheme_dir: str = ".") -> Scheme:
    ri = raw["render_info"]
    rad = ri.get("rad_info") or {}
    rr = rad.get("russ_roull_info") or {}
    render_info = RenderInfo(
        width=int(ri["width"]),
        height=int(ri["height"]),
        samps_per_pix=int(ri["samps_per_pix"]),
        render_batch=(int(ri["gpu_render_batch"]) if ri.get("gpu_render_batch") is not None else None),
        kd_tree_depth=int(ri.get("kd_tree_depth", 17)),
        rad_info=RadianceInfo(
            debug_single_ray=bool(rad.get("debug_single_ray", False)),
            dir_light_samp=bool(rad.get("dir_light_samp", False)),
            russ_roull_info=RussRoullInfo(
                assured_depth=int(rr.get("assured_depth", 5)),
                max_thres=float(rr.get("max_thres", 0.5)),
            ),
        ),
        use_gpu=bool(ri.get("use_gpu", True)),
        animation=bool(ri.get("animation", False)),
    )
    c = raw["cam"]
    # cam.up is normalized at parse (the reference's builder/mod.rs:69-72)
    up = _vec(c["up"])
    up = up / np.linalg.norm(up)
    cam = CamConfig(
        d=_vec(c["d"]),
        o=_vec(c["o"]),
        up=up,
        screen_width=float(c["screen_width"]),
        screen_height=float(c["screen_height"]),
        view_eulers=_vec(c.get("view_eulers", [0.0, 0.0, 0.0])),
        lens_r=(float(c["lens_r"]) if c.get("lens_r") is not None else None),
    )
    members = [parse_member(m) for m in raw["scene_members"]]
    return Scheme(render_info=render_info, cam=cam, scene_members=members, scheme_dir=scheme_dir)
