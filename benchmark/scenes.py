"""A configuration file (configs/<name>.json) -> the raw scene both sides
render: the camera, the spheres and their materials, and the mesh's
primitives (positions, vertex normals, uvs, u8 textures), made from the
configuration's fixed seeds. Nothing here depends on `--seed`: the seed
picks sample ids, never the scene.

A configuration's "mesh" names its kind, a file of its own:
meshes/<kind>.py makes the primitives from the mesh's entry. Its
"rad_info" (optional) holds the scheme's further rad_info flags
(dir_light_samp, debug_single_ray), which system.py hands to the program
as they are; the reference refuses a flag that it does not implement.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent


@dataclass
class RawScene:
    width: int
    height: int
    use_gpu: bool
    assured_depth: int
    max_thres: float
    max_bounces: int
    cam: dict
    spheres: list  # {"c", "r", "rgb", "mat": {"divert_ray", "emissive"}}
    rad_info: dict = field(default_factory=dict)  # further rad_info flags of the scheme
    primitives: list = field(default_factory=list)  # see meshes/


def load_config(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "configs" / f"{name}.json").read_text())


def mesh_primitives(mesh: dict, root: Path = ROOT) -> list:
    """meshes/<kind>.py's `make(mesh)`: the primitives of a mesh kind."""
    kind = mesh["kind"]
    spec = importlib.util.spec_from_file_location("_bench_mesh_" + kind.replace(".", "_"),
                                                  root / "meshes" / f"{kind}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make(mesh)


def raw_scene(cfg: dict) -> RawScene:
    mesh = cfg.get("mesh")
    return RawScene(
        width=int(cfg["width"]), height=int(cfg["height"]), use_gpu=bool(cfg["use_gpu"]),
        assured_depth=int(cfg["assured_depth"]), max_thres=float(cfg["max_thres"]),
        max_bounces=int(cfg["max_bounces"]), cam=cfg["cam"], spheres=cfg["spheres"],
        rad_info=dict(cfg.get("rad_info", {})),
        primitives=mesh_primitives(mesh) if mesh else [])
