"""A configuration file (configs/<name>.json) -> the raw scene both sides
render: the camera, the spheres and their materials, and the mesh's
primitives (positions, vertex normals, uvs, u8 textures), made from the
configuration's fixed seeds. Nothing here depends on `--seed`: the seed
picks sample ids, never the scene.

A configuration's "mesh" names its kind, a file of its own:
meshes/<kind>.py makes the primitives from the mesh's entry. Its "sky"
(optional, the scheme's !DistantCubeMap) names a kind the same way:
skies/<kind>.py makes the six u8 faces and their uv scales from the sky's
entry, on the device that raw_scene is given. Its "rad_info" (optional)
holds the scheme's further rad_info flags (dir_light_samp,
debug_single_ray), which system.py hands to the program as they are; the
reference refuses a flag that it does not implement. Its notes
"recorded" and "assumed" list what it takes from the records of its
source and what it had to assume. A key that none of this names is
refused, so that nothing of a configuration is dropped unseen.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

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
    # {"faces": (6, S, S, 3) u8 tensor on the host, "scales": six (u, v)}, in the upstream's
    # face order [neg_z, pos_z, neg_x, pos_x, neg_y, pos_y] (skies/); None without a cube map
    sky: Optional[dict] = None


KEYS = {"source", "recorded", "assumed", "reduced", "width", "height", "use_gpu", "assured_depth",
        "max_thres", "max_bounces", "cam", "spheres", "mesh", "sky", "rad_info"}


def load_config(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "configs" / f"{name}.json").read_text())


def _make(folder: str, entry: dict, root: Path, *args):
    """<folder>/<kind>.py's `make(entry, *args)`, the kind named by
    entry["kind"]."""
    kind = entry["kind"]
    spec = importlib.util.spec_from_file_location(f"_bench_{folder}_" + kind.replace(".", "_"),
                                                  root / folder / f"{kind}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make(entry, *args)


def mesh_primitives(mesh: dict, root: Path = ROOT) -> list:
    """meshes/<kind>.py's `make(mesh)`: the primitives of a mesh kind."""
    return _make("meshes", mesh, root)


def sky_faces(sky: dict, device="cpu", root: Path = ROOT) -> dict:
    """skies/<kind>.py's `make(sky, device)`: RawScene.sky of a sky kind,
    its faces made on `device`."""
    faces, scales = _make("skies", sky, root, device)
    return dict(faces=faces, scales=scales)


def raw_scene(cfg: dict, device="cpu") -> RawScene:
    unknown = set(cfg) - KEYS
    if unknown:
        raise ValueError(f"configuration keys the benchmark does not know: {sorted(unknown)}")
    mesh, sky = cfg.get("mesh"), cfg.get("sky")
    return RawScene(
        width=int(cfg["width"]), height=int(cfg["height"]), use_gpu=bool(cfg["use_gpu"]),
        assured_depth=int(cfg["assured_depth"]), max_thres=float(cfg["max_thres"]),
        max_bounces=int(cfg["max_bounces"]), cam=cfg["cam"], spheres=cfg["spheres"],
        rad_info=dict(cfg.get("rad_info", {})),
        primitives=mesh_primitives(mesh) if mesh else [],
        sky=sky_faces(sky, device) if sky else None)
