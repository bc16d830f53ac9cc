"""The system under test: the one module of the benchmark that imports
the program (raytrace_tpu_torch). It turns the raw scene into the
program's scheme, builds the program's scene (build_scene), and hands the
scene to a Renderer; everything else the harness reads from the program
(the render's mean image, `Renderer.stats`, kernel names in the trace)
goes through the objects made here, as do the seconds its kernels'
build took."""
from __future__ import annotations

import time

import numpy as np


def _mat(mat: dict) -> dict:
    from raytrace_tpu_torch.models.config import Tagged

    out = dict(mat)
    dr = mat.get("divert_ray", "Spec")
    if not isinstance(dr, str):
        (tag, val), = dr.items()
        out["divert_ray"] = Tagged(tag, val)
    return out


def scheme_of(raw):
    """RawScene -> the program's Scheme (its spheres parsed as the YAML
    loader parses them, its mesh as one in-memory model)."""
    from raytrace_tpu_torch.models.config import ModelMember, Tagged, parse_scheme
    from raytrace_tpu_torch.models.gltf import LoadedMesh, Primitive, TextureData

    members = [Tagged("Sphere", {"c": s["c"], "r": s["r"], "coloring": Tagged("Solid", s["rgb"]),
                                 "mat": _mat(s.get("mat", {}))}) for s in raw.spheres]
    scheme = parse_scheme({
        "render_info": {
            "width": raw.width, "height": raw.height, "samps_per_pix": 1, "use_gpu": raw.use_gpu,
            "rad_info": {"debug_single_ray": False, "dir_light_samp": False, **raw.rad_info,
                         "russ_roull_info": {"assured_depth": raw.assured_depth,
                                             "max_thres": raw.max_thres}}},
        "cam": raw.cam, "scene_members": members})
    if raw.primitives:
        prims = [Primitive(
            poses=p["poses"], norms=p["norms"], indices=p["indices"], rgb_factor=p["rgb_factor"],
            rgb_tex=None if p["texture"] is None else TextureData(
                pixels=p["texture"].astype(np.float32) / 255.0, coords=p["coords"],
                pixels_raw=p["texture"]),
            metal_factor=p["metal"], rough_factor=p["rough"]) for p in raw.primitives]
        scheme.scene_members.append(ModelMember(
            path="<benchmark mesh>", loaded=[LoadedMesh(primitives=prims,
                                                        trans_mat=np.eye(4, dtype=np.float32))]))
    return scheme


class System:
    """A warm Renderer over the raw scene. `build_s`: the host seconds of
    the scene's build and the Renderer's construction (its tables'
    upload)."""

    def __init__(self, raw, device: str):
        import torch
        from raytrace_tpu_torch.models.scene import build_scene
        from raytrace_tpu_torch.render.renderer import Renderer

        scheme = scheme_of(raw)
        t0 = time.perf_counter()
        scene = build_scene(scheme)
        self.renderer = Renderer(scheme, device=device, scene=scene)
        if self.renderer.device.type == "cuda":
            torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0
        self.driver = self.renderer.driver

    def new_image(self, start: int):
        """A fresh target whose count is `start`, as a resumed render's."""
        from raytrace_tpu_torch.render.target import RenderTarget

        target = RenderTarget(self.renderer.width, self.renderer.height)
        target.count = start
        self.renderer.target = target

    @property
    def count(self) -> int:
        return self.renderer.target.count

    def render(self, samples: int) -> np.ndarray:
        return self.renderer.render(samples=samples, progress=False)

    @staticmethod
    def nvcc_s() -> float:
        """Seconds this process spent building the program's kernels with
        nvcc (0.0 where each library was in the checkout's build cache)."""
        from raytrace_tpu_torch.kernels import build

        return float(sum(b.seconds for b in build._LOADED.values()))

    def iterations(self) -> int:
        return int(self.renderer.stats["iterations"])
