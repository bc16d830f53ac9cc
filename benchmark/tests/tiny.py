"""Sizes at which a test run holds the benchmark's cells on the CPU: the
same scenes and traffic kinds, cut to a few thousand pixels."""
from __future__ import annotations

MESH = {"kind": "displaced_sphere", "n_tris": 3000, "n_textures": 2, "tex_size": 64,
        "radius": 24.0, "seams": 60, "texture_seed": 1000, "rgb_factor": [0.7, 0.72, 0.75],
        "metal": 0.6, "rough": 0.35}
OVERRIDES = {
    "walled": {"config": {"width": 48, "height": 24}, "traffic": {"batch": 4, "image_spp": 4}},
    # a progressive preview (an image in more than one call) of walled
    "walled-preview": {"config": {"width": 48, "height": 24},
                       "traffic": {"batch": 2, "image_spp": 4}},
    "a380": {"config": {"width": 64, "height": 32, "mesh": MESH},
             "traffic": {"batch": 2, "image_spp": 2}},
}


def overrides(cell: str) -> dict:
    if cell in OVERRIDES:
        return OVERRIDES[cell]
    return OVERRIDES["walled" if cell.startswith("walled") else "a380"]
