"""The walled scheme, built inline: the reference's headline benchmark
scene (schemes/walled.yml: 13 spheres, gpu semantics, no cube map).

The same members and camera as `__graft_entry__._inline_walled_scheme`,
built through this package's own schema so that no asset file and no
YAML parser is needed.
"""
from __future__ import annotations

from .config import Scheme, Tagged, parse_scheme


def walled_scheme(width: int = 1200, height: int = 600, assured: int = 5) -> Scheme:
    def sphere(c, r, rgb, mat):
        return Tagged("Sphere", {"c": c, "r": r, "coloring": Tagged("Solid", rgb), "mat": mat})

    diel = {"divert_ray": Tagged("Dielectric", {"n_out": 1.0, "n_in": 1.3})}
    members = [
        sphere([1.0, -5, -20.0], 4.0, [0.6, 0.0, 0.8], {"divert_ray": "Diff"}),
        sphere([-3.0, 0.0, -6.0], 1.0, [1, 1, 1], {"divert_ray": "Spec"}),
        sphere([1.0, -1.5, -6.0], 0.5, [0.2, 1.0, 0.5],
               {"divert_ray": Tagged("DiffSpec", {"diffp": 0.7})}),
        sphere([-10.0, -7.0, -20.0], 2.0, [1, 1, 1], diel),
        sphere([10.0, -7.0, -21.0], 2.0, [1, 1, 1], diel),
        sphere([-2.0, 1.5, -6.0], 0.5, [0.7, 0.7, 1.0], diel),
        sphere([2.0, 1.5, -6.0], 0.5, [1.0, 0.5, 0.7], diel),
        sphere([0.0, 10.0, -15.0], 5.0, [0, 0, 0], {"divert_ray": "Diff", "emissive": [5, 5, 5]}),
        sphere([1.0, 1.0, -7.0], 0.4, [1, 1, 1], {"divert_ray": "Spec", "emissive": [15, 15, 15]}),
        sphere([515.0, 0.0, -10.0], 500.0, [0.25, 0.25, 0.75], {"divert_ray": "Diff"}),
        sphere([-515.0, 0.0, -10.0], 500.0, [0.75, 0.25, 0.25], {"divert_ray": "Diff"}),
        sphere([0.0, -510.0, -10.0], 500.0, [0.75, 0.75, 0.75], {"divert_ray": "Diff"}),
        sphere([0.0, 0.0, -530.0], 500.0, [0.75, 0.75, 0.75], {"divert_ray": "Diff"}),
    ]
    raw = {
        "render_info": {
            "width": width, "height": height, "samps_per_pix": 4,
            "rad_info": {
                "debug_single_ray": False, "dir_light_samp": False,
                "russ_roull_info": {"assured_depth": assured, "max_thres": 0.5},
            },
            "use_gpu": True,
        },
        "cam": {
            "d": [0, 0, -5.0], "o": [0, -1, 0], "up": [0, 1, 0],
            "view_eulers": [0, 0, 0],
            "screen_width": 10.0, "screen_height": 5.0,
        },
        "scene_members": members,
    }
    return parse_scheme(raw)
