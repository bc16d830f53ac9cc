"""Sky kind "grid_faces": six seeded u8 faces of `size`^2 texels, made on
the device in a few large calls: face i of FACE_ORDER is its hue times a
gradient along u and v, a dark line every GRID texels, and noise of up
to 23 a channel from a torch.Generator seeded with `seed`, so that a
wrong face or texel shows. `scales` maps a face's name to its
(u_scale, v_scale); a face it leaves out has (1, 1)."""
from __future__ import annotations

import torch

FACE_ORDER = ("neg_z", "pos_z", "neg_x", "pos_x", "neg_y", "pos_y")  # the upstream's face ids 0-5
HUES = ((255, 96, 64), (64, 160, 255), (96, 255, 96), (255, 224, 64), (160, 96, 255),
        (64, 255, 224))
GRID = 64
NOISE = 24  # noise draws 0 .. NOISE - 1


def make(sky: dict, device):
    """(faces, scales): the six faces in FACE_ORDER as one (6, size, size,
    3) u8 tensor on the host, row 0 of a face its first texel row (v = 0),
    made face by face on `device`; and each face's (u_scale, v_scale)."""
    size, seed = int(sky["size"]), int(sky["seed"])
    scales = {k: tuple(float(s) for s in v) for k, v in sky.get("scales", {}).items()}
    unknown = set(scales) - set(FACE_ORDER)
    if unknown:
        raise ValueError(f"sky scales of no face: {sorted(unknown)}")
    g = torch.Generator(device=device).manual_seed(seed)
    ramp = torch.arange(size, device=device)
    t = ramp.to(torch.float32) / max(size - 1, 1)
    grad = (0.25 + 0.5 * t)[None, :] + (0.25 * t)[:, None]
    line = ramp % GRID == 0
    faces = torch.empty((6, size, size, 3), dtype=torch.uint8)
    for i, hue in enumerate(HUES):
        base = torch.floor(grad[..., None] * torch.tensor(hue, dtype=torch.float32, device=device))
        base[line] = 16.0
        base[:, line] = 16.0
        noise = torch.randint(0, NOISE, (size, size, 3), generator=g, device=device,
                              dtype=torch.uint8)
        faces[i] = (base + noise).clamp_(max=255.0).to(torch.uint8).cpu()
    return faces, [scales.get(name, (1.0, 1.0)) for name in FACE_ORDER]
