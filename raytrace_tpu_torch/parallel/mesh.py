"""The (tile, spp) process mesh (the JAX package's parallel/mesh.py).

One process per device, as torchrun launches them: the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the world, its dims named
"tile" (pixel blocks) and "spp" (sample slices), row-major, so rank
tile_rank * spp + spp_rank. The steps of parallel/distributed.py read
its groups (`mesh.get_group("spp")`) and coordinates
(`mesh.get_local_rank("tile")`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _factor(n: int) -> tuple:
    """Split n devices into (tile, spp) as square-ish as possible with
    tile >= spp (pixel parallelism first: it is load-balanced). The JAX
    package's _factor (mesh.py:10-17), the same pair for every n."""
    best = (n, 1)
    for spp in range(1, int(np.sqrt(n)) + 1):
        if n % spp == 0:
            best = (n // spp, spp)
    return best


def make_mesh(tile: Optional[int] = None, spp: Optional[int] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A (tile, spp) DeviceMesh over the initialised world (the JAX
    make_mesh over all devices): both None, `_factor(world)`; one given,
    the other world // it; tile * spp must be the world size.
    device_type: "cuda" (the default) or "cpu"."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised (multihost.init)")
    n = dist.get_world_size()
    if tile is None and spp is None:
        tile, spp = _factor(n)
    elif tile is None:
        tile = n // spp
    elif spp is None:
        spp = n // tile
    if tile * spp != n:
        raise ValueError(f"mesh {tile}x{spp} != {n} processes")
    return init_device_mesh(device_type or "cuda", (tile, spp), mesh_dim_names=("tile", "spp"))
