"""Process-group initialisation from torchrun's environment, and the
pod mesh (the JAX package's parallel/multihost.py).

The JAX design is one controller per host, wired by jax.distributed; here
it is one process per device, as `torchrun --nproc-per-node N` starts
them, each reading RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and
MASTER_ADDR / MASTER_PORT from its environment. Ranks are contiguous per
node, so make_pod_mesh's spp axis, the fastest-varying, stays within a
node and the radiance all-reduce off the network between nodes.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import make_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init(backend: Optional[str] = None, device: str = "cuda") -> bool:
    """Initialise the default process group from torchrun's environment.
    Without WORLD_SIZE in the environment it initialises nothing and
    returns False (the JAX init without a coordinator, multihost.py:28-29).
    Otherwise the backend is `backend` when given, else "nccl" for
    device "cuda" and "gloo" for "cpu" (nothing tries one and then
    another); on "cuda" the process's device is cuda:(LOCAL_RANK mod the
    visible device count). Returns True. A process group already
    initialised is left as it is (False: this call initialised nothing).
    NCCL takes no two ranks on one card: with NCCL and more local ranks
    (LOCAL_WORLD_SIZE) than visible cards it raises ValueError before
    anything is initialised, and leaves the choice of gloo to the caller."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    if device not in BACKENDS:
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    backend = backend or BACKENDS[device]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for but torch.cuda.is_available() is False")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        if backend == "nccl" and local > torch.cuda.device_count():
            raise ValueError(
                f"NCCL takes one rank a card: {local} local ranks (LOCAL_WORLD_SIZE) on "
                f"{torch.cuda.device_count()} visible CUDA devices; gloo takes two ranks on one "
                f"card (backend='gloo', the CLI's --backend gloo)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
        torch.cuda.init()
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def make_pod_mesh(spp: Optional[int] = None, device_type: Optional[str] = None):
    """(tile, spp) mesh over the world with the spp axis within a node:
    spp defaults to the largest of 2, 4, 8 that divides LOCAL_WORLD_SIZE
    (the processes of this node; 1 when none does)."""
    if spp is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        spp = 1
        for cand in (2, 4, 8):
            if local % cand == 0:
                spp = cand
    return make_mesh(spp=spp, device_type=device_type)
