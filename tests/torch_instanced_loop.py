"""The table-order loop of the instanced nearest hit, kept to hold the
batched `ops.mesh_kernel.mesh_hit_instanced` against (bitwise): the
instances of tables.inst one after another in table order, each walked for
the lanes whose world slab test reaches its AABB below the running best,
seeded with that best; a later instance replaces a hit only at a smaller t.
No JAX here: tests/test_torch_instancing.py and chip_smoke.py's phase 13
(on the card) both import it."""
import torch

from raytrace_tpu_torch.ops import mesh_kernel as mk
from raytrace_tpu_torch.ops.intersect import EPS


def mesh_hit_instanced_loop(o, d, t_seed, tables, t_min: float = EPS):
    """mesh_hit_instanced's function, walked instance by instance."""
    n, dev = t_seed.numel(), t_seed.device
    t_out = t_seed.clone()
    gid_out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u_out, v_out = torch.zeros_like(t_seed), torch.zeros_like(t_seed)
    entry, ok = mk._instance_spans(o, d, tables.inst)
    ok &= entry < t_seed[:, None]  # the running best only falls from the seed
    bases = tables.inst[:, 18].long().tolist()
    for k in (ok.any(0).nonzero()[:, 0]).tolist():  # the instances some ray may reach
        lane = (ok[:, k] & (entry[:, k] < t_out)).nonzero()[:, 0]
        if not lane.numel():
            continue
        ol, dl = mk._instance_rays(o, d, lane, tables.inst[k])
        t, gid, u, v = mk.mesh_hit_walk(ol, dl, t_out[lane], tables.asset, t_min=t_min)
        hit = gid >= 0
        won = lane[hit]
        t_out[won], gid_out[won] = t[hit], gid[hit] + bases[k]
        u_out[won], v_out[won] = u[hit], v[hit]
    return t_out, gid_out, u_out, v_out
