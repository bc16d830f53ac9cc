#!/usr/bin/env python3
"""bounce_shade with the sky, on the card: the biplane-cpu pool.

    python3 scripts/torch_bounce_sky.py [--against DIR]

Builds `raytrace_tpu_torch/csrc/bounce_kernel.cu` with kernels/build.py's
flags and, with --against, DIR's copy of it with the same flags, and
prints for each bounce_shade_kernel of each build its SASS instructions
(cuobjdump) and ptxas's registers, stack and spills. Then, on the
benchmark's biplane-cpu configuration at its published size (1200x600,
six 2048^2 faces; built through benchmark/system.py as the cell builds
it), the 131,072-lane pool as the render's 20th iteration finds it
(chip_smoke.bounce_state's pool): chip_smoke.bounce_parity (bounce_prims
and bounce_shade bitwise against their plain versions, kernel and plain
timed in turns); the sky-fetch counter of one bounce_shade launch against
shade_reference's and against the state's own count; and bounce_shade
timed in turns with the sky and its counter, with the sky and no
counter, and without the sky (the scene's cube map left out: no miss
record, no fetch), so that the sky's share of a launch and the counter's
cost show. With the card's name and power limit. Needs a CUDA card and
nvcc.
"""
import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "biplane-cpu"


def biplane_lanes(it):
    """The biplane-cpu Renderer's pool at its it-th iteration of a render's
    first batch (of chip_smoke.MESH_SPP samples), driven eagerly."""
    import chip_smoke as cs
    from benchmark import scenes
    from benchmark.system import System
    from raytrace_tpu_torch.render import wavefront as wf

    raw = scenes.raw_scene(scenes.load_config(CONFIG), "cuda")
    r = System(raw, "cuda").renderer
    assert r.driver == "wavefront" and r.pool == 1 << 17
    lanes = wf.Lanes(r.tables, r.params, r._xs, r._ys, cs.MESH_SPP, r.width, r.pool)
    lanes._start(0)
    for _ in range(it - 1):
        lanes._iteration()
    assert bool(lanes.flag), f"the render ended before iteration {it}"
    return lanes


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout, whose bounce_kernel.cu is compared")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from raytrace_tpu_torch.kernels import build
    from raytrace_tpu_torch.ops import bounce_kernel as bk
    from raytrace_tpu_torch.render import integrator as itg
    from raytrace_tpu_torch.render import wavefront as wf
    from torch_bounce_dls import build_against

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    builds = {"this": build.build("bounce_kernel")}
    if args.against:
        builds["against"] = build_against(
            os.path.join(args.against, "raytrace_tpu_torch", "csrc", "bounce_kernel.cu"))
    counts = cs.sass(builds) or {}
    for tag, built in builds.items():
        for fn, v in cs.ptxas_info(built.log).items():
            print(f"[ptxas] {tag} {fn}: {counts.get(tag, {}).get(fn, '?')} SASS instructions, "
                  f"{v}", flush=True)

    lanes = biplane_lanes(cs.CAPTURE_ITER)
    out = cs.bounce_parity("biplane cpu", lanes, card)
    print(f"[sky] biplane cpu: {out}", flush=True)

    scene, params, st = lanes.scene, lanes.params, lanes.st
    saved, slots0 = wf._clone(st), lanes.slots.clone()
    act = saved["active"]
    prims = bk.bounce_prims(scene, params, st["ro"], st["rd"], act)
    mesh = itg.mesh_of(scene, params, st["ro"], st["rd"], prims[5])
    # the counter: one launch against the plain version's and the state's own count
    got = {}
    for kind, fn in (("kernel", bk.bounce_shade), ("plain", bk.shade_reference)):
        work, slots = wf._clone(saved), slots0.clone()
        counter = torch.zeros((), dtype=torch.int64, device=act.device)
        fn(scene, params, work, prims, mesh, None, lanes.unit, slots, lanes.cap, counter)
        mw = work["miss_w"]
        own = int((act & ~work["active"] & ((mw[0] > 0) | (mw[1] > 0) | (mw[2] > 0))).sum())
        got[kind] = (int(counter), own)
    retiring = int((act & ~work["active"]).sum())
    print(f"[sky] counter on one launch ({int(act.sum())} live lanes, {retiring} retire): kernel "
          f"{got['kernel'][0]}, plain {got['plain'][0]}, the state's own count "
          f"{got['kernel'][1]} / {got['plain'][1]}", flush=True)
    assert got["kernel"][0] == got["plain"][0] == got["kernel"][1] > 0, got

    # with the sky (counter on, off) and without it, in turns
    work, slots = wf._clone(saved), slots0.clone()
    counter = torch.zeros((), dtype=torch.int64, device=act.device)

    def reset():
        for dst, src in zip(wf._leaves(work), wf._leaves(saved)):
            dst.copy_(src)
        slots.copy_(slots0)

    def shade(ctr):
        return lambda: bk.bounce_shade(scene, params, work, prims, mesh, None, lanes.unit, slots,
                                       lanes.cap, ctr)

    def none():  # the scene's cube map left out for the launch (SceneTensors is a Module,
        # whose shallow copy would share the submodule's slot)
        tables, scene.sky = scene.sky, None
        try:
            shade(None)()
        finally:
            scene.sky = tables

    sky, bare = shade(counter), shade(None)
    ms = cs.time_turns("bounce_shade biplane cpu: with the sky and its counter (sky), with the "
                       "sky and no counter (sky_uncounted), without the sky (no_sky)", card, [
                           ("no_sky", none), ("sky", sky), ("sky_uncounted", bare),
                           ("sky_uncounted", bare), ("sky", sky), ("no_sky", none)], reset)
    print(f"[sky] the sky's share of a launch {(ms['sky'] - ms['no_sky']) / ms['sky']:.4f}, the "
          f"counter's {(ms['sky'] - ms['sky_uncounted']) / ms['sky']:.4f} [{card}]", flush=True)


if __name__ == "__main__":
    main()
