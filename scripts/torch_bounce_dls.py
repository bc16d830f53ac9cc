#!/usr/bin/env python3
"""bounce_prims with every emitter's shadow rays in its launch, on the card.

    python3 scripts/torch_bounce_dls.py [--against DIR]

Builds `raytrace_tpu_torch/csrc/bounce_kernel.cu` with kernels/build.py's
flags and, with --against, DIR's copy of it with the same flags (into
`_build/against/`), and prints for each bounce_prims_kernel of each build
its SASS instructions (cuobjdump) and ptxas's registers, stack and spills.
Then, on walled 1200x600 in cpu semantics with direct-light sampling (two
emitters), the 131,072-lane pool as the render's 20th iteration finds it
(chip_smoke.bounce_state): chip_smoke.bounce_parity, which holds the
launch with the shadow rays bitwise against prims_reference and
shadow_reference and times it in turns against the own rays' launch and
one launch an emitter; with --against, also the fused launch in turns
against DIR's library's three launches (its own-ray launch and one
shadow launch an emitter: the argument struct is the same). With the
card's name and power limit. Needs a CUDA card and nvcc.
"""
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_against(src):
    """DIR's bounce_kernel.cu built with the package's flags."""
    import ctypes

    from raytrace_tpu_torch.kernels import build

    out = build.BUILD_DIR / "against"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "bounce_kernel_against.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *build.EXTRA_FLAGS["bounce_kernel"],
           "-o", str(so), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {src}:\n{proc.stdout}{proc.stderr}")
    return build.Built(path=so, log=proc.stdout + proc.stderr, seconds=time.perf_counter() - t0,
                       lib=ctypes.CDLL(str(so)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout, whose bounce_kernel.cu is compared")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from raytrace_tpu_torch.kernels import build
    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.ops import bounce_kernel as bk

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
        info = cs.ptxas_info(built.log)
        for fn, v in info.items():
            if "bounce_prims" in fn:
                print(f"[prims] {tag} {fn}: {counts.get(tag, {}).get(fn, '?')} SASS "
                      f"instructions, {v}", flush=True)

    walled = cs.variant(walled_scheme(cs.W, cs.H), use_gpu=False, dir_light_samp=True)
    lanes = cs.bounce_state(walled)
    out = cs.bounce_parity("walled cpu DLS", lanes, card)
    print(f"[prims] walled cpu DLS: {out['bounce_prims']}", flush=True)
    if args.against:
        scene, params, st = lanes.scene, lanes.params, lanes.st
        act = st["active"]
        emitters, flags, _ = lanes.shadow
        fused = (st["dls"], emitters, torch.ones_like(flags))

        def against():  # DIR's library: its own-ray launch, then one an emitter
            this, build._LOADED["bounce_kernel"] = build._LOADED["bounce_kernel"], builds["against"]
            try:
                hit = bk.bounce_prims(scene, params, st["ro"], st["rd"], act)
                for j in range(len(scene.emitters)):
                    bk.shadow_prims(scene, params, st["dls"], hit, None, j, flags[j])
            finally:
                build._LOADED["bounce_kernel"] = this

        one = lambda: bk.bounce_prims(scene, params, st["ro"], st["rd"], act, shadow=fused)
        ms = cs.time_turns("bounce_prims walled cpu DLS, against DIR's three launches", card, [
            ("against", against), ("fused", one), ("fused", one), ("against", against)])
        print(f"[prims] fused / against: {ms['fused'] / ms['against']:.4f} [{card}]", flush=True)


if __name__ == "__main__":
    main()
