#!/usr/bin/env python3
"""SASS instructions and registers of the port's mesh kernels, here and in another checkout.

    python3 scripts/torch_mesh_sass.py [--against DIR]

Builds `raytrace_tpu_torch/csrc/mesh_kernel.cu` with kernels/build.py's
flags and, with --against, DIR's copy of it with the same flags (into
`_build/against/`), both at once, and prints for every kernel of the file
its SASS instructions (cuobjdump) and ptxas's registers side by side:
each `mesh_trace_kernel` instantiation by its template arguments (kBrute,
kInst, kSky, kPcg; a source without kInst counts as kInst false), the
yardsticks and `mesh_hit_kernel`. A template argument added to a kernel
keeps its other instantiations' code when their counts and registers do
not move. Needs nvcc and cuobjdump (the H100 machine); prints no result
without them.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = re.compile(r"\d+(mesh_trace_kernel|mesh_trace_yardstick_kernel|mesh_hit_kernel|"
                    r"mesh_hit_per_thread_kernel)(?:I((?:Lb[01]E)+)E)?")


def label(mangled):
    """A kernel's readable name: mesh_trace_kernel<brute, inst, sky, pcg> by
    its template arguments (kInst false where the source has none)."""
    m = KERNEL.search(mangled)
    if not m:
        return mangled
    args = [int(b) for b in re.findall(r"Lb([01])E", m.group(2) or "")]
    if m.group(1) == "mesh_trace_kernel":
        if len(args) == 3:  # kBrute, kSky, kPcg: before kInst
            args.insert(1, 0)
        names = ("brute", "inst", "sky", "pcg")
        return "mesh_trace_kernel<" + ", ".join(f"{n}={a}" for n, a in zip(names, args)) + ">"
    return m.group(1) + (f"<{', '.join(map(str, args))}>" if args else "")


def build_source(src, tag):
    """src (a mesh_kernel.cu beside its headers) built with the package's
    flags into _build/against/mesh_kernel_<tag>.so."""
    from raytrace_tpu_torch.kernels import build

    out = build.BUILD_DIR / "against"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"mesh_kernel_{tag}.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *build.EXTRA_FLAGS["mesh_kernel"],
           "-o", str(so), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {src}:\n{proc.stdout}{proc.stderr}")
    return build.Built(path=so, log=proc.stdout + proc.stderr, seconds=time.perf_counter() - t0,
                       lib=ctypes.CDLL(str(so)))


def counts(builds):
    """{tag: {label: (SASS instructions, registers)}} of {tag: Built}."""
    import chip_smoke

    sass = chip_smoke.sass(builds, os.path.join(chip_smoke.SASS_DIR, "against")) or {}
    out = {}
    for tag, built in builds.items():
        regs = chip_smoke.ptxas_registers(built.log)
        out[tag] = {label(fn): (n, regs.get(fn)) for fn, n in sass.get(tag, {}).items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None, help="another checkout's root")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from raytrace_tpu_torch.kernels import build

    try:
        build.nvcc_path()
    except RuntimeError as e:
        print(f"torch_mesh_sass: {e}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[:1]
    print(card[0] if card else "no nvidia-smi", flush=True)
    jobs = {"here": lambda: build.build("mesh_kernel")}
    if args.against:
        other = os.path.join(os.path.abspath(args.against), "raytrace_tpu_torch", "csrc",
                             "mesh_kernel.cu")
        jobs["against"] = lambda: build_source(other, "against")
    with ThreadPoolExecutor(len(jobs)) as pool:
        builds = dict(zip(jobs, pool.map(lambda f: f(), jobs.values())))
    table = counts(builds)
    if not table.get("here"):
        print("torch_mesh_sass: no SASS (cuobjdump missing?)", file=sys.stderr)
        return 1
    names = sorted(set().union(*(t.keys() for t in table.values())))
    for name in names:
        cols = "; ".join(f"{tag} " + (f"{table[tag][name][0]} SASS, {table[tag][name][1]} registers"
                                      if name in table[tag] else "absent") for tag in table)
        print(f"[sass] {name}: {cols}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
