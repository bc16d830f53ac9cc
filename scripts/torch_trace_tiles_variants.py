#!/usr/bin/env python3
"""Block size and the branch-free math of the port's `trace_tiles` CUDA entry, measured on the card.

    python3 scripts/torch_trace_tiles_variants.py [--committed-only] [--parity] [--sass-dir DIR]

`raytrace_tpu_torch/csrc/trace_kernel.cu` keeps its launch shape in
`kTraceThreads` (threads a block) and `kTraceBlocks` (resident blocks a
SM, the `__launch_bounds__` minimum, so the register cap), and builds
`sqrtf` / `sincosf` into the bounce in place of their branch-free copies
`sqrt_rn` / `sincos_rn` when `kSqrtRn` / `kSinCosRn` are 0. This script
builds copies of the source with other values (VARIANTS, all at once, like
kernels/build.py into `_build/variants/`), prints ptxas's registers, stack
and spills for every kernel of every build, writes each build's SASS
(`cuobjdump -sass`) to `raytrace_tpu_torch/_build/sass/` (or DIR) with
its instruction count per kernel, holds each copy's 9 outputs bitwise
against the committed kernel's on the walled 1200x600 frame at 64
samples per lane (the main path's launch; for the `sqrtf` / `sincosf`
copies this checks that the branch-free copies are exact), and times with
CUDA events, in turns: the
committed `trace_tiles`, its first design `trace_tiles_per_thread` and the
copies (committed, per-thread, copies, copies reversed, per-thread,
committed). It samples the SM clock and power with nvidia-smi while the
committed kernel runs, and prints the card's name and power limit beside
every time. It also holds the branch-free math against the CUDA math
library exhaustively, on the card: `sqrt_rn` against `sqrtf` on every
finite float x > 0, and `sincos_rn` against `sincosf` on every float in
[0, 105615) (the range its comment claims; the bounce takes [0, 2 pi]),
bit for bit, in a build that includes trace_kernel.cu (MATH_CHECK).
--committed-only measures the committed build alone (no copies);
--parity first runs chip_smoke.py's phase 3 (both entries against the
plain version under the lane gate, the plain version's per-lane counts,
the timing in turns). Needs a CUDA card and nvcc; prints no result
without them.
"""
import ctypes
import os
import re
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPL = 1200, 600, 64
VARIANTS = {  # tag -> the constants it sets
    "sqrtf": {"kSqrtRn": 0},
    "sincosf": {"kSinCosRn": 0},
    "threads256_blocks4": {"kTraceThreads": 256, "kTraceBlocks": 4},
    "threads64_blocks16": {"kTraceThreads": 64, "kTraceBlocks": 16},
}
REPS = 5  # launches per turn, after a warm-up
ENTRIES = ("trace_tiles", "trace_tiles_per_thread")
# (name, first bits, end bits) of each exhaustive check: every finite
# float x > 0, and every float in [0, 105615.0f)
MATH_RANGES = (("sqrt_rn", 0x00000001, 0x7F800000), ("sincos_rn", 0x00000000, 0x47CE4780))
MATH_CHECK = r"""
#include "trace_kernel.cu"

namespace {
// which 0: sqrt_rn(x) against sqrtf(x); 1: sincos_rn(x) against sincosf(x);
// x over the float bit patterns [lo, hi)
__global__ void math_check_kernel(int which, uint32_t lo, uint32_t hi,
                                  unsigned long long* bad, unsigned int* first) {
  unsigned long long n = 0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = lo + static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < hi;
       i += stride) {
    const float x = __uint_as_float(static_cast<uint32_t>(i));
    bool same;
    if (which == 0) {
      same = __float_as_uint(sqrt_rn(x)) == __float_as_uint(sqrtf(x));
    } else {
      float s0, c0, s1, c1;
      sincos_rn(x, s0, c0);
      sincosf(x, &s1, &c1);
      same = __float_as_uint(s0) == __float_as_uint(s1) &&
             __float_as_uint(c0) == __float_as_uint(c1);
    }
    if (!same) {
      ++n;
      atomicMin(first, static_cast<unsigned int>(i));
    }
  }
  if (n) atomicAdd(bad, n);
}
}  // namespace

extern "C" int trace_math_check(int which, uint32_t lo, uint32_t hi, unsigned long long* bad,
                                unsigned int* first) {
  math_check_kernel<<<132 * 16, 256>>>(which, lo, hi, bad, first);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def build_variant(values, tag):
    """trace_kernel.cu with each `constexpr int` of `values` ({name: value})
    set, built like kernels/build.py into _build/variants/trace_kernel_<tag>.so."""
    from raytrace_tpu_torch.kernels import build

    src = (build.CSRC / "trace_kernel.cu").read_text()
    for name, value in values.items():
        line = re.compile(rf"constexpr int {name} = \d+;")
        if len(line.findall(src)) != 1:
            raise RuntimeError(f"trace_kernel.cu does not define {name} once")
        src = line.sub(f"constexpr int {name} = {value};", src)
    return build_source(src, tag)


def build_source(src, tag):
    """A CUDA source built like kernels/build.py (trace_kernel.cu's flags,
    csrc/ on the include path) into _build/variants/trace_kernel_<tag>.so."""
    from raytrace_tpu_torch.kernels import build

    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"trace_kernel_{tag}.cu", out / f"trace_kernel_{tag}.so"
    cu.write_text(src)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *build.EXTRA_FLAGS.get("trace_kernel", []),
           "-I", str(build.CSRC), "-o", str(so), str(cu)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {tag}:\n{proc.stdout}{proc.stderr}")
    return build.Built(path=so, log=proc.stdout + proc.stderr, seconds=time.perf_counter() - t0,
                       lib=ctypes.CDLL(str(so)))


def print_ptxas(builds):
    """ptxas's lines of each build ({tag: Built}): registers, stack, spills."""
    for tag, built in builds.items():
        for line in built.log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling")):
                print(f"[build] {tag} {line.strip()}", flush=True)


def clocks_while(fn):
    """Runs fn() while nvidia-smi samples the SM clock, power draw and
    temperature every 100 ms; returns (fn's result, the samples)."""
    q = "clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"
    proc = subprocess.Popen(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader,nounits",
                             "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        res = fn()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=10)
    rows = [[float(v) for v in line.split(",")] for line in out.strip().splitlines()
            if line.count(",") == 4 and "N/A" not in line]
    return res, rows


def math_check(lib, card):
    """The exhaustive checks of MATH_RANGES with the build of MATH_CHECK;
    each must find no float on which the two differ."""
    import torch

    fn = lib.trace_math_check
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
                   ctypes.c_void_p]
    for which, (name, lo, hi) in enumerate(MATH_RANGES):
        bad = torch.zeros(1, dtype=torch.int64, device="cuda")
        first = torch.full((1,), -1, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = fn(which, lo, hi, bad.data_ptr(), first.data_ptr())
        dt = time.perf_counter() - t0
        assert rc == 0, f"the {name} check failed: CUDA error {rc}"
        n, at = int(bad.item()), int(first.item()) & 0xFFFFFFFF
        x = struct.unpack("<f", struct.pack("<I", at))[0] if n else None
        print(f"[math] {name} against the CUDA math library on the {hi - lo} floats of bits "
              f"[{lo:#010x}, {hi:#010x}): {n} differ" + (f", the first at x = {x!r}" if n else "")
              + f" ({dt:.3f} s) [{card}]", flush=True)
        assert n == 0, f"{name} differs from the CUDA math library on {n} floats"


def walled_case(dev):
    """The walled 1200x600 tables and lanes on the card."""
    import torch

    from raytrace_tpu_torch.models.camera import build_camera
    from raytrace_tpu_torch.models.scene import build_scene
    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.ops import trace_kernel as tk

    s = walled_scheme(W, H)
    tables = tk.SceneTables(build_scene(s), build_camera(s.cam, W, H), 0.5).to(dev)
    flat = torch.arange(W * H, dtype=torch.int32, device=dev)
    xs, ys = flat % W, flat // W
    return tables, xs, ys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_trace_tiles_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from raytrace_tpu_torch.kernels import build
    from raytrace_tpu_torch.ops import trace_kernel as tk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    variants = {} if "--committed-only" in sys.argv[1:] else VARIANTS
    with ThreadPoolExecutor(len(variants) + 2) as pool:
        committed = pool.submit(build.build, "trace_kernel")
        checker = pool.submit(build_source, MATH_CHECK, "math_check")
        copies = dict(zip(variants, pool.map(lambda kv: build_variant(kv[1], kv[0]),
                                             variants.items())))
        builds = {"committed": committed.result(), **copies}
    print_ptxas(builds)
    import chip_smoke

    args = sys.argv[1:]
    chip_smoke.sass(builds, args[args.index("--sass-dir") + 1] if "--sass-dir" in args
                    else chip_smoke.SASS_DIR)
    math_check(checker.result().lib, card)
    if "--parity" in args:
        chip_smoke.trace_phase(dev, card)

    tables, xs, ys = walled_case(dev)
    loaded = build._LOADED["trace_kernel"]
    entries = list(ENTRIES)

    def launch(key):
        """One launch at SPL samples per lane: key an entry of the committed
        build, or a variant's tag (its trace_tiles)."""
        build._LOADED["trace_kernel"] = copies.get(key, loaded)
        fn = tk._trace_tiles_per_thread if key == "trace_tiles_per_thread" else tk.trace_tiles
        try:
            return fn(xs, ys, torch.zeros_like(xs), tables.sph, tables.ft, tables.cam_vec,
                      n_sph=tables.n_sph, n_ft=tables.n_ft, has_lens=tables.has_lens, assured=5,
                      max_bounces=24, samples_per_lane=SPL)
        finally:
            build._LOADED["trace_kernel"] = loaded

    ref = torch.stack(launch(entries[0]))
    for key in [*entries[1:], *copies]:
        diff = int((torch.stack(launch(key)) != ref).any(0).sum())
        print(f"[variants] {key}: {diff} lanes differ from the committed trace_tiles", flush=True)
        if key in copies:
            assert diff == 0, f"{key}: {diff} lanes differ"

    def timed(key):
        launch(key)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            launch(key)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    keys = [*entries, *copies]
    t = {}
    for key in keys + keys[::-1]:
        t.setdefault(key, []).append(timed(key))
    for key, v in t.items():
        ms = sum(v) / len(v)
        turns = ", ".join(f"{x:.3f}" for x in v)
        print(f"[variants] {key} walled {W}x{H} spl={SPL}: {ms:.3f} ms per launch (turns "
              f"{turns}), {W * H * SPL / ms / 1e6:.3f} Gpaths/s [{card}]", flush=True)

    def load():
        for _ in range(300):
            launch(entries[0])
        torch.cuda.synchronize()

    _, rows = clocks_while(load)
    if rows:
        busy = rows[len(rows) // 4:]  # past the ramp
        mean = [sum(r[k] for r in busy) / len(busy) for k in range(5)]
        print(f"[clocks] {entries[0]} under load, {len(busy)} samples: SM clock mean "
              f"{mean[0]:.0f} MHz (min {min(r[0] for r in busy):.0f}, max "
              f"{max(r[0] for r in busy):.0f}; the card's max {mean[1]:.0f}), power "
              f"{mean[2]:.0f} W of {mean[3]:.0f} W, {mean[4]:.0f} C [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
