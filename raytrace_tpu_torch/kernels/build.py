"""Build the CUDA kernels of `csrc/` with nvcc and load them with ctypes.

Each kernel source `csrc/<name>.cu` has a plain C interface and is
compiled on first use into `_build/<name>-<hash>.so` inside the package
(listed in .gitignore), where the hash covers the source, the shared
headers `csrc/*.cuh` and the nvcc flags, so an edit rebuilds and an
unchanged tree reuses the library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <so> csrc/<name>.cu

No --use_fast_math: it implies flush-to-zero and approximate sinf, cosf
and division, and the kernels are held against their plain torch
versions. The mesh kernel is also built with -fmad=false: torch rounds
every multiply and add of the plain version on its own, and a
contracted FMA moves barycentrics by ulps, which on the a380-class
surface (random texture coordinates per vertex) picks another texel on
1.2% of the full frame's paths at one sample per lane and 3.9% at four
(H100 80GB HBM3, 700 W), over the 1% kernel-vs-plain gate. Without
contraction it equals its plain version bitwise, at 8% (walk) and 9%
(brute) more time per 1216x608 launch of 16 samples per lane. The
bounce kernel (the integrator's bounce for the wavefront) builds with
-fmad=false too: it is held bitwise against the integrator's torch
pieces, whose sums and products round one by one.
trace_kernel keeps contraction: it passes the gate with it (0.44% of
lanes at worst), and without it its walled launch takes 14% longer.
A failed build raises; nothing falls back to another path. Processes
that build at once (the ranks of a torchrun job) take turns under a file
lock, `_build/<name>.lock`, so the first runs nvcc and the others load
its library.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

from ..utils import profiling

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
EXTRA_FLAGS = {"mesh_kernel": ["-fmad=false"], "bounce_kernel": ["-fmad=false"]}  # the docstring


@dataclass
class Built:
    path: Path
    log: str  # nvcc's output, with ptxas's registers / smem / spills
    seconds: float  # build time; 0.0 when the cached library was reused
    lib: ctypes.CDLL


_LOADED: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be built")


def build(name: str) -> Built:
    """Compile csrc/<name>.cu (cached by content) and load it."""
    if name in _LOADED:
        return _LOADED[name]
    with profiling.span("kernels.build", name=name):
        return _build(name)


def _build(name: str) -> Built:
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, [])
    h = hashlib.sha256(" ".join(flags).encode())
    for part in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(part.read_bytes())
    so = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if not so.exists():  # another process may have built it meanwhile
                seconds = _nvcc(name, flags, src, so, log_path)
    built = Built(path=so, log=log_path.read_text() if log_path.exists() else "",
                  seconds=seconds, lib=ctypes.CDLL(str(so)))
    _LOADED[name] = built
    return built


def _nvcc(name: str, flags: list, src: Path, so: Path, log_path: Path) -> float:
    """Compile src into so (through a temporary file: a library is never
    seen half written) and write nvcc's log; returns the seconds taken."""
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, so)
    return seconds
