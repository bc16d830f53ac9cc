"""Build the CUDA kernels of `csrc/` with nvcc and load them with ctypes.

Each kernel source `csrc/<name>.cu` has a plain C interface and is
compiled on first use into `_build/<name>-<hash>.so` inside the package
(listed in .gitignore), where the hash covers the source and the nvcc
flags, so an edit rebuilds and an unchanged tree reuses the library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <so> csrc/<name>.cu

No --use_fast_math: it implies flush-to-zero and approximate sinf, cosf
and division, and the kernels are held against their plain torch
versions. A failed build raises; nothing falls back to another path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    so = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, so)
    built = Built(path=so, log=log_path.read_text() if log_path.exists() else "",
                  seconds=seconds, lib=ctypes.CDLL(str(so)))
    _LOADED[name] = built
    return built
