"""Traffic: a closed loop with one client that refines images, read from
traffic/<name>.json: {"batch": B, "image_spp": N}. The client calls
`render(samples=B)` again and again on one warm Renderer; after N samples
the next image starts on a fresh target whose count, the image's first
sample id, is drawn from the seed, so each seed renders other samples of
the counter RNG; the scene, the batch and the image's length never
change. Where B = N each call renders a whole image, in the batches the
Renderer makes by default."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
START_RANGE = 1 << 30  # first sample ids; + the image's samples stays below 2**31


def load_traffic(name: str, root: Path = ROOT) -> dict:
    spec = json.loads((root / "traffic" / f"{name}.json").read_text())
    if spec["image_spp"] % spec["batch"]:
        raise ValueError(f"traffic {name}: batch {spec['batch']} does not divide image_spp")
    return spec


class Images:
    """The image starts of a run, drawn from its seed."""

    def __init__(self, spec: dict, seed: int):
        self.batch, self.image_spp = int(spec["batch"]), int(spec["image_spp"])
        self._rng = np.random.default_rng([seed, 0])

    def next_start(self) -> int:
        return int(self._rng.integers(0, START_RANGE))


def check_rows(height: int, n_rows: int, seed: int) -> np.ndarray:
    """n_rows image rows, one drawn from each of n_rows equal bands."""
    g = np.random.default_rng([seed, 1])
    edges = np.linspace(0, height, n_rows + 1).astype(np.int64)
    return np.array([int(g.integers(lo, hi)) for lo, hi in zip(edges[:-1], edges[1:])])


def row_pixels(rows, width: int):
    """(ys, xs) of every pixel of `rows`, row-major."""
    rows = np.asarray(rows, np.int64)
    return np.repeat(rows, width), np.tile(np.arange(width, dtype=np.int64), len(rows))


def check_pixels(width: int, height: int, spec: dict, seed: int):
    """(ys, xs) of the pixels a run checks, drawn from the seed: with
    {"rows": n} every pixel of n rows (check_rows); with {"pixels": n}
    n pixels, one from each of n equal bands of the row-major frame."""
    if "rows" in spec:
        return row_pixels(check_rows(height, int(spec["rows"]), seed), width)
    n = int(spec["pixels"])
    g = np.random.default_rng([seed, 1])
    edges = np.linspace(0, width * height, n + 1).astype(np.int64)
    flat = np.array([int(g.integers(lo, hi)) for lo, hi in zip(edges[:-1], edges[1:])])
    return flat // width, flat % width


def check_draws(seed: int):
    """The stream that picks the calls to check."""
    return np.random.default_rng([seed, 2])
