"""CLI entry — the reference's main.rs analogue, for schemes of spheres,
free triangles, `!Model` glTF meshes and the `!DistantCubeMap` sky (face
paths resolved against the scheme's directory), static or animated.

    python -m raytrace_tpu_torch.cli <scheme.yml> [no_ui] --device cuda \
        [--mode gpu|cpu] [--generator weyl|pcg] --samples N --out render_out.png \
        [--checkpoint ck.npz] [--resume ck.npz] [--preview PORT] [--backend nccl|gloo] \
        [--spans spans.json]

A static scheme renders to a PNG, rewritten (with the checkpoint, when
asked) after every sample batch, as the reference's no-ui output loop
(ui_util.rs:37-54); `--preview PORT` serves the image as it accumulates
on http://127.0.0.1:PORT/ (the reference's live window,
ui_util.rs:56-168; utils/preview.py). An animation scheme
(`animation: true`) renders its frames to ./anim_frames/<i>.png, the
scene of frame k+1 built on a builder thread while frame k renders
(renderer.rs:114-167's producer / consumer, up to `anim_pipeline_depth`
frames ahead), then encodes them to animation.mp4 (utils/video.py's
ladder; an MJPEG-AVI beside it when no mp4 encoder is there).
`--generator` picks the counter RNG's family (the JAX package's RTPU_RNG).
`--spans PATH` switches on the span recorder (utils/profiling.py) and
writes its spans and counters to PATH at the end, on time.time_ns's
scale, so they lie over a torch.profiler trace of the same process.

Under torchrun (`torchrun --nproc-per-node N -m raytrace_tpu_torch.cli
scheme.yml no_ui`) every rank joins the process group first
(parallel/multihost.init: NCCL on the card, gloo with `--device cpu`;
`--backend gloo` puts more ranks than cards on the cards, which NCCL
refuses) and renders with the world group, each rank its slice of every batch's
sample ids; every rank reads `--resume`, and rank 0 alone writes the
PNG, the checkpoint, the preview, the animation frames and the video.
Without torchrun's environment nothing of this happens.
"""
from __future__ import annotations

import argparse
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from .ops.rng import GENERATORS
from .parallel import multihost
from .utils import profiling

ANIM_DIR = "./anim_frames"  # the reference's frame directory (main.rs:51)


def main(argv=None):
    ap = argparse.ArgumentParser(description="path tracer (PyTorch / CUDA)")
    ap.add_argument("scheme", help="scheme YAML path")
    ap.add_argument("no_ui", nargs="?", default=None, help="compat positional (no window in this build)")
    ap.add_argument("--device", default="cuda", help="cuda (the CUDA kernels) or cpu (plain torch)")
    ap.add_argument("--mode", choices=("gpu", "cpu"), default=None,
                    help="the reference backend's semantics to reproduce (default: the "
                         "scheme's use_gpu)")
    ap.add_argument("--generator", choices=GENERATORS, default="weyl",
                    help="the counter RNG's family: weyl, or the reference's pcg")
    ap.add_argument("--out", default="render_out.png")
    ap.add_argument("--samples", type=int, default=None, help="override samps_per_pix")
    ap.add_argument("--scale", type=int, default=1, help="divide width/height by this (smoke runs)")
    ap.add_argument("--checkpoint", default=None, help="save resume state here after each batch")
    ap.add_argument("--resume", default=None, help="resume from a checkpoint file")
    ap.add_argument("--preview", type=int, default=None, metavar="PORT",
                    help="serve a live browser preview on 127.0.0.1:PORT (0: a free port)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="torch.distributed backend under torchrun (default: nccl on cuda, gloo "
                         "on cpu; NCCL takes one rank a card, gloo more)")
    ap.add_argument("--spans", default=None, metavar="PATH",
                    help="record the program's spans and counters and write them to PATH at the "
                         "end, as Chrome trace events (under torchrun one file a rank: "
                         "PATH with .rank<r> before its suffix)")
    args = ap.parse_args(argv)
    joined = multihost.init(args.backend, device=torch.device(args.device).type)
    if args.spans is not None:
        profiling.enable()
    try:
        return _main(args)
    finally:
        if args.spans is not None:
            profiling.enable(False)
            profiling.export(_rank_path(args.spans))
        if joined:
            torch.distributed.destroy_process_group()


def _rank_path(path: str) -> str:
    """path, or under a process group of more than one rank this rank's
    file: path with .rank<r> before its suffix."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.rank{dist.get_rank()}{ext}"


def _rank() -> int:
    """This process's rank in the world, 0 without a process group."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _main(args):
    from .models.config import load_scheme
    from .render.renderer import Renderer
    from .utils import checkpoint as ckpt
    from .utils.image import save_png

    scheme = load_scheme(args.scheme)
    info = scheme.render_info
    if args.scale > 1:
        info.width //= args.scale
        info.height //= args.scale
    if info.animation:
        return _render_animation(scheme, args)

    renderer = Renderer(scheme, device=args.device, mode=args.mode, generator=args.generator)
    if args.resume:
        loaded = ckpt.load(args.resume)
        if (loaded.width, loaded.height) != (renderer.width, renderer.height):
            raise SystemExit(f"checkpoint is {loaded.width}x{loaded.height}, "
                             f"scheme renders {renderer.width}x{renderer.height}")
        renderer.target = loaded
        print(f"resumed at {loaded.count} spp", flush=True)

    writer = _rank() == 0
    preview = None
    if args.preview is not None and writer:
        from .utils.preview import LivePreview

        preview = LivePreview(port=args.preview)
        preview.start()
        print(f"live preview: http://127.0.0.1:{preview.port}/", flush=True)

    def hook(target):
        # every rank passes the hook, so that every rank takes the same batches
        if not writer:
            return
        save_png(args.out, target.to_u8_rgba())
        if args.checkpoint:
            ckpt.save(args.checkpoint, target)
        if preview is not None:
            preview.update(target)

    t0 = time.perf_counter()
    try:
        renderer.render(samples=args.samples, update_hook=hook, progress=writer)
    finally:
        if preview is not None:
            preview.stop()
    if not writer:
        return
    save_png(args.out, renderer.target.to_u8_rgba())
    ranks = "" if renderer.group is None else \
        f", {torch.distributed.get_world_size(renderer.group)} ranks"
    print(f"saved {args.out} ({renderer.target.count} spp, {time.perf_counter() - t0:.1f}s, "
          f"device {renderer.device}, {renderer.mode} semantics, {renderer.driver} driver, "
          f"{args.generator}{ranks})", flush=True)


def _render_animation(scheme, args):
    """The animation branch (raytrace_tpu/cli.py:98-148, the reference's
    main.rs:40-97): the frames of `extract_frames`, each rendered into
    ANIM_DIR/<i>.png (the directory made anew), the scene of frame k+1
    built on one builder thread while frame k renders, up to the scheme's
    anim_pipeline_depth (default 2) frames ahead; then the PNGs read back in
    numeric order and encoded to animation.mp4 by utils/video.encode_mp4.
    scheme: a parsed Scheme; args: a namespace with device, mode, samples
    and generator, as main's parser gives them. Returns {"frames": per
    frame {build_s (on the builder thread), wait_s (for the build),
    setup_s (the Renderer), render_s, png_s}, "video": the path written,
    "encode_s", "n_frames", "seconds"}. Under a process group every rank
    renders every frame with the world group and rank 0 alone writes the
    frames and the video (the other ranks return "video": None)."""
    from .models.animation import extract_frames
    from .models.scene import build_scene
    from .render.renderer import Renderer
    from .utils.image import load_png, save_png
    from .utils.video import encode_mp4

    info = scheme.render_info
    framerate = info.framerate
    if framerate is None:
        raise SystemExit("animation: true requires framerate")

    frames = extract_frames(scheme, framerate)
    writer = _rank() == 0
    if writer:
        print(f"Extracting frames:\n\t Number of frames: {len(frames)}"
              f"\n\t Time per frame {1.0 / framerate:.4f}s", flush=True)
        if os.path.isdir(ANIM_DIR):
            shutil.rmtree(ANIM_DIR)
        os.makedirs(ANIM_DIR, exist_ok=True)
    depth = info.anim_pipeline_depth or 2

    def build(frame_scheme):
        t0 = time.perf_counter()
        scene = build_scene(frame_scheme)
        return scene, time.perf_counter() - t0

    stats = []
    t_all = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = [pool.submit(build, frames[k]) for k in range(min(depth, len(frames)))]
        for i, frame_scheme in enumerate(frames):
            t0 = time.perf_counter()
            scene, build_s = pending.pop(0).result()
            t1 = time.perf_counter()
            nxt = i + len(pending) + 1
            if nxt < len(frames):
                pending.append(pool.submit(build, frames[nxt]))
            r = Renderer(frame_scheme, device=args.device, mode=args.mode, scene=scene,
                         generator=args.generator)
            t2 = time.perf_counter()
            r.render(samples=args.samples, progress=False)
            t3 = time.perf_counter()
            if writer:
                save_png(os.path.join(ANIM_DIR, f"{i}.png"), r.target.to_u8_rgba())
            t4 = time.perf_counter()
            stats.append(dict(build_s=build_s, wait_s=t1 - t0, setup_s=t2 - t1, render_s=t3 - t2,
                              png_s=t4 - t3))
            if writer:
                print(f"frame {i + 1}/{len(frames)} in {t4 - t0:.1f}s", flush=True)

    if not writer:
        return {"frames": stats, "video": None, "encode_s": 0.0, "n_frames": len(frames),
                "seconds": time.perf_counter() - t_all}

    # numeric-sorted frame encode (main.rs:69-84)
    names = sorted(os.listdir(ANIM_DIR), key=lambda p: int(p.split(".")[0]))
    # video frames are top-row-first; load_png returns bottom-first
    imgs = [load_png(os.path.join(ANIM_DIR, p))[::-1, :, :3] for p in names]
    t0 = time.perf_counter()
    out = encode_mp4("animation.mp4", imgs, framerate)
    encode_s = time.perf_counter() - t0
    total = time.perf_counter() - t_all
    print(f"encoded {out} ({len(imgs)} frames @ {framerate} fps, total {total:.1f}s)", flush=True)
    return {"frames": stats, "video": out, "encode_s": encode_s, "n_frames": len(imgs),
            "seconds": total}


if __name__ == "__main__":
    main()
