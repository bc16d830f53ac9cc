"""CLI entry — the reference's main.rs analogue, for static schemes of
spheres, free triangles and `!Model` glTF meshes.

    python -m raytrace_tpu_torch.cli <scheme.yml> [no_ui] --device cuda \
        --samples N --out render_out.png [--checkpoint ck.npz] [--resume ck.npz]

Renders to a PNG, rewritten (with the checkpoint, when asked) after every
sample batch, as the reference's no-ui output loop (ui_util.rs:37-54).
Animation schemes and cube maps are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="path tracer (PyTorch / CUDA)")
    ap.add_argument("scheme", help="scheme YAML path")
    ap.add_argument("no_ui", nargs="?", default=None, help="compat positional (no window in this build)")
    ap.add_argument("--device", default="cuda", help="cuda (the CUDA kernel) or cpu (plain torch)")
    ap.add_argument("--out", default="render_out.png")
    ap.add_argument("--samples", type=int, default=None, help="override samps_per_pix")
    ap.add_argument("--scale", type=int, default=1, help="divide width/height by this (smoke runs)")
    ap.add_argument("--checkpoint", default=None, help="save resume state here after each batch")
    ap.add_argument("--resume", default=None, help="resume from a checkpoint file")
    args = ap.parse_args(argv)

    from .models.config import load_scheme
    from .render.renderer import Renderer
    from .utils import checkpoint as ckpt
    from .utils.image import save_png

    scheme = load_scheme(args.scheme)
    info = scheme.render_info
    if info.animation:
        raise NotImplementedError("animation schemes are not ported yet (ROADMAP queue 1, item 14)")
    if args.scale > 1:
        info.width //= args.scale
        info.height //= args.scale

    renderer = Renderer(scheme, device=args.device)
    if args.resume:
        loaded = ckpt.load(args.resume)
        if (loaded.width, loaded.height) != (renderer.width, renderer.height):
            raise SystemExit(f"checkpoint is {loaded.width}x{loaded.height}, "
                             f"scheme renders {renderer.width}x{renderer.height}")
        renderer.target = loaded
        print(f"resumed at {loaded.count} spp", flush=True)

    def hook(target):
        save_png(args.out, target.to_u8_rgba())
        if args.checkpoint:
            ckpt.save(args.checkpoint, target)

    t0 = time.perf_counter()
    renderer.render(samples=args.samples, update_hook=hook)
    save_png(args.out, renderer.target.to_u8_rgba())
    print(f"saved {args.out} ({renderer.target.count} spp, {time.perf_counter() - t0:.1f}s, "
          f"device {renderer.device})", flush=True)


if __name__ == "__main__":
    main()
