"""The port's host remainder against the JAX package and on its own: PNG
read-back, the MJPEG-AVI writer byte-equal to the JAX one, the mp4 ladder
through its OpenCV rung (read back with cv2.VideoCapture) and its
MJPEG-AVI fallback, AsyncHook (latest-wins, the final snapshot, the
re-raise), Throughput / the span recorder's export, LivePreview
serving /frame, the Renderer's prebuilt scene, its progress bar and the
async hook's error, and the CLI (render(samples=k) on every driver, with
and without the async hook, is test_torch_renderer's): the animation branch (frames bitwise
the single-frame renders, the video written), --preview and --generator."""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from raytrace_tpu.utils import image as jax_image
from raytrace_tpu.utils import video as jax_video
from raytrace_tpu_torch.models import procedural
from raytrace_tpu_torch.models.animation import extract_frames
from raytrace_tpu_torch.models.scene import build_scene
from raytrace_tpu_torch.models.walled import walled_scheme
from raytrace_tpu_torch.render.renderer import Renderer
from raytrace_tpu_torch.render.target import RenderTarget
from raytrace_tpu_torch.utils import image, video
from raytrace_tpu_torch.utils.hooks import AsyncHook
from raytrace_tpu_torch.utils.preview import LivePreview
from raytrace_tpu_torch.utils import profiling
from raytrace_tpu_torch.utils.profiling import Throughput

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(n=5, h=48, w=64):
    g = np.random.default_rng(4)
    base = g.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return [np.roll(base, 3 * k, axis=1) for k in range(n)]


def test_load_png_inverts_save_png(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (9, 13, 4), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    image.save_png(path, img)
    np.testing.assert_array_equal(image.load_png(path), img)  # row 0 = bottom both ways
    np.testing.assert_array_equal(jax_image.load_png(path), img)


def test_mjpeg_avi_byte_equal_to_jax(tmp_path):
    frames = _frames()
    ours, ref = str(tmp_path / "a.avi"), str(tmp_path / "b.avi")
    video.write_mjpeg_avi(ours, frames, 12.0)
    jax_video.write_mjpeg_avi(ref, frames, 12.0)
    assert open(ours, "rb").read() == open(ref, "rb").read()
    with pytest.raises(ValueError):
        video.write_mjpeg_avi(ours, [], 12.0)


def _without(monkeypatch, *modules):
    for m in modules:
        monkeypatch.setitem(sys.modules, m, None)  # `import m` raises ImportError


def test_encode_mp4_opencv_rung(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    _without(monkeypatch, "imageio")
    frames = _frames(7)
    path = video.encode_mp4(str(tmp_path / "v.mp4"), frames, 8.0)
    assert path == str(tmp_path / "v.mp4")
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 7


def test_encode_mp4_falls_back_to_mjpeg_avi(tmp_path, monkeypatch):
    _without(monkeypatch, "imageio", "cv2")
    frames = _frames(3)
    path = video.encode_mp4(str(tmp_path / "v.mp4"), frames, 8.0)
    assert path == str(tmp_path / "v.avi")
    video.write_mjpeg_avi(str(tmp_path / "ref.avi"), frames, 8.0)
    assert open(path, "rb").read() == open(tmp_path / "ref.avi", "rb").read()


def _target(count, value):
    t = RenderTarget(4, 2)
    t.acc[:] = value
    t.count = count
    return t


def test_async_hook_latest_wins_and_final_snapshot():
    gate, seen = threading.Event(), []

    def slow(target):
        gate.wait(10)
        seen.append((target.count, float(target.acc[0, 0])))

    hook = AsyncHook(slow)
    live = _target(1, 1.0)
    hook(live)  # taken by the writer at once, which then blocks
    time.sleep(0.2)
    for k in (2, 3, 4):
        live.acc[:] = k
        live.count = k
        hook(live)  # 2 and 3 are replaced by 4 while the writer is busy
    live.acc[:] = 99.0  # the snapshot, not the live target, is delivered
    gate.set()
    hook.close()
    assert seen == [(1, 1.0), (4, 4.0)]


def test_async_hook_reraises_at_close():
    def bad(target):
        raise RuntimeError("disk full")

    hook = AsyncHook(bad)
    hook(_target(1, 0.0))
    with pytest.raises(RuntimeError, match="disk full"):
        hook.close()


def test_render_closes_the_hook_and_reraises():
    def bad(target):
        raise OSError("disk full")

    r = Renderer(walled_scheme(16, 8), device="cpu")
    with pytest.raises(OSError, match="disk full"):
        r.render(samples=2, batch=1, update_hook=bad, progress=False)
    assert r.target.count == 2


def test_phases_throughput_and_trace(tmp_path):
    """The meter, and the span recorder in Phases' and trace's place: a
    render's spans accumulate while it is on and export as Chrome trace
    events."""
    meter = Throughput()
    meter.add(2_000_000)
    assert meter.mpaths_per_s > 0
    profiling.reset()
    profiling.enable()
    try:
        with profiling.span("a"):
            time.sleep(0.01)
        Renderer(walled_scheme(16, 8), device="cpu").render(samples=1, progress=False)
        a = profiling.records()[0]
        assert a.name == "a" and a.end - a.start >= 10_000_000
        path = tmp_path / "tr.json"
        profiling.export(str(path))
    finally:
        profiling.enable(False)
        profiling.reset()
    events = json.load(open(path))["traceEvents"]
    assert [e["name"] for e in events][:2] == ["a", "renderer.init"]
    assert {"render", "render.step", "render.copy", "render.add", "render.mean"} <= \
        {e["name"] for e in events}


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_live_preview_serves_the_frame():
    from PIL import Image
    import io

    pv = LivePreview(port=0)
    pv.start()
    try:
        assert pv.port > 0
        base = f"http://127.0.0.1:{pv.port}"
        with pytest.raises(urllib.error.HTTPError):
            _get(base + "/frame")  # nothing rendered yet: 404
        r = Renderer(walled_scheme(32, 16), device="cpu")
        r.render(samples=2, update_hook=pv.update, async_hook=False, progress=False)
        status, kind, body = _get(base + "/frame?t=1")
        assert status == 200 and kind == "image/png"
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(body))),
                                      r.target.to_u8_rgba()[::-1])
        status, kind, page = _get(base + "/")
        assert status == 200 and kind == "text/html" and b"/frame" in page
    finally:
        pv.stop()


def test_renderer_takes_a_prebuilt_scene():
    scheme = walled_scheme(32, 16)
    scene = build_scene(scheme)
    r = Renderer(scheme, device="cpu", scene=scene)
    assert r.scene is scene
    np.testing.assert_array_equal(r.render(samples=2, progress=False),
                                  Renderer(scheme, device="cpu").render(samples=2, progress=False))


def test_progress_bar(capsys):
    pytest.importorskip("tqdm")
    Renderer(walled_scheme(16, 8), device="cpu").render(samples=2, batch=1)
    err = capsys.readouterr().err
    assert "samples" in err and "Mpaths/s" in err
    Renderer(walled_scheme(16, 8), device="cpu").render(samples=2, progress=False)
    assert "samples" not in capsys.readouterr().err


def _walled_anim_yaml(path, framerate=3):
    """walled's members at 1200x600 with the mirror sphere keyframed by
    EaseInOut and the DiffSpec sphere by Step: framerate frames."""
    path.write_text(
        "render_info: {width: 1200, height: 600, samps_per_pix: 2, animation: true,\n"
        f"  framerate: {framerate}, anim_pipeline_depth: 2,\n"
        "  rad_info: {russ_roull_info: {assured_depth: 5, max_thres: 0.5}}}\n"
        "cam: {d: [0, 0, -5], o: [0, -1, 0], up: [0, 1, 0], screen_width: 10, screen_height: 5}\n"
        "scene_members:\n"
        "- !Sphere {c: [1, -5, -20], r: 4, coloring: !Solid [0.6, 0, 0.8],\n"
        "   mat: {divert_ray: Diff}}\n"
        "- !Sphere {c: [-3, 0, -6], r: 1, coloring: !Solid [1, 1, 1], mat: {divert_ray: Spec},\n"
        "   animation: {keyframes: [{translation: [-3, 0, -6], time: 0, ease_type: EaseInOut},\n"
        "                           {translation: [-1, 1, -7], time: 1}]}}\n"
        "- !Sphere {c: [1, -1.5, -6], r: 0.5, coloring: !Solid [0.2, 1, 0.5],\n"
        "   mat: {divert_ray: !DiffSpec {diffp: 0.7}},\n"
        "   animation: {keyframes: [{translation: [1, -1.5, -6], time: 0, ease_type: Step},\n"
        "                           {translation: [2, -1, -6], time: 0.6, ease_type: Hold},\n"
        "                           {translation: [0, -1.5, -5.5], time: 1}]}}\n"
        "- !Sphere {c: [0, 10, -15], r: 5, coloring: !Solid [0, 0, 0],\n"
        "   mat: {divert_ray: Diff, emissive: [5, 5, 5]}}\n"
        "- !Sphere {c: [515, 0, -10], r: 500, coloring: !Solid [0.25, 0.25, 0.75],\n"
        "   mat: {divert_ray: Diff}}\n"
        "- !Sphere {c: [-515, 0, -10], r: 500, coloring: !Solid [0.75, 0.25, 0.25],\n"
        "   mat: {divert_ray: Diff}}\n"
        "- !Sphere {c: [0, -510, -10], r: 500, coloring: !Solid [0.75, 0.75, 0.75],\n"
        "   mat: {divert_ray: Diff}}\n")
    return str(path)


def test_cli_animation_branch(tmp_path, monkeypatch, capsys):
    """`animation: true` through the CLI at --scale 8 (150x75), 3 frames
    at 2 spp: ./anim_frames/<i>.png bitwise Renderer(frames[i],
    device="cpu").render(2)'s PNG, a stale frame directory replaced, and
    the video written and read back with 3 frames."""
    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.models.config import load_scheme

    yml = _walled_anim_yaml(tmp_path / "anim.yml")
    work = tmp_path / "work"
    (work / "anim_frames").mkdir(parents=True)
    (work / "anim_frames" / "stale.txt").write_text("x")
    monkeypatch.chdir(work)
    cli.main([yml, "no_ui", "--device", "cpu", "--scale", "8"])
    out = capsys.readouterr().out
    assert "Number of frames: 3" in out and "encoded" in out
    names = sorted(os.listdir("anim_frames"))
    assert names == ["0.png", "1.png", "2.png"]
    scheme = load_scheme(yml)
    scheme.render_info.width, scheme.render_info.height = 150, 75
    frames = extract_frames(scheme, 3.0)
    assert len(frames) == 3
    for i, f in enumerate(frames):
        r = Renderer(f, device="cpu")
        r.render(samples=2, progress=False)
        with open(f"anim_frames/{i}.png", "rb") as fh:
            assert fh.read() == image.encode_png(r.target.to_u8_rgba()), i
    videos = [p for p in os.listdir(".") if p.startswith("animation.")]
    assert len(videos) == 1 and os.path.getsize(videos[0]) > 0
    if videos[0].endswith(".mp4"):
        cv2 = pytest.importorskip("cv2")
        cap = cv2.VideoCapture(videos[0])
        n = 0
        while cap.read()[0]:
            n += 1
        assert n == 3


def test_cli_animation_needs_framerate(tmp_path, monkeypatch):
    from raytrace_tpu_torch import cli

    yml = tmp_path / "a.yml"
    yml.write_text(open(_walled_anim_yaml(tmp_path / "b.yml")).read().replace(
        "framerate: 3, ", ""))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        cli.main([str(yml), "--device", "cpu", "--scale", "8"])


def test_render_animation_returns_its_times(tmp_path, monkeypatch):
    """_render_animation called with a parsed Scheme and an args namespace
    (as chip_smoke.py calls it), at depth 1: the per-frame times and the
    video path."""
    import argparse

    from raytrace_tpu_torch import cli

    scheme = procedural.animated_walled_scheme(32, 16, 2, framerate=4)
    scheme.render_info.anim_pipeline_depth = 1
    monkeypatch.chdir(tmp_path)
    res = cli._render_animation(scheme, argparse.Namespace(device="cpu", mode=None, samples=1,
                                                           generator="pcg"))
    assert res["n_frames"] == 4 and len(res["frames"]) == 4 and os.path.exists(res["video"])
    assert all(min(f.values()) >= 0 for f in res["frames"])
    r = Renderer(extract_frames(scheme, 4.0)[3], device="cpu", generator="pcg")
    r.render(samples=1, progress=False)
    np.testing.assert_array_equal(image.load_png("anim_frames/3.png"), r.target.to_u8_rgba())


def test_cli_generator_and_preview(tmp_path, capsys):
    from raytrace_tpu_torch import cli

    yml = tmp_path / "s.yml"
    yml.write_text(
        "render_info: {width: 32, height: 16, samps_per_pix: 2,\n"
        "  rad_info: {russ_roull_info: {assured_depth: 3, max_thres: 0.5}}}\n"
        "cam: {d: [0, 0, -5], o: [0, -1, 0], up: [0, 1, 0], screen_width: 10, screen_height: 5}\n"
        "scene_members:\n"
        "- !Sphere {c: [0, 10, -15], r: 5, coloring: !Solid [0, 0, 0],\n"
        "   mat: {divert_ray: Diff, emissive: [5, 5, 5]}}\n"
        "- !Sphere {c: [0, -510, -10], r: 500, coloring: !Solid [0.75, 0.75, 0.75],\n"
        "   mat: {divert_ray: Diff}}\n")
    out = tmp_path / "out.png"
    cli.main([str(yml), "--device", "cpu", "--generator", "pcg", "--preview", "0",
              "--out", str(out)])
    printed = capsys.readouterr().out
    assert "live preview: http://127.0.0.1:" in printed and "pcg" in printed
    from raytrace_tpu_torch.models.config import load_scheme

    r = Renderer(load_scheme(str(yml)), device="cpu", generator="pcg")
    r.render(progress=False)
    np.testing.assert_array_equal(image.load_png(str(out)), r.target.to_u8_rgba())
    with pytest.raises(SystemExit):
        cli.main([str(yml), "--device", "cpu", "--generator", "xorshift"])


def test_cli_module_renders_an_animation(tmp_path):
    """python -m raytrace_tpu_torch.cli on an animation scheme, in a
    process of its own."""
    yml = _walled_anim_yaml(tmp_path / "anim.yml", framerate=2)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "raytrace_tpu_torch.cli", yml, "no_ui",
                           "--device", "cpu", "--scale", "16", "--samples", "1"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert sorted(os.listdir(tmp_path / "anim_frames")) == ["0.png", "1.png"]
    assert any(p.startswith("animation.") for p in os.listdir(tmp_path))
