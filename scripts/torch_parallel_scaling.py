#!/usr/bin/env python3
"""parallel/ over several cards, one process a card under NCCL.

    python3 scripts/torch_parallel_scaling.py

Needs two or more CUDA devices (measured on a machine of four).
Builds the kernels, then for n = 2 and n = every card, runs
`torchrun --standalone --nproc-per-node n` of this script in its rank mode:
each rank joins with NCCL (parallel/multihost.init), checks that it runs on
cuda:LOCAL_RANK (its current device and its scene tables there), and with
the Renderer over the world renders walled 1200x600 render(1024) through
trace_tiles, the a380-class 1216x608 render(64) through mesh_trace and its
cpu-semantics render(16) through the wavefront and mesh_hit (a warm
render(1) first; the timed render after a barrier, the launch counts reset
just before and read just after), then one make_train_step on make_mesh()
(n = 2: (tile 2, spp 1); n = 4: (2, 2)) at walled 1200x600, one sample an
spp rank, and times the all-reduce of an image's sums. Each render is
timed REPS times (the best kept), then once more in its parts, each
synchronised: the rank's slice through its driver, the all-reduce, the
copy to the host; one process's renders likewise. This process, on
cuda:0 after the ranks, renders the same ids in one process: at n = 2
every render must equal bitwise the rank-order sum of the two slices'
one-process renders (a sum of two f32 is the same in either order); at n
= 4 NCCL's ring reorders the sums, so each image must pass the tile gate
and stay within 1e-5 relative of the one-process render. The train step's
loss within 1e-6 relative and every gradient within relative L2 1e-3 of
one process's step over the same samples, bitwise equal on every rank.
Prints each rank's render ms beside the one-process render's (the
scaling), with the card's name and power limit.
"""
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_MODE = "--rank"  # the arguments of a rank: --rank <out dir> <card>
WALLED_SPP, MESH_SPP, CPU_SPP = 1024, 64, 16
REPS = 3  # sharded renders timed a rank, one after another


def render_parts(r, spp, group=None):
    """One more render(spp) of r in its parts, each synchronised: this
    rank's slice through the driver, the all-reduce over group (none
    without one), the copy of the sums to the host. Returns {driver_ms,
    all_reduce_ms, copy_ms}."""
    import torch
    import torch.distributed as dist

    from raytrace_tpu_torch.parallel.distributed import sample_slice

    grouped = group is not None
    size, rank = (dist.get_world_size(group), dist.get_rank(group)) if grouped else (1, 0)
    offset, count = sample_slice(spp, size, rank)
    torch.cuda.synchronize()
    if grouped:
        dist.barrier()
    t0 = time.perf_counter()
    out = r._batch(r.tables, r.params, r._xs, r._ys, sample_base=offset, n_samples=count,
                   samples_per_launch=r.samples_per_launch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if grouped:
        dist.all_reduce(out, group=group)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    out.cpu().numpy()
    t3 = time.perf_counter()
    return dict(driver_ms=(t1 - t0) * 1e3, all_reduce_ms=(t2 - t1) * 1e3, copy_ms=(t3 - t2) * 1e3)


def renders():
    """(label, scheme, Renderer keywords, spp)."""
    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.models.walled import walled_scheme

    a380 = procedural.a380_scheme(1216, 608, MESH_SPP)
    return [("walled", walled_scheme(1200, 600), {}, WALLED_SPP),
            ("a380-class", a380, {}, MESH_SPP),
            ("a380-class cpu", a380, dict(mode="cpu"), CPU_SPP)]


def rank_main(out, card) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.ops.raygen import camera_to_arrays
    from raytrace_tpu_torch.parallel import multihost
    from raytrace_tpu_torch.parallel.distributed import make_train_step, tile_block
    from raytrace_tpu_torch.parallel.mesh import make_mesh
    from raytrace_tpu_torch.render.renderer import Renderer

    assert multihost.init(device="cuda") and dist.get_backend() == "nccl"
    rank, world = dist.get_rank(), dist.get_world_size()
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda", torch.cuda.current_device())
    assert dev.index == local, f"rank {rank} runs on {dev}, not cuda:{local}"
    tag = f"[scale] nccl rank {rank}/{world} on {dev}"
    arrays, info = {}, {"renders": {}}
    for label, scheme, kw, spp in renders():
        r = Renderer(scheme, "cuda", **kw)
        assert {b.device for b in r.tables.buffers() if b.is_cuda} == {dev}, \
            f"{label}: tables off {dev}"
        digests = [None] * world
        dist.all_gather_object(digests, cs.tables_digest(r.tables))
        assert len(set(digests)) == 1, f"{label}: the ranks' tables differ"
        r.render(progress=False, samples=1)  # warm: the kernels, NCCL's communicator
        turns = [cs.timed_sharded(r, spp) for _ in range(REPS)]
        ms, launches = min(t for t, _ in turns), turns[0][1]
        assert launches and all(c == launches for _, c in turns), f"{label}: launches {turns}"
        arrays[label] = r.target.acc.copy()
        parts = render_parts(r, spp, dist.group.WORLD)
        info["renders"][label] = dict(ms=ms, launches=launches, parts=parts)
        print(f"{tag}: {label} {r.width}x{r.height} render({spp}), driver {r.driver}: "
              f"{[round(t, 2) for t, _ in turns]} ms, launches {launches}; parts "
              f"{ {k: round(v, 3) for k, v in parts.items()} } [{card}]", flush=True)
    mesh = make_mesh()
    scene, cam, params, xs, ys, wts = cs.diff_setup(walled_scheme(1200, 600), dev)
    step = make_train_step(mesh, n_samples=1)
    target = tile_block(wts, dist.get_world_size(mesh.get_group("tile")),
                        mesh.get_local_rank("tile"))
    step(scene, camera_to_arrays(cam, dev), params, xs, ys, 0, target)  # warm
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    loss, (g, gc) = step(scene, camera_to_arrays(cam, dev), params, xs, ys, 0, target)
    torch.cuda.synchronize()
    info["train_ms"], info["mesh"] = (time.perf_counter() - t0) * 1e3, list(mesh.shape)
    step_out = {"loss": loss.detach().cpu().numpy()}
    step_out.update({"g." + k: v.cpu().numpy() for k, v in g.items()})
    step_out.update({"gc." + k: v.cpu().numpy() for k, v in gc.items()})
    digests = [None] * world
    dist.all_gather_object(digests, [v.tobytes() for v in step_out.values()])
    assert all(d == digests[0] for d in digests), "the ranks' loss or gradients differ"
    arrays.update(step_out)
    print(f"{tag}: make_train_step on make_mesh() {tuple(mesh.shape)}: loss {float(loss):.9g}, "
          f"{info['train_ms']:.1f} ms [{card}]", flush=True)
    info["all_reduce_ms"] = cs.all_reduce_ms(1200 * 600, dev)
    print(f"{tag}: all-reduce of the walled sums (8640000 bytes f32): "
          f"{info['all_reduce_ms']:.3f} ms [{card}]", flush=True)
    if rank == 0:
        np.savez(os.path.join(out, "rank0.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()
    return 0


def launch(n, out, card):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", os.path.abspath(__file__), RANK_MODE, out, card]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    for line in stdout.splitlines():
        print(line, flush=True)
    assert proc.returncode == 0, f"{n} ranks: rc {proc.returncode}\n{stderr[-4000:]}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_parallel_scaling: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == [RANK_MODE]:
        return rank_main(*sys.argv[2:4])
    import numpy as np

    import chip_smoke as cs
    from raytrace_tpu_torch.kernels import build
    from raytrace_tpu_torch.models.scene import build_scene
    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.ops.raygen import camera_to_arrays
    from raytrace_tpu_torch.parallel.distributed import make_train_step, sample_slice
    from raytrace_tpu_torch.render.renderer import Renderer

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"torch_parallel_scaling: {cards} CUDA device; needs two or more", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print("\n".join(card), flush=True)
    card = f"{card[0]} x{cards}"
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(build.build, ("trace_kernel", "mesh_kernel")))  # once, before the ranks
    dev = torch.device("cuda", 0)
    runs = renders()
    scenes = {id(scheme): build_scene(scheme) for _, scheme, *_ in runs}

    def one(scheme, kw, base, n):
        r = Renderer(scheme, dev, scene=scenes[id(scheme)], **kw)
        r.target.count = base
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render(progress=False, samples=n)
        torch.cuda.synchronize()
        return r.target.acc, (time.perf_counter() - t0) * 1e3

    alone = {}  # label: (the best of REPS one-process renders' ms, their parts)
    for label, scheme, kw, spp in runs:
        one(scheme, kw, 0, 1)  # warm
        r = Renderer(scheme, dev, scene=scenes[id(scheme)], **kw)
        alone[label] = (min(one(scheme, kw, 0, spp)[1] for _ in range(REPS)),
                        render_parts(r, spp))
        print(f"[scale] {label} render({spp}) in 1 process on {dev}: {alone[label][0]:.2f} ms "
              f"(best of {REPS}); parts { {k: round(v, 3) for k, v in alone[label][1].items()} } "
              f"[{card}]", flush=True)

    scene, cam, params, xs, ys, wts = cs.diff_setup(walled_scheme(1200, 600), dev)
    for n in sorted({2, cards}):
        with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_scale_") as out:
            t0 = time.perf_counter()
            launch(n, out, card)
            print(f"[scale] {n} ranks: torchrun in {time.perf_counter() - t0:.1f} s", flush=True)
            got = dict(np.load(os.path.join(out, "rank0.npz")))
            infos = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(n)]
        for label, scheme, kw, spp in runs:
            whole, whole_ms = one(scheme, kw, 0, spp)[0], alone[label][0]
            parts = [one(scheme, kw, off, cnt)[0] for off, cnt in
                     (sample_slice(spp, n, r) for r in range(n))]
            if n == 2:
                assert np.array_equal(got[label], parts[0] + parts[1]), \
                    f"{label}: 2 ranks are not the rank-order sum of the slices"
                how = "bitwise the rank-order sum of the 1-process slices"
            else:
                rel = float((np.abs(got[label] - whole) / (np.abs(whole) + 1e-3)).max())
                w, h = scheme.render_info.width, scheme.render_info.height
                cs.gate("scale", f"{label} {n} ranks against 1 process",
                        got[label].reshape(h, w, 3) / spp, whole.reshape(h, w, 3) / spp)
                assert rel <= 1e-5, f"{label}: {n} ranks off the 1-process render by {rel:.3e}"
                how = f"within {rel:.2e} relative of the 1-process render"
            ms = [info["renders"][label]["ms"] for info in infos]
            print(f"[scale] {label} render({spp}) over {n} NCCL ranks, a card each: {how}; "
                  f"{max(ms):.2f} ms (slowest rank's best of {REPS}; ranks "
                  f"{[round(m, 2) for m in ms]}) against {whole_ms:.2f} ms in 1 process: "
                  f"{whole_ms / max(ms):.2f}x; launches a rank "
                  f"{infos[0]['renders'][label]['launches']} [{card}]", flush=True)
        spp_size = infos[0]["mesh"][1]
        loss, (g, gc) = make_train_step(n_samples=spp_size)(
            scene, camera_to_arrays(cam, dev), params, xs, ys, 0, wts)
        ref = {"g." + k: v.cpu().numpy() for k, v in g.items()}
        ref.update({"gc." + k: v.cpu().numpy() for k, v in gc.items()})
        errs = {k: float(cs.rel_l2(torch.from_numpy(got[k]), torch.from_numpy(v)))
                for k, v in ref.items() if v.size}
        worst = max(errs, key=errs.get)
        dl = abs(float(got["loss"]) - float(loss)) / abs(float(loss))
        print(f"[scale] make_train_step on a {tuple(infos[0]['mesh'])} mesh of {n} cards: loss "
              f"{float(got['loss']):.9g} against 1 process's {float(loss):.9g} ({dl:.2e} "
              f"relative); gradients' relative L2 at most {errs[worst]:.3e} ({worst}); bitwise "
              f"on every rank; {max(i['train_ms'] for i in infos):.1f} ms (slowest rank) "
              f"[{card}]", flush=True)
        assert dl <= 1e-6 and errs[worst] <= 1e-3, "the train step is off one process's"
        print(f"[scale] all-reduce of the walled sums over {n} cards: "
              f"{[round(i['all_reduce_ms'], 3) for i in infos]} ms [{card}]", flush=True)
    print(json.dumps({"ok": True, "cards": cards}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
