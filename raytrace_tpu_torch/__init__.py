"""raytrace_tpu_torch — the path tracer of `raytrace_tpu`, ported to
PyTorch and CUDA for NVIDIA Hopper (H100).

The JAX package `raytrace_tpu/` is the reference; every module here
mirrors the one of the same name there, and the tests hold each against
it on the same scene and the same sample ids. This package imports
torch and never jax, flax or anything of `raytrace_tpu`.

Layout:
  models/    scheme schema (keyframe animation included), camera, glTF
             loader, numpy scene arrays, keyframe easing and frame
             extraction, the inline walled and procedural schemes
  ops/       counter RNG (weyl, pcg), raygen, closest hit, BSDF, cube map,
             and the kernel wrappers with their plain torch versions
  csrc/      the hand-written CUDA kernels (sm_90a)
  kernels/   nvcc build at first use, loaded with ctypes
  render/    Renderer driver, integrator, wavefront and the render target
  parallel/  torch.distributed: torchrun init, the (tile, spp) mesh, the
             sharded render steps and the train step's gradient all-reduce
  utils/     PNG in and out, checkpoints, video encode, the async update
             hook, profiling and the live preview
  cli.py     python -m raytrace_tpu_torch.cli <scheme.yml> [no_ui]
"""

__version__ = "0.1.0"

EPS = 1e-4  # global epsilon, the reference's src/lib.rs:20
