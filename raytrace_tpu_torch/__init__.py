"""raytrace_tpu_torch — the path tracer of `raytrace_tpu`, ported to
PyTorch and CUDA for NVIDIA Hopper (H100).

The JAX package `raytrace_tpu/` is the reference; every module here
mirrors the one of the same name there, and the tests hold each against
it on the same scene and the same sample ids. This package imports
torch and never jax, flax or anything of `raytrace_tpu`.

Layout:
  models/    scheme schema, camera, numpy scene arrays (meshless subset),
             the inline walled benchmark scheme
  ops/       counter RNG, raygen, closest hit, BSDF, and the
             `trace_tiles` kernel wrapper with its plain torch version
  csrc/      the hand-written CUDA kernel (sm_90a)
  kernels/   nvcc build at first use, loaded with ctypes
  render/    Renderer driver and the f32 render target
  utils/     PNG output and exact-resume checkpoints
  cli.py     python -m raytrace_tpu_torch.cli <scheme.yml> [no_ui]
"""

__version__ = "0.1.0"

EPS = 1e-4  # global epsilon, the reference's src/lib.rs:20
