"""The benchmark's plain reference: a frozen copy, in plain torch, of
what a render of the benchmark's scenes computes: the counter RNG, the
camera's raygen, the sphere and triangle tests, the cluster walk over the
mesh, the BSDFs and the two semantics (the reference renderer's GPU and
CPU backends), with the work counts that the kernels' rooflines divide.

It imports nothing of the program (raytrace_tpu_torch) nor of the JAX
package: it builds its own tables from the benchmark's raw scene
(`benchmark.scenes.RawScene`) and recomputes every path from its
(pixel, sample) id. Every function takes tensors of one float dtype, so
that the same code runs in float32 (the reference) and in bfloat16 (the
control that the comparison has to fail).
"""
