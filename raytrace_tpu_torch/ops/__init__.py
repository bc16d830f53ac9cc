"""Numerics: counter RNG, raygen, closest hit, BSDF sampling, and the
`trace_tiles` kernel wrapper."""
