"""setup_s: seconds from the process's start to the first timed call (the
imports, CUDA's start, the scene's build, the Renderer, the warm call)."""


def read(ctx):
    return ctx["setup_s"]
