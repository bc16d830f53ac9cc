"""scene.build_s: host seconds of the program's build_scene and the
Renderer's construction (the tables' upload), taken around those calls."""


def read(ctx):
    return ctx["build_s"]
