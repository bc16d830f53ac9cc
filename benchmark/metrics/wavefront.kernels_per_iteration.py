"""wavefront.kernels_per_iteration: device kernels (copies and memsets
aside) of the traced calls over their wavefront iterations
(Renderer.stats["iterations"]). Nothing where no iteration ran."""
from benchmark import trace


def read(ctx):
    s, its = ctx["summary"], ctx["traced"].get("iterations", 0)
    if not s or not its:
        return None
    n = sum(v[1] for k, v in s["by_name"].items()
            if not k.startswith((trace.COPY, trace.SET)))
    return n / its if n else None
