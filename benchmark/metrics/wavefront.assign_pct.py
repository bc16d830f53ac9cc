"""wavefront.assign_pct: the share of the traced calls' device time in the
wavefront's kernels other than its three hand kernels (mesh_hit,
bounce_prims, bounce_shade) and the copies: the lane pool's refill, the
lanes_assign entry's two kernels (lanes_count_kernel, lanes_assign_kernel),
and the few torch kernels of a call (a batch's start, its image's sum, the
target's add and mean). Nothing where no bounce kernel ran."""
from benchmark import trace

HAND = ("mesh_hit_kernel", "bounce_prims_kernel", "bounce_shade_kernel")


def read(ctx):
    s = ctx["summary"]
    if not s or trace.kernel_s(s, "bounce_shade_kernel")[1] == 0 or s["device_s"] <= 0:
        return None
    hand = sum(trace.kernel_s(s, k)[0] for k in HAND)
    rest = s["device_s"] - hand - trace.copies_s(s, trace.COPY) - trace.copies_s(s, trace.SET)
    return 100.0 * rest / s["device_s"]
