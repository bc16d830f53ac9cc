"""mpaths_per_s: every path of the window's calls (pixels x samples,
summed over the calls) over the window's wall time, in millions."""


def read(ctx):
    return len(ctx["times"]) * ctx["batch"] * ctx["pixels"] / ctx["window_s"] / 1e6
