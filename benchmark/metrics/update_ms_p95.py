"""update_ms_p95: the 95th percentile over every call of the window of the
call's wall time, from `render(samples=batch)` to the mean image on the
host (what the preview shows after each batch)."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx["times"], 95)) * 1e3
