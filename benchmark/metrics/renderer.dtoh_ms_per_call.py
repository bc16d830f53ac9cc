"""renderer.dtoh_ms_per_call: ms a traced call of the device-to-host copies
(the batch sum's copy to the host's RenderTarget; in the wavefront also
its flag reads), each from its start on the device to the end of the
host's cudaMemcpy call it lies in (trace.copy_spans_s): to pageable memory
that call returns once the driver has staged the data into the host's
array, the part of the copy that a pinned buffer saves."""


def read(ctx):
    s = ctx["summary"]
    if not s:
        return None
    ms = s["dtoh_span_s"] * 1e3
    return ms / ctx["traced"]["calls"] if ms > 0 else None
