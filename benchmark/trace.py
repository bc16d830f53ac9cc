"""The device trace of the traced calls: torch.profiler's activity as
(name, start_us, end_us) intervals, reduced to the device's busy time,
the device time of each operation, and the idle gaps labelled by what the
host was doing (the innermost host event around the gap's middle).

The reductions take plain interval lists, so that tests can hand them a
synthetic table."""
from __future__ import annotations

import re
from collections import defaultdict

COPY, SET = "Memcpy", "Memset"
DTOH = "Memcpy DtoH"
RT_COPY = "cudaMemcpy"  # the runtime's copy calls on the host
SPAN = "bench."  # the benchmark's own spans (record_function), which the trace
# also shows on the device's timeline as annotations: not device work


def collect(prof):
    """(device, host): lists of (name, start_us, end_us) from a finished
    torch.profiler.profile."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            start, dur = float(e.start_us()), float(e.duration_us())
        on_dev = e.device_type() == DeviceType.CUDA
        if on_dev and e.name().startswith(SPAN):
            continue
        (dev if on_dev else host).append((e.name(), start, start + dur))
    return dev, host


def merged(intervals):
    """The union of (name, start, end) intervals as sorted (start, end)."""
    out = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label_gaps(gaps, host) -> dict:
    """Seconds of the gaps [(start, end)], summed by the innermost host
    event around each gap's middle ("(no host event)" outside them all):
    one sweep over the host events in order of start, a stack of the
    events open at the current time."""
    out = defaultdict(float)
    events = sorted(host, key=lambda x: (x[1], -x[2]))
    stack, i = [], 0
    for s, e in sorted(gaps):
        mid = 0.5 * (s + e)
        while i < len(events) and events[i][1] <= mid:
            while stack and stack[-1][2] < events[i][1]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        out[stack[-1][0] if stack else "(no host event)"] += (e - s) / 1e6
    return out


def copy_spans_s(dev, host, prefix: str = DTOH) -> float:
    """Seconds from the start of each device copy named `prefix...` on the
    device to the end of the host's cudaMemcpy* call that it lies in: to
    pageable memory that call returns once the driver has staged the data
    into the host's array, which the device's record leaves out. A record
    that lies in no such call counts its own length."""
    import bisect

    calls = sorted((s, e) for n, s, e in host if n.startswith(RT_COPY))
    starts = [c[0] for c in calls]
    total = 0.0
    for name, s, e in dev:
        if not name.startswith(prefix):
            continue
        i = bisect.bisect_right(starts, s) - 1
        end = calls[i][1] if i >= 0 and calls[i][1] >= s else e
        total += (max(end, e) - s) / 1e6
    return total


def summarize(dev, host, top: int = 10) -> dict:
    """busy_s (the union of device activity), device_s (the sum of the
    operations' times), by_name {name: [seconds, count]}, idle_gaps (the
    gaps between device activity, summed by the innermost host event
    around each gap's middle, longest first), dtoh_span_s (copy_spans_s)."""
    by_name = defaultdict(lambda: [0.0, 0])
    for name, s, e in dev:
        by_name[name][0] += (e - s) / 1e6
        by_name[name][1] += 1
    busy = merged(dev)
    gaps = _label_gaps([(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:]) if s1 > e0], host)
    return dict(
        busy_s=sum(e - s for s, e in busy) / 1e6,
        device_s=sum(v[0] for v in by_name.values()),
        by_name=dict(by_name),
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
        dtoh_span_s=copy_spans_s(dev, host))


def kernel_s(summary: dict, kernel: str):
    """(seconds, launches) of the device operations named `kernel`: the
    CUDA symbol `kernel`, templated or not (`ns::kernel<...>(...)`)."""
    pat = re.compile(rf"(^|[^A-Za-z0-9_]){re.escape(kernel)}(<|\(|$)")
    rows = [v for k, v in summary["by_name"].items() if pat.search(k)]
    return sum(r[0] for r in rows), sum(r[1] for r in rows)


def copies_s(summary: dict, prefix: str = COPY) -> float:
    return sum(v[0] for k, v in summary["by_name"].items() if k.startswith(prefix))


def top_ops(summary: dict, top: int = 10):
    return [[k[:160], v[0]] for k, v in sorted(summary["by_name"].items(),
                                              key=lambda kv: -kv[1][0])[:top]]
