"""A few whole steps under ``torch.profiler``, reduced to what the traced
run reports: the device's busy seconds (the union of the device
operations' intervals, host ranges mirrored on the device's timeline
left out) against the steps' wall time, the device time of
the program's own kernels, the costliest device operations by name, and
the idle gaps of the device by what the host was doing meanwhile (the
innermost host operation under way when a gap began, with the
benchmark's range of the step part around it)."""
from __future__ import annotations

import collections
import re

import torch

WINDOW = "bench/profiled_steps"


def _intervals(events):
    """Merged, sorted (start, end) intervals of events."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_labels(host, starts):
    """For each time of ``starts`` (ascending), what the host was doing:
    the innermost host operation under way (the latest begun of those
    not yet ended), prefixed with the benchmark's part range around it."""
    parts = [e for e in host if e.name.startswith("bench/") and e.name != WINDOW]
    ops = sorted((e for e in host if not e.name.startswith("bench/")),
                 key=lambda e: e.time_range.start)
    j, active, out = 0, [], []
    for t in starts:
        while j < len(ops) and ops[j].time_range.start <= t:
            active.append(ops[j])
            j += 1
        active = [e for e in active if e.time_range.end > t]
        inner = max(active, key=lambda e: e.time_range.start).name \
            if active else "no host operation"
        part = next((p.name for p in parts
                     if p.time_range.start <= t < p.time_range.end), None)
        out.append(f"{part}: {inner}" if part else inner)
    return out


def _is_port_kernel(name: str, kernel_names) -> bool:
    return any(re.search(r"(^|[\s:])" + k + r"\b", name) for k in kernel_names)


def profile_steps(step_fn, n: int, kernel_names) -> dict:
    """Run ``step_fn`` ``n`` times under the profiler, synchronised at
    both ends; seconds throughout, the window being the profiler's range
    around the steps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(n):
                step_fn()
            torch.cuda.synchronize()
    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]
    # a host range (record_function) is mirrored on the device's
    # timeline as an annotation, which is no device operation
    ranges = {e.name for e in host}
    device = [e for e in events
              if e.device_type == cuda and e.name not in ranges]
    window = next(e for e in host if e.name == WINDOW)
    lo, hi = window.time_range.start, window.time_range.end
    busy = [(max(s, lo), min(e, hi)) for s, e in _intervals(device)]
    busy_us = sum(e - s for s, e in busy if e > s)
    by_name = collections.Counter()
    for e in device:
        by_name[e.name] += e.time_range.end - e.time_range.start
    port_us = sum(us for name, us in by_name.items()
                  if _is_port_kernel(name, kernel_names))
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    spans = [(max(s, lo), min(e, hi)) for s, e in zip(edges[::2], edges[1::2])]
    spans = [(s, e) for s, e in spans if e > s]
    gaps = collections.Counter()
    for (s, e), label in zip(spans, _host_labels(host, [s for s, _ in spans])):
        gaps[label] += e - s
    return {
        "wall_s": (hi - lo) / 1e6, "steps": n, "busy_s": busy_us / 1e6,
        "port_kernel_s": port_us / 1e6,
        "breakdown": {
            "device_ops": [[k, v / 1e6] for k, v in by_name.most_common(10)],
            "idle_gaps": [[k, v / 1e6] for k, v in gaps.most_common(10)]},
    }
