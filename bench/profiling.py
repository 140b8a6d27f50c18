"""The traced window: ``torch.profiler`` over the device and the host, read
into the device's busy time, each kernel's device time, the top device
operations and the idle gaps by what the host was doing.

The approach is that of the port's smoke harness (``chip_smoke.py::
profiled``: the device's own events under the profiler, summed by name),
copied here and extended with timestamps: the window is the span of the
``bench.window`` annotation, busy time is the union of the device events
inside it (kernels, copies, fills), and an idle gap is named after the
innermost host event that covers its middle.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"
TOP = 10
# a device operation's name in the breakdown is cut to this many characters
NAME_CHARS = 120


@dataclass
class Trace:
    """What the per-layer readers read. Times in seconds."""
    requests: int = 0
    spans: dict = field(default_factory=dict)      # name -> [seconds]
    bounds: dict = field(default_factory=dict)     # op -> [bound seconds]
    kernel_s: dict = field(default_factory=dict)   # device op name -> seconds
    busy_s: float = 0.0
    window_s: float = 0.0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def short_name(name: str) -> str:
    """A device operation's name without its return type and argument
    list (template arguments stay)."""
    name = name.strip()
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i in range(len(name) - 1, -1, -1) if name.endswith(")") else ():
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            name = name[:i]
            break
    return name.replace("(anonymous namespace)::", "")


@contextlib.contextmanager
def traced(trace: Trace, annotations: set):
    """Profile the enclosed window into ``trace``. ``annotations`` are the
    names of the harness's own spans, which the profiler also reports as
    device-side ranges; they are not device work."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    read_profile(prof.events(), trace, annotations | {WINDOW})


def _union(intervals):
    """Total length and the gaps of a list of (start, end)."""
    busy, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def _name_gaps(host, gaps):
    """Seconds of idle time by the innermost host event that covers each
    gap's middle (host events nest on the thread that runs the requests,
    so a stack of the open ones holds the innermost on top)."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))  # outer before inner
    idle: dict = {}
    stack, j = [], 0
    for s, t in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (s + t) / 2
        while j < len(host) and host[j][0] <= mid:
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host outside any traced op"
        idle[name] = idle.get(name, 0.0) + (t - s) * 1e-6
    return idle


def read_profile(events, trace: Trace, annotations: set) -> None:
    cuda = torch.autograd.DeviceType.CUDA
    window = [e for e in events if e.name == WINDOW
              and e.device_type != cuda]
    if not window:
        raise RuntimeError("the profile holds no window annotation")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    dev, host = [], []
    for e in events:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        if e.device_type == cuda:
            if e.name in annotations or getattr(e, "is_user_annotation",
                                                False):
                continue
            dev.append((s, t, short_name(e.name)))
        elif e.name != WINDOW:
            host.append((s, t, e.name))
    busy, gaps = _union([(s, t) for s, t, _ in dev])
    if dev:
        first = min(s for s, _, _ in dev)
        last = max(t for _, t, _ in dev)
        gaps = ([(w0, first)] if first > w0 else []) + gaps + (
            [(last, w1)] if w1 > last else [])
    else:
        gaps = [(w0, w1)]
    kernel_s: dict = {}
    for s, t, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (t - s) * 1e-6
    idle = _name_gaps(host, gaps)
    trace.kernel_s = kernel_s
    trace.busy_s = busy * 1e-6
    trace.window_s = (w1 - w0) * 1e-6
    trace.device_ops = [(name[:NAME_CHARS], secs) for name, secs in sorted(
        kernel_s.items(), key=lambda kv: -kv[1])[:TOP]]
    trace.idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]


def span_ms(t: Trace, name: str):
    """Milliseconds a request spends in span ``name``: its calls summed
    over the traced window and divided by its requests; None where it
    never ran."""
    spans = t.spans.get(name)
    return 1e3 * sum(spans) / t.requests if spans else None


def idle_pct(t: Trace):
    """The share of the traced window, in %, in which no operation ran on
    the device (kernels, copies and fills)."""
    if t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
