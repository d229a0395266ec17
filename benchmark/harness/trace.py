"""Reduce a ``torch.profiler`` run to what the per-layer readers need.

Device time is counted as ``chip_smoke.device_rows`` counts it: the events
whose device type is CUDA (kernels, copies, memsets), never the CPU-side
operators, whose device time is that of the kernels they launched.  Busy
time is the union of the device intervals inside the traced window, so
overlapping kernels count once.  Each idle stretch of the device is named
by the innermost host operation of the benchmark's thread that was running
in its middle.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Device rows that are PyTorch's or another library's and not the program's
# own kernels: copies, memsets and every kernel of a library namespace.
LIBRARY_PREFIXES = ("Memcpy", "Memset")
LIBRARY_MARKERS = ("at::", "c10::", "cub::", "thrust::", "cutlass", "cublas", "cudnn",
                   "nccl", "xmma", "nvjet")


def is_library(name: str) -> bool:
    """Whether a device row is a copy, a memset or a library's kernel."""
    return name.startswith(LIBRARY_PREFIXES) or any(m in name for m in LIBRARY_MARKERS)


@dataclass
class Interval:
    name: str
    start: float  # µs, the profiler's clock
    end: float


@dataclass
class TraceData:
    window: Interval  # the traced stretch, from the benchmark's own span
    device: list[Interval] = field(default_factory=list)
    host: list[Interval] = field(default_factory=list)  # the benchmark's thread
    rows: list[tuple[float, str, int]] = field(default_factory=list)  # device_rows


def device_rows(device: list[Interval]) -> list[tuple[float, str, int]]:
    """(device µs, name, count) of each kernel and copy, largest first: the
    arithmetic of ``chip_smoke.device_rows`` (each device row's own time,
    summed by name), over the device intervals of :func:`collect`."""
    sums: dict[str, list] = {}
    for iv in device:
        acc = sums.setdefault(iv.name, [0.0, 0])
        acc[0] += iv.end - iv.start
        acc[1] += 1
    return sorted(((us, name, n) for name, (us, n) in sums.items()), reverse=True)


def collect(prof, window_name: str) -> TraceData:
    """The window, the device intervals and the host intervals of the
    window's thread, from a finished ``torch.profiler`` run.

    Reads the profiler's raw events (``prof.profiler.kineto_results``): the
    parse into ``FunctionEvent`` trees that ``prof.events()`` and
    ``key_averages()`` make took 70-116 s over a few tens of requests.  A
    span's annotation on the device's timeline (a user annotation, or a
    device event named like a host event) is not device work and is left
    out."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window = next(ev for ev in events
                  if ev.name() == window_name and ev.device_type() != DeviceType.CUDA)

    def interval(ev) -> Interval:
        return Interval(ev.name(), ev.start_ns() / 1e3, (ev.start_ns() + ev.duration_ns()) / 1e3)

    data = TraceData(interval(window))
    host_names = {ev.name() for ev in events if ev.device_type() != DeviceType.CUDA}
    thread = window.start_thread_id()
    for ev in events:
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation() and ev.name() not in host_names:
                data.device.append(interval(ev))
        elif ev.start_thread_id() == thread and ev.name() != window_name:
            data.host.append(interval(ev))
    data.rows = device_rows(data.device)
    return data


def busy_intervals(device: list[Interval], window: Interval) -> list[tuple[float, float]]:
    """The union of the device intervals clipped to the window, merged."""
    spans = sorted((max(iv.start, window.start), min(iv.end, window.end)) for iv in device)
    merged: list[list[float]] = []
    for s, e in spans:
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_us(device: list[Interval], window: Interval) -> float:
    return sum(e - s for s, e in busy_intervals(device, window))


def idle_gaps(device: list[Interval], window: Interval) -> list[tuple[float, float]]:
    """The stretches of the window in which no device operation ran."""
    gaps, at = [], window.start
    for s, e in busy_intervals(device, window):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if window.end > at:
        gaps.append((at, window.end))
    return gaps


def idle_by_host(data: TraceData) -> dict[str, float]:
    """Idle µs of the device by the innermost host operation running in the
    middle of each gap (host operations of one thread nest)."""
    gaps = sorted(((s + e) / 2, e - s) for s, e in idle_gaps(data.device, data.window))
    host = sorted(data.host, key=lambda iv: (iv.start, -iv.end))
    out: dict[str, float] = {}
    stack: list[Interval] = []
    i = 0
    for mid, dur in gaps:
        while i < len(host) and host[i].start <= mid:
            while stack and stack[-1].end <= host[i].start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        name = stack[-1].name if stack else "(no host operation)"
        out[name] = out.get(name, 0.0) + dur
    return out


def top(items: dict[str, float], n: int = 10) -> list[list]:
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:n]]
