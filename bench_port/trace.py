"""What a traced run's metric readers read: the profiler's events, reduced once.

The device's busy time is the union of its kernel, copy and set intervals
(the arithmetic of the port's ``profile_main_path._union_seconds`` and
``read_profile``, copied here). A device event is attributed to the host
ranges (``torch.profiler.record_function``, named ``bench::<layer>``) that
contain the host event that launched it, found by the profiler's
correlation id, so a layer's device time is the time of the kernels its
calls launched, wherever on the device's timeline they ran.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

# the names torch.profiler leaves out of its event list (``torch.autograd.profiler._filter_name``)
_FILTERED = frozenset({"[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                       "profiler::_record_function_enter_new", "profiler::_record_function_exit", "aten::is_leaf",
                       "aten::output_nr", "aten::_version"})
RANGE_PREFIX = "bench::"


class DeviceEvent(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int
    launched_ns: int | None   # host time of the launching event, None where the profiler linked none


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    device: list            # [DeviceEvent]
    host: dict              # name -> (count, total ns), host operators and runtime calls
    ranges: dict            # layer name -> sorted [(start_ns, end_ns)]
    frames: int             # frames tracked in the traced window
    keyframes: int          # keyframes created in it
    shapes: dict            # kernel -> per-call shapes recorded by the harness
    frame_ms: list          # per-frame host time of the client's call (per-frame cells)
    busy_frames: int = 0    # frames of the stretch that ``busy_s`` and ``window_s`` are of
    window_rate: float = 0.0   # frames/s of the untraced window


def union_seconds(spans) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def reduce_events(events, device_type_cuda) -> tuple[list, dict, dict]:
    """(device events, host table, layer ranges) from kineto's raw events."""
    launch_at, device_raw, host, ranges = {}, [], {}, {}
    for e in events:
        name = e.name()
        if name in _FILTERED or e.is_hidden_event():
            continue
        if e.device_type() == device_type_cuda:
            if name.startswith(RANGE_PREFIX):
                continue   # the profiler's copy of a host range on the device's timeline, not device work
            device_raw.append((name, e.start_ns(), e.duration_ns(), e.linked_correlation_id()))
            continue
        launch_at[e.correlation_id()] = e.start_ns()
        n, ns = host.get(name, (0, 0))
        host[name] = (n + 1, ns + e.duration_ns())
        if name.startswith(RANGE_PREFIX):
            ranges.setdefault(name[len(RANGE_PREFIX):], []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    device = [DeviceEvent(n, s, d, launch_at.get(c) if c else None) for n, s, d, c in device_raw]
    return device, host, {k: sorted(v) for k, v in ranges.items()}


def within(ranges: list, t_ns: int | None) -> bool:
    """Does host time ``t_ns`` fall in one of the sorted, non-overlapping ``ranges``?"""
    if t_ns is None or not ranges:
        return False
    i = bisect.bisect_right(ranges, (t_ns, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= t_ns <= ranges[i][1]


def outermost(ranges: list) -> list:
    """The ranges not nested in an earlier one of the same list."""
    out = []
    for s, e in ranges:
        if out and s <= out[-1][1]:
            continue
        out.append((s, e))
    return out


def device_ns_in(trace: Trace, layer: str) -> int:
    """Device nanoseconds of the events launched inside ``layer``'s host ranges."""
    rs = outermost(trace.ranges.get(layer, []))
    return sum(ev.dur_ns for ev in trace.device if within(rs, ev.launched_ns))


def host_ns_of(trace: Trace, layer: str, outside: str | None = None) -> tuple[int, int]:
    """(count, host nanoseconds) of ``layer``'s outermost ranges, leaving out those inside ``outside``'s."""
    rs = outermost(trace.ranges.get(layer, []))
    if outside is not None:
        out_rs = outermost(trace.ranges.get(outside, []))
        rs = [r for r in rs if not within(out_rs, r[0])]
    return len(rs), sum(e - s for s, e in rs)


def kernel_ns(trace: Trace, names: tuple[str, ...]) -> tuple[int, int]:
    """(launches, device nanoseconds) of the kernels whose profiler name contains one of ``names``."""
    n = ns = 0
    for ev in trace.device:
        if any(k in ev.name for k in names):
            n += 1
            ns += ev.dur_ns
    return n, ns


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))
