"""The per-layer readers on a recorded profiler table: kineto's raw events, made by hand."""

from __future__ import annotations

import pytest

from bench_port import run, trace

MS = 1_000_000


class Ev:
    """The part of a kineto event the harness reads."""

    def __init__(self, name, dev, start_ms, dur_ms, corr=0, linked=0):
        self._a = (name, dev, int(start_ms * MS), int(dur_ms * MS), corr, linked)

    def name(self):
        return self._a[0]

    def device_type(self):
        return self._a[1]

    def start_ns(self):
        return self._a[2]

    def duration_ns(self):
        return self._a[3]

    def correlation_id(self):
        return self._a[4]

    def linked_correlation_id(self):
        return self._a[5]

    def is_hidden_event(self):
        return False


CPU, CUDA = "cpu", "cuda"
EVENTS = [
    Ev("bench::frontend", CPU, 0, 2, corr=10), Ev("aten::mm", CPU, 1, 0.1, corr=1),
    Ev("bench::track_multi", CPU, 2, 6, corr=11), Ev("cudaLaunchKernel", CPU, 3, 0.01, corr=2),
    Ev("cudaStreamSynchronize", CPU, 5, 1, corr=3),
    Ev("bench::keyframe", CPU, 8.5, 1, corr=12), Ev("cudaMemcpy", CPU, 9, 0.3, corr=4),
    Ev("fast_levels_kernel(LevelTable, float, float, int)", CUDA, 1.5, 0.5, linked=1),
    Ev("void hamming_scan_kernel<4>(Args)", CUDA, 3.1, 1.0, linked=2),
    Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 9.0, 0.2, linked=4),
]


@pytest.fixture
def recorded():
    device, host, ranges = trace.reduce_events(EVENTS, CUDA)
    busy = 1e-9 * trace.union_seconds((e.start_ns, e.start_ns + e.dur_ns) for e in device)
    return trace.Trace(window_s=0.010, busy_s=busy, device=device, host=host, ranges=ranges, frames=2, keyframes=1,
                       shapes={"fast": [[(1, 100, 100)]], "hamming": [(10, 20)], "schur": []},
                       frame_ms=[float(i) for i in range(1, 101)])


def read(name, t):
    return run.load_reader(name)(t)


def test_the_idle_share_is_read_at_the_untraced_pace(recorded):
    # 1.7 ms busy over the 2 traced frames, at the untraced window's 100 frames/s
    assert read("device_idle_pct", recorded._replace(busy_frames=2, window_rate=100.0)) == pytest.approx(91.5)


def test_readers_on_a_recorded_table(recorded):
    t = recorded
    assert t.busy_s == pytest.approx(1.7e-3)
    assert read("device_idle_pct", t) == pytest.approx(83.0)
    assert read("launches_per_frame", t) == pytest.approx(1.0)
    assert read("syncs_per_frame", t) == pytest.approx(1.0)
    assert read("frontend_device_ms", t) == pytest.approx(0.25)
    assert read("track_host_ms.multi", t) == pytest.approx(3.0)
    assert read("track_host_ms.step", t) is None
    assert read("keyframe_host_ms", t) == pytest.approx(1.0)
    assert read("stereo_device_ms", t) is None
    assert read("fast_roofline_pct", t) == pytest.approx(100.0 * (8.0 * 1e4 / 3.35e12) / 0.5e-3)
    hb = 32.0 * 30 + 17.0 * 10 + 13.0 * 20 + 8.0 * 10
    assert read("hamming_roofline_pct", t) == pytest.approx(100.0 * (hb / 3.35e12) / 1.0e-3)
    assert read("schur_roofline_pct", t) is None   # no kernel C launch in the window: absent, not 0
    assert read("frame_ms_p95.online", t) == pytest.approx(95.0)


def test_device_time_is_attributed_by_the_launching_range(recorded):
    assert trace.device_ns_in(recorded, "track_multi") == 1 * MS
    assert trace.device_ns_in(recorded, "keyframe") == int(0.2 * MS)
    assert trace.host_ns_of(recorded, "track_multi") == (1, 6 * MS)


def test_breakdown_names_the_range_open_in_each_gap(recorded):
    b = run.breakdown(recorded)
    assert b["device_ops"][0][0].startswith("void hamming_scan_kernel")
    gaps = dict(b["idle_gaps"])
    # each gap goes to the innermost range open at its midpoint: 2.0-3.1 ms and 4.1-9.0 ms both in track_multi
    assert gaps == {"track_multi": pytest.approx((3.1 - 2.0 + 9.0 - 4.1) * 1e-3)}


def test_nested_ranges_count_once():
    rs = [(0, 10), (2, 3), (12, 20)]
    assert trace.outermost(rs) == [(0, 10), (12, 20)]
    assert trace.within(trace.outermost(rs), 15) and not trace.within(trace.outermost(rs), 11)
