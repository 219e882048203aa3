"""The readers of the port's own spans (``slam::<part>``, ``dialog_tpu_torch.instrument.span``) on a
recorded profiler table: kineto's raw events, made by hand. A span is a host event of operator scope,
so it lands in the trace's host table by name, and nowhere on the device's timeline."""

from __future__ import annotations

import pytest

from bench_port import run, trace

from .test_bench_port_trace import CPU, CUDA, Ev

EVENTS = [
    Ev("bench::track_multi", CPU, 0, 10, corr=1),
    Ev("slam::track_multi", CPU, 0.1, 9.8, corr=2),
    Ev("slam::local_map_search", CPU, 0.2, 0.3, corr=3),
    Ev("slam::motion_search", CPU, 0.5, 1.0, corr=4), Ev("slam::pose_opt", CPU, 1.5, 2.0, corr=5),
    Ev("slam::local_map_search", CPU, 3.5, 0.5, corr=6), Ev("slam::pose_opt", CPU, 4.0, 2.0, corr=7),
    Ev("slam::motion_search", CPU, 6.0, 1.0, corr=8), Ev("slam::pose_opt", CPU, 7.0, 1.0, corr=9),
    Ev("slam::local_map_search", CPU, 8.0, 0.5, corr=10), Ev("slam::pose_opt", CPU, 8.5, 1.0, corr=11),
    Ev("slam::pull_wait", CPU, 10.5, 0.4, corr=12),
    Ev("bench::keyframe", CPU, 11, 9, corr=13),
    Ev("slam::fuse", CPU, 12, 3, corr=14), Ev("slam::local_ba", CPU, 15, 4, corr=15),
    Ev("cudaLaunchKernel", CPU, 4.1, 0.01, corr=16),
    Ev("void getrf_pivot(float)", CUDA, 4.2, 0.05, linked=16),
]


@pytest.fixture
def recorded():
    device, host, ranges = trace.reduce_events(EVENTS, CUDA)
    return trace.Trace(window_s=0.020, busy_s=5e-8, device=device, host=host, ranges=ranges, frames=2, keyframes=1,
                       shapes={"fast": [], "hamming": [], "schur": []}, frame_ms=[])


def read(name, t):
    return run.load_reader(name)(t)


def test_the_span_readers_on_a_recorded_table(recorded):
    t = recorded
    assert read("pose_host_ms", t) == pytest.approx((2.0 + 2.0 + 1.0 + 1.0) / 2)
    assert read("search_host_ms", t) == pytest.approx((1.0 + 1.0 + 0.3 + 0.5 + 0.5) / 2)
    assert read("pull_wait_ms", t) == pytest.approx(0.4 / 2)
    assert read("local_ba_host_ms", t) == pytest.approx(4.0)
    assert read("fuse_host_ms", t) == pytest.approx(3.0)
    # the spans sit inside the harness's ranges that time the same layers from outside
    assert read("pose_host_ms", t) + read("search_host_ms", t) <= read("track_host_ms.multi", t)
    assert read("local_ba_host_ms", t) + read("fuse_host_ms", t) <= read("keyframe_host_ms", t)


def test_a_span_is_neither_a_range_nor_device_work(recorded):
    assert set(recorded.ranges) == {"track_multi", "keyframe"}
    assert [e.name for e in recorded.device] == ["void getrf_pivot(float)"]
    assert not any(k.startswith("slam::") for k, _ in run.breakdown(recorded)["device_ops"])


SPANS = {"pose_host_ms": ("slam::pose_opt",), "pull_wait_ms": ("slam::pull_wait",),
         "local_ba_host_ms": ("slam::local_ba",), "fuse_host_ms": ("slam::fuse",),
         "search_host_ms": ("slam::motion_search", "slam::local_map_search")}


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_reader_is_absent_without_its_span(recorded, metric):
    # the program before its spans (the parent of the change that added them) records none
    host = {k: v for k, v in recorded.host.items() if k not in SPANS[metric]}
    assert read(metric, recorded._replace(host=host)) is None


@pytest.mark.parametrize("metric", ["pose_host_ms", "search_host_ms", "pull_wait_ms"])
def test_a_per_frame_reader_is_absent_without_frames(recorded, metric):
    assert read(metric, recorded._replace(frames=0)) is None


def test_the_search_reader_takes_either_search_alone(recorded):
    host = {k: v for k, v in recorded.host.items() if k != "slam::local_map_search"}
    assert read("search_host_ms", recorded._replace(host=host)) == pytest.approx(2.0 / 2)
