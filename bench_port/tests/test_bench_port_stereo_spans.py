"""The readers of the stereo cell's spans (``slam::stereo_match`` around ``stereo.stereo_match_frames``,
``slam::depth_spawn`` around ``mapping.spawn_depth_landmarks``) on a recorded profiler table: kineto's
raw events, made by hand. A value where the span is present, None where it is absent (the program
before the spans records none)."""

from __future__ import annotations

import pytest

from bench_port import run, trace

from .test_bench_port_trace import CPU, CUDA, Ev

EVENTS = [
    Ev("bench::stereo", CPU, 0, 3, corr=1),
    Ev("slam::stereo_match", CPU, 0.1, 2.8, corr=2), Ev("slam::sad_refine", CPU, 2.0, 0.5, corr=3),
    Ev("cudaLaunchKernel", CPU, 1.0, 0.01, corr=4),
    Ev("sm80_xmma_gemm_f32f32_f32f32_f32_nn", CUDA, 1.1, 0.4, linked=4),
    Ev("bench::keyframe", CPU, 4, 9, corr=5),
    Ev("slam::depth_spawn", CPU, 4.2, 0.6, corr=6), Ev("slam::fuse", CPU, 5, 3, corr=7),
    Ev("bench::keyframe", CPU, 14, 8, corr=8),
    Ev("slam::depth_spawn", CPU, 14.1, 0.4, corr=9),
]
SPANS = {"stereo_host_ms": "slam::stereo_match", "depth_spawn_host_ms": "slam::depth_spawn"}


@pytest.fixture
def recorded():
    device, host, ranges = trace.reduce_events(EVENTS, CUDA)
    return trace.Trace(window_s=0.030, busy_s=4e-7, device=device, host=host, ranges=ranges, frames=8, keyframes=2,
                       shapes={"fast": [], "hamming": [], "schur": []}, frame_ms=[])


def read(name, t):
    return run.load_reader(name)(t)


def test_the_stereo_readers_on_a_recorded_table(recorded):
    t = recorded
    assert read("stereo_host_ms", t) == pytest.approx(2.8 / 8)
    assert read("depth_spawn_host_ms", t) == pytest.approx((0.6 + 0.4) / 2)
    assert read("stereo_device_ms", t) == pytest.approx(0.4 / 8)
    # the span sits inside the harness's range that times the same layer from outside
    assert read("stereo_host_ms", t) <= trace.host_ns_of(t, "stereo")[1] / 1e6 / t.frames


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_stereo_reader_is_absent_without_its_span(recorded, metric):
    host = {k: v for k, v in recorded.host.items() if k != SPANS[metric]}
    assert read(metric, recorded._replace(host=host)) is None


def test_the_stereo_reader_is_absent_without_frames(recorded):
    assert read("stereo_host_ms", recorded._replace(frames=0)) is None
