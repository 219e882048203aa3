"""The port's spans (``instrument.span``) and the engine's counters
(``Engine.stats``), on a tiny synthetic scene through ``Engine.track_batch``.

* Under ``torch.profiler`` the batched path records its ``slam::`` spans,
  nested as the code nests them, and none of them is a user annotation (a
  user annotation is copied onto the device's timeline, where a reader of
  device events would take it for device work).
* Each tracked frame runs two pose optimizations of two rounds of
  ``pose_opt_iters`` LM iterations: ``slam::pose_opt`` counts 2 and
  ``slam::lm_iter`` 24 a frame.
* With no profiler active a span builds nothing, and the trajectory is the
  same bit for bit with spans on and off.
* A blanked stretch of frames counts a batch lost, its frames LOST and
  re-tracked one by one, and relocalization attempts; each keyframe that
  tracking inserted counts once under one trigger.
* On rendered stereo pairs (the KITTI00 preset at half size) the batched
  stereo frontend records one ``slam::stereo_match`` and one
  ``slam::sad_refine`` a batch, and ``slam::depth_spawn`` once a keyframe
  (the stereo initialization's included); ``stereo_features`` and
  ``stereo_matched`` count the valid left features and those with a right-x
  of the frames tracked, through ``track_batch`` and ``track_stereo``. The
  mono path records none of the three spans, and its counts stay 0.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dialog_tpu_torch import instrument
from dialog_tpu_torch.config import KITTI00, EngineConfig, Sensor
from dialog_tpu_torch.containers import FrameArrays
from dialog_tpu_torch.datasets import synth
from dialog_tpu_torch.frontend import extract_features, extract_features_batch
from dialog_tpu_torch.profile_main_path import render_stereo_frames
from dialog_tpu_torch.stereo import extract_and_match_stereo_batch, stereo_match_frames
from dialog_tpu_torch.system import LOST, OK, Engine

torch.set_num_threads(2)

CFG = EngineConfig(max_features=512, max_keyframes=64, max_landmarks=8192, max_local_lms=768,
                   max_frames_between_kf=8, vocab_words=128)
N, B = 32, 4
TRACED = (20, 24)          # the first and last batch traced in the clean run (a keyframe at 20)
BLANK = range(24, 28)      # the frames blanked in the occluded run
INIT_KFS = 2               # the monocular map starts from two keyframes


def _not_built(name):
    raise AssertionError(f"a span was built with no profiler active: {name}")


@pytest.fixture(scope="module")
def frames():
    scene = synth.make_scene(seed=51, n_points=700, n_frames=N, cfg=CFG)
    return [synth.observe(scene, i, noise_px=0.4, device="cpu")[0] for i in range(N)]


def _spans(prof):
    """(name, start ns, end ns, is a user annotation) of each ``slam::`` event."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("slam::")]


def _run(frames, n, blank=(), traced=None):
    """Batches of B over the first ``n`` frames; the batches that start in
    ``traced`` (first, last) run under the profiler. Returns the engine and
    the traced spans."""
    eng = Engine(CFG, device="cpu")
    eng.loop_closing_enabled = False
    prof, spans = None, []
    for i in range(0, n, B):
        if traced is not None and i == traced[0]:
            prof = profile(activities=[ProfilerActivity.CPU])
            prof.__enter__()
        batch = [frames[j]._replace(valid=torch.zeros_like(frames[j].valid)) if j in blank else frames[j]
                 for j in range(i, i + B)]
        eng.track_batch(FrameArrays(*[torch.stack(x) for x in zip(*batch)]), [j / 30.0 for j in range(i, i + B)])
        if traced is not None and i == traced[1]:
            prof.__exit__(None, None, None)
            spans = _spans(prof)
    eng.flush()
    return eng, spans


@pytest.fixture(scope="module")
def plain(frames):
    """The clean run with spans off: building one raises."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(instrument, "_RecordFunctionFast", _not_built)
        return _run(frames, N)[0]


@pytest.fixture(scope="module")
def traced(frames):
    """The clean run, two batches after initialization under the profiler."""
    return _run(frames, N, traced=TRACED)


@pytest.fixture(scope="module")
def occluded(frames):
    """Frames 24-27 blanked; the next batch, whose call finds the loss and recovers, traced."""
    return _run(frames, N, blank=BLANK, traced=(28, 28))


def _count(spans, name):
    return sum(1 for s in spans if s[0] == name)


def _inside(spans, child, parent):
    """Every ``child`` span lies inside some ``parent`` span (and there is one)."""
    kids = [s for s in spans if s[0] == child]
    outer = [s for s in spans if s[0] == parent]
    return bool(kids) and all(any(p[1] <= c[1] and c[2] <= p[2] for p in outer) for c in kids)


BATCHED_PATH = ["slam::track_batch", "slam::resolve_batch", "slam::pull_wait", "slam::track_multi",
                "slam::track_step", "slam::motion_search", "slam::local_map_search", "slam::pose_opt",
                "slam::lm_iter", "slam::keyframe", "slam::kf_insert", "slam::triangulate", "slam::fuse",
                "slam::local_ba", "slam::bow_row"]


@pytest.mark.parametrize("child, parent", [
    ("slam::pose_opt", "slam::track_step"), ("slam::track_step", "slam::track_multi"),
    ("slam::track_multi", "slam::track_batch"), ("slam::lm_iter", "slam::pose_opt"),
    ("slam::motion_search", "slam::track_step"), ("slam::local_map_search", "slam::track_multi"),
    ("slam::pull_wait", "slam::resolve_batch"), ("slam::resolve_batch", "slam::track_batch"),
    ("slam::keyframe", "slam::resolve_batch"), ("slam::kf_insert", "slam::keyframe"),
    ("slam::triangulate", "slam::kf_insert"), ("slam::fuse", "slam::kf_insert"),
    ("slam::local_ba", "slam::keyframe"), ("slam::bow_row", "slam::keyframe"),
])
def test_the_batched_path_nests_its_spans_as_named(traced, child, parent):
    _, spans = traced
    assert set(BATCHED_PATH) <= {s[0] for s in spans}
    assert _inside(spans, child, parent)


def test_no_span_is_a_user_annotation(traced, occluded):
    spans = traced[1] + occluded[1]
    assert spans and not any(s[3] for s in spans)


def test_the_pose_step_counts_two_calls_and_24_iterations_a_tracked_frame(traced):
    eng, spans = traced
    assert _count(spans, "slam::relocalize") == _count(spans, "slam::retrack") == 0
    frames = _count(spans, "slam::track_step")
    assert frames == B * _count(spans, "slam::track_multi") == TRACED[1] + B - TRACED[0]
    assert (eng.cfg.pose_opt_rounds, eng.cfg.pose_opt_iters) == (2, 6)
    assert _count(spans, "slam::pose_opt") == 2 * frames
    assert _count(spans, "slam::lm_iter") == 24 * frames


def test_the_frontend_records_its_span():
    cfg = EngineConfig(width=160, height=120, n_features=100, max_features=128)
    imgs = torch.zeros((2, 120, 160))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        extract_features_batch(imgs, cfg)
        extract_features(imgs[0], cfg)
    assert _count(_spans(prof), "slam::frontend") == 2


def test_with_no_profiler_a_span_builds_nothing(monkeypatch):
    monkeypatch.setattr(instrument, "_RecordFunctionFast", _not_built)
    assert not torch.autograd.profiler._is_profiler_enabled
    s = instrument.span("slam::x")
    assert s is instrument.span("slam::y")
    with s:
        pass


def test_the_trajectory_is_the_same_with_spans_on_and_off(plain, traced):
    on, off = traced[0], plain
    assert len(on.trajectory) == len(off.trajectory) == N
    for a, b in zip(on.trajectory, off.trajectory):
        assert (a.frame_id, a.state, a.n_tracked, a.ref_kf) == (b.frame_id, b.state, b.n_tracked, b.ref_kf)
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.t, b.t)
    assert on.stats == off.stats


def test_a_blanked_batch_counts_its_loss_and_recovery(plain, occluded):
    eng, spans = occluded
    st, clean = eng.stats, plain.stats
    assert clean["lost_batched"] == clean["lost_frames"] == clean["reloc_attempts"] == 0
    assert st["lost_batched"] == 1
    assert st["lost_frames"] == sum(1 for r in eng.trajectory if r.state == LOST) >= len(BLANK)
    assert st["retracked"] > clean["retracked"]
    assert st["reloc_attempts"] >= st["relocalizations"] >= 1
    assert eng.state == OK
    # the traced stretch holds the whole recovery: its spans count what the counters count
    assert _count(spans, "slam::relocalize") == st["reloc_attempts"]
    assert _count(spans, "slam::retrack") >= 1


@pytest.mark.parametrize("run", ["plain", "occluded"])
def test_keyframe_triggers_sum_to_the_keyframes_after_initialization(request, run):
    eng = request.getfixturevalue(run)
    eng = eng[0] if isinstance(eng, tuple) else eng
    st = eng.stats
    assert st["kf_weak"] + st["kf_starving"] + st["kf_stale"] == eng.kf_count - INIT_KFS > 0
    assert st["vocab_trains"] >= 1


STEREO_CFG = EngineConfig(width=620, height=188, fx=KITTI00.fx / 2, fy=KITTI00.fy / 2, cx=KITTI00.cx / 2,
                          cy=KITTI00.cy / 2, bf=KITTI00.bf / 2, th_depth=KITTI00.th_depth, sensor=Sensor.STEREO,
                          n_features=600, max_features=640, max_keyframes=32, max_landmarks=4096,
                          max_local_lms=1024, max_local_kfs=6, max_fixed_kfs=4, max_obs_per_lm=8,
                          max_frames_between_kf=4, vocab_words=128)
STEREO_N = 12
STEREO_SPANS = ("slam::stereo_match", "slam::sad_refine", "slam::depth_spawn")


def _counts(frames):
    """(valid left features, those with a right-x) of a frame or a batch."""
    return int(frames.valid.sum()), int((frames.valid & (frames.u_right >= 0)).sum())


@pytest.fixture(scope="module")
def stereo_pairs():
    _, pairs = render_stereo_frames(STEREO_CFG, STEREO_N)
    return torch.stack([torch.as_tensor(l) for l, _ in pairs]), torch.stack([torch.as_tensor(r) for _, r in pairs])


@pytest.fixture(scope="module")
def stereo_traced(stereo_pairs):
    """The stereo pairs in batches of B through the batched stereo frontend and ``track_batch``,
    all under the profiler; the first batch initializes frame by frame."""
    left, right = stereo_pairs
    eng = Engine(STEREO_CFG, device="cpu")
    eng.loop_closing_enabled = False
    fed = [0, 0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(0, STEREO_N, B):
            batch = extract_and_match_stereo_batch(left[i : i + B], right[i : i + B], STEREO_CFG)
            fed = [a + b for a, b in zip(fed, _counts(batch))]
            eng.track_batch(batch, [j / 10.0 for j in range(i, i + B)])
        eng.flush()
    return eng, _spans(prof), fed


def test_the_batched_stereo_path_records_its_spans(stereo_traced):
    eng, spans, _ = stereo_traced
    batches = STEREO_N // B
    assert _count(spans, "slam::stereo_match") == _count(spans, "slam::sad_refine") == batches
    assert _inside(spans, "slam::sad_refine", "slam::stereo_match")
    assert [r.state for r in eng.trajectory] == [OK] * STEREO_N
    # one a keyframe: the stereo initialization's first, then one inside each keyframe's insertion
    assert _count(spans, "slam::depth_spawn") == eng.kf_count >= 3
    inserts = [s for s in spans if s[0] == "slam::kf_insert"]
    in_insert = [d for d in spans
                 if d[0] == "slam::depth_spawn" and any(p[1] <= d[1] and d[2] <= p[2] for p in inserts)]
    assert len(in_insert) == len(inserts) == eng.kf_count - 1


def test_the_mono_path_records_no_stereo_span(traced, occluded):
    names = {s[0] for s in traced[1] + occluded[1]}
    assert names and not names & set(STEREO_SPANS)


def test_the_stereo_counts_are_the_frames_tracked(stereo_traced):
    eng, _, (n_features, n_matched) = stereo_traced
    st = eng.stats
    assert (st["stereo_features"], st["stereo_matched"]) == (n_features, n_matched)
    assert 0 < st["stereo_matched"] <= st["stereo_features"]
    assert eng._stereo_acc is None


def test_track_stereo_counts_each_pair(stereo_pairs):
    left, right = stereo_pairs
    eng = Engine(STEREO_CFG, device="cpu")
    eng.loop_closing_enabled = False
    want = [0, 0]
    for i in range(2):
        eng.track_stereo(left[i], right[i], i / 10.0)
        f = stereo_match_frames(extract_features(left[i], STEREO_CFG), extract_features(right[i], STEREO_CFG),
                                STEREO_CFG, img_left=left[i], img_right=right[i])
        want = [a + b for a, b in zip(want, _counts(f))]
    assert eng._stereo_acc is not None   # summed on the device, read at the flush
    eng.flush()
    assert [eng.stats["stereo_features"], eng.stats["stereo_matched"]] == want


@pytest.mark.parametrize("run", ["plain", "occluded"])
def test_the_mono_path_counts_no_stereo_feature(request, run):
    eng = request.getfixturevalue(run)
    eng = eng[0] if isinstance(eng, tuple) else eng
    assert eng.stats["stereo_features"] == eng.stats["stereo_matched"] == 0
    assert eng._stereo_acc is None
