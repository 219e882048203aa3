"""The port's instrumentation: ``RunLogger``, ``FrameTimer``, ``profile_trace``
and the engine's three capacity events.

Tolerances: the JSONL rows equal the reference's ``RunLogger`` rows for the
same records, key by key, except ``wall_ms`` (the caller's clock); the
timer's statistics equal numpy's on the recorded times. The engine events
(``lm_freelist_full``, ``kf_slots_full``, ``gba_obs_dropped``) appear in the
log of an engine run at small capacities, with the counts of
``Engine.stats``, as ``tests/test_system_modes.py::test_runlogger_records_gba_event``
checks the reference's.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dialog_tpu import instrument as jinstrument
from dialog_tpu_torch import instrument
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.datasets import synth
from dialog_tpu_torch.system import Engine

torch.set_num_threads(2)


def _records(n=6, seed=0):
    rng = np.random.default_rng(seed)
    states = ["NOT_INITIALIZED", "OK", "OK", "LOST", "OK", "OK"]
    return [SimpleNamespace(frame_id=i, timestamp=1305031102.175 + 0.033 * i, state=states[i % len(states)],
                            n_tracked=int(rng.integers(0, 500)), ref_kf=int(rng.integers(-1, 9)),
                            t=rng.normal(0, 3, 3).astype(np.float32)) for i in range(n)]


def test_runlogger_rows_equal_the_reference(tmp_path):
    recs = _records()
    logs = {}
    for name, mod in (("port", instrument), ("ref", jinstrument)):
        log = mod.RunLogger(str(tmp_path / f"{name}.jsonl"))
        for k, r in enumerate(recs):
            log.log_frame(r, 0.001 * (k + 1) if name == "port" else 0.5, extra={"kfs": k} if k % 2 else None)
        log.log_event("kf_slots_full", count=3)
        log.close()
        assert log.frames == len(recs)
        logs[name] = [json.loads(line) for line in (tmp_path / f"{name}.jsonl").read_text().splitlines()]
    assert len(logs["port"]) == len(recs) + 1
    for p, r in zip(logs["port"], logs["ref"]):
        p.pop("wall_ms", None)
        r.pop("wall_ms", None)
        assert p == r
    assert logs["port"][0]["frame"] == 0 and "wall_ms" not in logs["port"][-1]
    silent = instrument.RunLogger()   # no path: counts frames, writes nothing
    silent.log_frame(recs[0], 0.1)
    silent.log_event("x")
    assert silent.frames == 1


def test_frame_timer_stats():
    timer = instrument.FrameTimer()
    assert timer.stats() == {}
    timer.times = [0.030, 0.010, 0.020, 0.050]
    t = np.sort(np.asarray(timer.times))
    want = {"median_ms": float(np.median(t) * 1e3), "mean_ms": float(t.mean() * 1e3),
            "p90_ms": float(np.percentile(t, 90) * 1e3), "fps": float(1.0 / t.mean())}
    assert timer.stats() == pytest.approx(want, rel=1e-12)
    assert timer.stats() == pytest.approx(jinstrument.FrameTimer.stats(timer), rel=1e-12)
    with timer.frame():
        pass
    assert len(timer.times) == 5 and timer.times[-1] >= 0.0


def test_profile_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with instrument.profile_trace(str(tmp_path / "trace"), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_engine_capacity_events_reach_the_log(tmp_path):
    """Small keyframe and landmark stores and two observations a landmark:
    the free lists run out and the global problem cuts observations; each
    shows in the log with the engine's own count."""
    cfg = EngineConfig(max_features=512, max_frames_between_kf=3, max_keyframes=8, max_local_kfs=4, max_fixed_kfs=4,
                       max_landmarks=400, max_local_lms=400, max_obs_per_lm=2, max_new_landmarks=512)
    scene = synth.make_scene(seed=7, n_points=4000, n_frames=30, trajectory="loop", cfg=cfg, period=200)
    eng = Engine(cfg, device="cpu")
    eng.logger = instrument.RunLogger(str(tmp_path / "run.jsonl"))
    for i in range(30):
        fr, _ = synth.observe(scene, i, noise_px=0.5, device="cpu")
        eng.track_features(fr, i / 30.0)
    eng._start_gba(iters=1)     # the event path of a closure's global BA, directly
    eng.flush()
    eng.logger.close()
    rows = [json.loads(line) for line in (tmp_path / "run.jsonl").read_text().splitlines()]
    events = {}
    for r in rows:
        events.setdefault(r["event"], []).append(r)
    assert eng.stats["gba_runs"] == 1
    assert eng.stats["lm_dropped"] > 0 and events["lm_freelist_full"][-1]["dropped"] == eng.stats["lm_dropped"]
    assert eng.stats["kf_slot_full"] > 0 and events["kf_slots_full"][-1]["count"] == eng.stats["kf_slot_full"]
    assert eng.stats["gba_obs_dropped"] > 0 and sum(r["n"] for r in events["gba_obs_dropped"]) == \
        eng.stats["gba_obs_dropped"]
