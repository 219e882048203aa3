"""The port's bench harness (``dialog_tpu_torch/bench.py``) against the
reference's ``bench.py``, on the CPU.

* The output stream: with the workloads' run functions replaced by fixed
  frames/s, the port's ``main`` prints the same JSON lines as bench.py's
  ``main`` (``bench.py:228-256``), line for line, under each ``--only``, and
  when a workload raises. bench.py's source runs here with a stand-in for
  ``jax.config`` at its module level, so that JAX's persistent compilation
  cache is not switched on for the test process.
* The schedule: the port's ``bench.schedule`` at a reduced warm-up (frames
  fed one by one, the batched warm-up's end, the blanked batch) over 56
  synthetic feature frames, against the JAX ``Engine`` driven by a copy of
  bench.py's loop (``tools/reference_ate.bench_schedule``) with the same
  parameters; the port takes every random draw from the reference's key
  stream (``ReferenceStream``). Gates: the same state on every frame, the
  same keyframes, camera positions within POS_TOL of each other, the same
  timed window. The stereo parameters on the schedule alone, with a stand-in
  engine: the window's first frame and count, the blanked frames.
* ``warm_loop_paths`` runs detection's dispatch and evaluate and leaves every
  field of the loop state as it found it.
* A small rendered mono run (320x240, 40 frames, a half batch blanked) through ``run_mono``:
  finite frames/s, OK at the end, the ``#`` line's fields.
"""

import collections
import importlib.util
import json
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch import bench, interop
from dialog_tpu_torch.config import EngineConfig as TConfig
from dialog_tpu_torch.containers import FrameArrays
from dialog_tpu_torch.datasets import synth as tsynth
from dialog_tpu_torch.system import LOST, OK, Engine as TEngine
from test_torch_batch_engine import ReferenceStream

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FPS = {10: 12.3456, 30: 23.4567, "stereo": 7.8912}   # rounding shows in both the value and vs_baseline
# test_torch_batch_engine's configuration: a local map and a codebook sized for the CPU
CFG = dict(max_features=512, max_keyframes=64, max_landmarks=8192, max_local_lms=768,
           max_frames_between_kf=8, vocab_words=128)
N = 56
WARMUP = dict(n_single=8, warm_end=40, occlude_at=24)
POS_TOL = 2e-4


def _load_tool():
    spec = importlib.util.spec_from_file_location("reference_ate", ROOT / "tools" / "reference_ate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the output stream --------------------------------------------------------

def _reference_main():
    """bench.py's ``main``, its module body run with ``jax.config.update`` a no-op."""
    stand_in = types.ModuleType("jax")
    stand_in.config = types.SimpleNamespace(update=lambda *a: None)
    mod = types.ModuleType("reference_bench")
    mod.__file__ = str(ROOT / "bench.py")
    sys.modules["jax"] = stand_in
    try:
        exec(compile((ROOT / "bench.py").read_text(), mod.__file__, "exec"), mod.__dict__)
    finally:
        sys.modules["jax"] = jax
    return mod


def _stereo(raises):
    def run(*a, **k):
        if raises:
            raise RuntimeError("stereo failed")
        return FPS["stereo"]
    return run


@pytest.mark.parametrize("case", ["all", "kf10", "kf30", "stereo", "stereo_raises"])
def test_stream_contract(monkeypatch, capsys, case):
    only = [] if case in ("all", "stereo_raises") else ["--only", case]
    raises = case == "stereo_raises"
    ref = _reference_main()
    monkeypatch.setattr(ref, "run_mono", lambda kf, *a: FPS[kf])
    monkeypatch.setattr(ref, "run_stereo_kitti", _stereo(raises))
    monkeypatch.setattr(jsynth, "make_scene", lambda **k: None)
    monkeypatch.setattr(jsynth, "render_image", lambda scene, i: np.zeros((2, 2), np.float32))
    monkeypatch.setattr(sys, "argv", ["bench.py", *only])
    monkeypatch.setattr(bench, "mono_images", lambda cfg, device: (None, []))
    monkeypatch.setattr(bench, "run_mono", lambda kf, *a, **k: FPS[kf])
    monkeypatch.setattr(bench, "run_stereo", _stereo(raises))
    outs = []
    for main in (ref.main, lambda: bench.main([*only, "--device", "cpu"])):
        if raises:
            with pytest.raises(RuntimeError, match="stereo failed"):
                main()
        else:
            main()
        outs.append(capsys.readouterr().out.splitlines())
    want, got = outs
    assert got == want
    lines = [json.loads(x) for x in got]
    last = {"kf30": "tum_mono_kf30", "stereo": "kitti_stereo"}.get(case, "tum_class_mono")
    assert lines[-1]["metric"] == f"tracking_fps_{last}"
    n = {"all": 6, "kf10": 3, "kf30": 3, "stereo": 2, "stereo_raises": 5}[case]
    assert len(lines) == n and "workloads" in lines[-1]


# --- the schedule ----------------------------------------------------------------

@pytest.fixture(scope="module")
def schedules():
    """Both engines through bench.py's schedule on the same synthetic frames."""
    scene = jsynth.make_scene(seed=51, n_points=700, n_frames=N, cfg=JConfig(**CFG))
    fj = [jsynth.observe(scene, i, noise_px=0.4)[0] for i in range(N)]
    ft = [interop.frame_from_numpy(jax.device_get(f), device="cpu") for f in fj]
    tool = _load_tool()
    jeng = JEngine(JConfig(**CFG))
    teng = TEngine(TConfig(**CFG), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        ReferenceStream().patch(mp)
        jrun = tool.bench_schedule(
            jeng, N, 30.0, lambda i: jeng.track_features(fj[i], i / 30.0),
            lambda i: jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *fj[i : i + bench.B]),
            lambda i: jeng.track_features(fj[i], i / 30.0), **WARMUP, B=bench.B)
        trun = bench.schedule(
            teng, N, 30.0, lambda i: teng.track_features(ft[i], i / 30.0),
            lambda i, n: FrameArrays(*[torch.stack(x) for x in zip(*ft[i : i + n])]),
            lambda i: teng.track_features(ft[i], i / 30.0), **WARMUP)
    return jeng, teng, jrun, trun


def _kf_frames(eng):
    valid = np.asarray(eng.m.kfs.valid)
    return sorted(np.asarray(eng.m.kfs.frame_id)[valid].tolist())


def test_bench_schedule_follows_the_reference(schedules):
    jeng, teng, jrun, trun = schedules
    states = [r.state for r in teng.trajectory]
    assert [r.frame_id for r in teng.trajectory] == list(range(N))
    assert states == [r.state for r in jeng.trajectory]
    # the blanked half batch goes LOST, and the run recovers by relocalization
    blanked = range(WARMUP["occlude_at"], WARMUP["occlude_at"] + bench.B // 2)
    assert all(states[i] == LOST for i in blanked) and teng.state == OK
    assert teng.stats["relocalizations"] >= 1
    assert teng.kf_count == jeng.kf_count >= 5 and _kf_frames(teng) == _kf_frames(jeng)
    ok = np.array([s == OK for s in states])
    pj = np.stack([-R.T @ t for R, t in jeng.final_poses()])
    pt = np.stack([-R.T @ t for R, t in teng.final_poses()])
    gap = np.abs(pj - pt)[ok]
    assert float(gap.max()) < POS_TOL, float(gap.max())
    assert (trun["start"], trun["n_timed"]) == (jrun["start"], jrun["n_timed"]) == (40, 8)
    # bench.py's count leaves the window's last batch out (ROADMAP R10)
    assert trun["frames_in_window"] == 16 and trun["fps"] == trun["n_timed"] / trun["seconds"]


Batch = collections.namedtuple("Batch", "valid")


class StandIn:
    """An engine that tracks nothing: LOST for ``lost`` frames after the warm-up."""

    def __init__(self, lost: int):
        self.frame_id, self.state, self._vocab, self.lost = 0, OK, None, lost
        self.batches, self.singles = [], []

    def track_batch(self, batch, ts):
        self.batches.append((round(ts[0] * 10.0), [round(t * 10.0) for t in ts], batch.valid.all(1).tolist()))
        self.frame_id += len(ts)
        self.state = LOST if self.lost else OK

    def single(self, i):
        self.singles.append(i)
        self.frame_id += 1
        if self.batches:
            self.lost -= 1
            self.state = LOST if self.lost else OK

    def flush(self):
        pass


@pytest.mark.parametrize("lost, start", [(0, 72), (5, 80)])
def test_stereo_schedule_window_and_blanked_frames(lost, start):
    """The warm-up's batches run from frame 4 to 67 (past warm_end, 64); the window starts at the next multiple of
    B after the frames fed until OK, so frames 68-71 are never fed when the run is OK after the warm-up."""
    eng = StandIn(lost)
    frames = Batch(valid=torch.ones(bench.B, 4, dtype=torch.bool))
    run = bench.schedule(eng, bench.STEREO_FRAMES, bench.STEREO_FPS, eng.single, lambda i, n: frames, eng.single,
                         n_single=bench.STEREO_SINGLE, warm_end=64, occlude_at=28)
    assert eng.singles == list(range(4)) + list(range(68, 68 + lost))
    firsts = [b[0] for b in eng.batches]
    assert firsts == list(range(4, 64, 8)) + list(range(start, 161, 8))
    assert all(b[1] == list(range(b[0], b[0] + 8)) for b in eng.batches)   # timestamps frame / 10 fps
    blank = {b[0]: b[2] for b in eng.batches if not all(b[2])}
    assert blank == {28: [False] * 4 + [True] * 4}
    assert (run["start"], run["n_timed"], run["frames_in_window"]) == (start, (161 - start) // 8 * 8,
                                                                        8 * len(range(start, 161, 8)))


def test_warm_loop_paths_restores_the_loop_state(schedules, monkeypatch):
    _, teng, _, _ = schedules
    assert teng._vocab is not None
    lc = teng._loop
    monkeypatch.setattr(lc, "_consistent", [({1, 2, 3}, 2)])
    monkeypatch.setattr(lc, "_pending_detect", (0, torch.zeros(1), torch.zeros(1), 3))
    monkeypatch.setattr(lc, "_eval_stamp", 7)
    monkeypatch.setattr(lc, "last_eval_det_seq", 5)
    evaluated = []
    evaluate = lc.evaluate
    monkeypatch.setattr(lc, "evaluate", lambda *a, **k: evaluated.append(evaluate(*a, **k)))
    before = dict(vars(lc))
    m, frame_id, kf_count = teng.m, teng.frame_id, teng.kf_count
    bench.warm_loop_paths(teng)
    assert len(evaluated) == 1
    after = dict(vars(lc))
    assert after.keys() == before.keys()
    for k in before:
        assert after[k] is before[k] or after[k] == before[k], k
    assert (teng.m, teng.frame_id, teng.kf_count) == (m, frame_id, kf_count)


def test_r2_a_non_finite_ate_reads_undefined():
    """R2: the ATE's similarity alignment divides by the spread of the estimate; every OK frame at one place makes it
    0/0, and the ``#`` line reads ``undefined``. Records pair with the scene's frames by timestamp (R10)."""
    rec = [types.SimpleNamespace(state=OK, timestamp=i / 10.0) for i in range(6)]
    eng = types.SimpleNamespace(trajectory=rec, positions=np.zeros((6, 3)), state=OK, kf_count=2,
                                stats={"relocalizations": 0}, _loop=types.SimpleNamespace(closed_loops=[]))
    scene = types.SimpleNamespace(R=np.tile(np.eye(3, dtype=np.float32), (8, 1, 1)),
                                  t=np.arange(24, dtype=np.float32).reshape(8, 3))
    run = dict(start=8, n_timed=0, frames_in_window=0, seconds=1.0)
    line = bench.run_summary(eng, scene, 10.0, run, with_scale=True, occlude_at=2, launches={}, batches=0)
    assert line["ate_m"] == "undefined" and line["frames_not_fed"] == [6, 7]
    assert line["ok_share"] == 1.0 and line["blanked"] == [2, 3, 4, 5]
    line = bench.run_summary(eng, scene, 10.0, run, with_scale=False, occlude_at=2, launches={}, batches=0)
    assert isinstance(line["ate_m"], float) and np.isfinite(line["ate_m"])


# --- a small rendered run ------------------------------------------------------------

def test_run_mono_small_rendered(capsys):
    # the bench's mono camera at half size, on the first 40 frames of the sweep the mono path renders
    cfg = TConfig(width=320, height=240, fx=258.653204, fy=258.2346075, cx=159.32152, cy=127.6569945,
                  n_features=400, max_features=512, max_keyframes=64, max_landmarks=8192, max_local_lms=1024,
                  vocab_words=128)
    scene = tsynth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=cfg)
    images = [torch.from_numpy(tsynth.render_image(scene, i)) for i in range(40)]
    scene = scene._replace(R=scene.R[:40], t=scene.t[:40])
    fps = bench.run_mono(10, images, cfg, scene, "cpu", warm_end=24, occlude_at=16)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("# tum_mono_kf10: ")
    line = json.loads(out[0][len("# tum_mono_kf10: "):])
    assert np.isfinite(fps) and fps > 0
    assert line["state"] == OK and line["frames"] == 40 and line["blanked"] == [16, 17, 18, 19]
    assert line["frames_not_fed"] == [] and line["ok_share"] > 0.9 and line["keyframes"] >= 4
    assert line["recovered"] >= 1    # from the blanked frames (too early for a codebook: no relocalization)
    assert isinstance(line["ate_m"], float) and np.isfinite(line["ate_m"]) and line["ate_alignment"] == "similarity"
    assert (line["timed_first_frame"], line["timed_frames"], line["frames_in_window"]) == (24, 8, 16)
    # the plain versions ran (CPU tensors): no kernel launch is counted
    assert set(line["launches"]) == set(bench_kernels()) and not any(line["launches"].values())
    assert line["frontend_batches"] >= 4 and line["loop_closures"] == 0


def bench_kernels():
    from dialog_tpu_torch.kernels import common

    return common.launches
