"""Benchmark harness: frames/s of the full tracking pipeline on one CUDA card.

    python3 -m dialog_tpu_torch.bench [--only kf10|kf30|stereo] [--device cuda|cpu]
    dialog-tpu-torch bench [--only kf10|kf30|stereo] [--device cuda|cpu]

The port's counterpart of the reference's ``bench.py``, with its workloads,
constants, schedule and output. Emits one JSON line per workload the moment it
is measured, and re-prints the primary-metric line after every workload (and
in a ``finally``), so the last stdout line is always the primary metric.

Workloads, in this order (the primary one first):

* ``tum_mono_kf10``: 640x480 monocular, 1000 features, a keyframe at least
  every 10 frames, on ``make_scene(seed=3, n_points=2500, n_frames=264)``.
  The primary metric.
* ``tum_mono_kf30``: the same scene and images at the configuration's
  30-frame keyframe policy.
* ``kitti_stereo``: the KITTI00 preset (1241x376, 2000 features) at 256
  keyframes and 32,768 landmarks on ``make_scene(seed=7, n_points=6000,
  n_frames=168)`` with the right camera ``baseline`` to the right; loop
  detection on.

Each runs bench.py's schedule (``schedule``) on a fresh engine: some frames
one by one, batches of B through the batched frontend and ``track_batch``
with the first half of one batch blanked (the run goes LOST and recovers),
``flush``, the loop paths warmed, frames one by one until the run is OK; then
the timed window, whole batches from the next multiple of B to the end,
closed by ``flush`` and a device synchronisation. Images are rendered on the
host and uploaded once, before any timing.

Before its metric line each workload prints a line starting with ``#`` (no
metric): the run's state at the end, its OK share after the first OK frame
outside the blanked frames, its keyframes, relocalizations, recoveries from
LOST and loop closures, the ATE against the scene's ground truth
(similarity-aligned for mono, metric for stereo; ``undefined`` where it is not
finite), each kernel's launches over the workload, and the timed window's
first frame and frame count.

The baselines are the C++ reference pipeline's proxy rates on CPU (30 fps
TUM-class mono, 15 fps KITTI-class stereo: SURVEY.md section 6), as in
bench.py.

Where it differs from bench.py: there is no compilation cache and no compile
budget (nothing is compiled per shape; the kernels build once, at first use),
and no ``DIALOG_TPU_BENCH_SKIP_STEREO`` (``--only`` selects a workload);
ROADMAP D21. The timed frame count keeps bench.py's formula, which leaves the
window's last batch out of the count (ROADMAP R10): ``frames_in_window`` on
the ``#`` line is the number of frames the window tracked.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .profile_main_path import kitti_stereo_config, tum_mono_config

BASELINE_FPS_MONO = 30.0
BASELINE_FPS_STEREO = 15.0
B = 8
PRIMARY = "tum_mono_kf10"
MONO_FRAMES = 264
STEREO_FRAMES = 168
MONO_FPS = 30.0         # the streams' frame rates: timestamps are frame / fps
STEREO_FPS = 10.0
# the warm-up's frames fed one by one (bench.py:116, 191); its end and the first
# frame of its half-blanked batch are run_mono's and run_stereo's defaults
MONO_SINGLE = 8
STEREO_SINGLE = 4


def _emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def _sync(device: torch.device):
    """The device synchronisation that closes a timed region (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def warm_loop_paths(eng) -> None:
    """Run loop detection's dispatch and evaluate once without changing the
    loop state (``bench.py:70-92``): every field that ``dispatch``,
    ``take_pending`` and ``evaluate`` write is saved and restored. On the GPU
    this takes the detection's first-use costs (library handles, allocator
    blocks) out of the timed window."""
    if eng._vocab is None:
        return
    lc = eng._loop
    saved = (lc._pending_detect, list(lc._consistent), lc._eval_stamp, lc.last_eval_det_seq)
    lc._pending_detect = None
    lc.dispatch(eng.m, eng._bow_db, eng._vocab, max(eng.kf_count - 1, 0), stamp=eng.kf_count)
    det = lc.take_pending()
    if det is not None:
        lc.evaluate(det[0], det[1].cpu().numpy(), det[2].cpu().numpy(), stamp=det[3])
    lc._pending_detect, lc._consistent, lc._eval_stamp, lc.last_eval_det_seq = saved


def schedule(eng, n_frames: int, fps: float, one, extract, recover, *, n_single: int, warm_end: int,
             occlude_at: int, sync=lambda: None) -> dict:
    """bench.py's run of one workload (``bench.py:100-142``, ``172-203``).

    ``one(i)`` feeds frame i through the per-frame entry of the warm-up's
    first ``n_single`` frames; ``extract(i, n)`` gives frames [i, i + n)
    through the batched frontend (a leading n on every leaf); ``recover(i)``
    feeds frame i through the per-frame entry that runs until the engine is
    OK. The warm-up's batches start at ``n_single`` and end before
    ``warm_end``; the first half of the batch at ``occlude_at`` is blanked.
    ``sync`` waits for the device. Returns frames/s, the timed window's first
    frame, its frame count by bench.py's formula, the frames it tracked, and
    its seconds."""
    from .system import OK

    def run_batch(i: int, occlude: bool = False) -> None:
        batch = extract(i, B)
        if occlude:
            # the first half of the batch blank: the run goes LOST and recovers in the warm-up
            valid = batch.valid.clone()
            valid[: B // 2] = False
            batch = batch._replace(valid=valid)
        eng.track_batch(batch, [float(i + j) / fps for j in range(B)])

    for i in range(n_single):
        one(i)
    for i in range(n_single, warm_end, B):
        run_batch(i, occlude=i == occlude_at)
    eng.flush()
    warm_loop_paths(eng)
    while eng.frame_id < warm_end + 2 * B and eng.state != OK:
        recover(eng.frame_id)

    start = ((eng.frame_id + B - 1) // B) * B
    window = range(start, n_frames - B + 1, B)
    sync()
    t0 = time.perf_counter()
    for i in window:
        run_batch(i)
    eng.flush()
    sync()
    elapsed = time.perf_counter() - t0
    n_timed = ((n_frames - B + 1 - start) // B) * B
    return dict(fps=n_timed / elapsed, start=start, n_timed=n_timed, frames_in_window=B * len(window),
                seconds=elapsed)


def run_summary(eng, scene, fps: float, run: dict, *, with_scale: bool, occlude_at: int, launches: dict,
                batches: int) -> dict:
    """What the ``#`` line says of one workload: the state at the end, the OK
    share after the first OK frame outside the blanked frames, keyframes,
    relocalizations, recoveries from LOST, loop closures, the ATE (guarded:
    ``undefined`` when not finite), launches, frontend batches, the window.
    A record is scored against the scene's frame at its timestamp x ``fps``:
    the schedule skips frames between the warm-up and the window (the stereo
    warm-up's batches end at frame 68, the window starts at 72), so the
    engine's frame ids fall behind the frames it tracked."""
    from .eval.ate import ate_rmse
    from .system import LOST, OK

    states = [r.state for r in eng.trajectory]
    frames = [round(r.timestamp * fps) for r in eng.trajectory]
    blanked = set(range(occlude_at, occlude_at + B // 2))
    first_ok = states.index(OK) if OK in states else len(states)
    kept = [s == OK for i, s in enumerate(states) if i >= first_ok and frames[i] not in blanked]
    ok = [i for i, s in enumerate(states) if s == OK]
    ate = float("nan")
    if len(ok) >= 3:
        gt = np.stack([-scene.R[frames[i]].T @ scene.t[frames[i]] for i in ok])
        ate = ate_rmse(eng.positions[ok], gt, with_scale=with_scale)
    return {
        "state": eng.state, "frames": len(states), "frames_not_fed": sorted(set(range(len(scene.R))) - set(frames)),
        "first_ok": first_ok, "ok_share": float(np.mean(kept)) if kept else 0.0, "keyframes": eng.kf_count,
        "relocalizations": eng.stats["relocalizations"],
        "recovered": sum(1 for a, b in zip(states, states[1:]) if a == LOST and b == OK),
        "loop_closures": len(eng._loop.closed_loops),
        "ate_m": ate if np.isfinite(ate) else "undefined", "ate_alignment": "similarity" if with_scale else "metric",
        "launches": launches, "frontend_batches": batches, "blanked": sorted(blanked),
        "timed_first_frame": run["start"], "timed_frames": run["n_timed"],
        "frames_in_window": run["frames_in_window"], "timed_seconds": run["seconds"],
    }


def _drive(name: str, eng, scene, fps: float, one, extract, recover, *, with_scale: bool, device, sched: dict) -> float:
    """One workload on ``eng``: launch counts reset just before and read just
    after bench.py's schedule, then the ``#`` line. ``extract`` counts its
    calls in ``extract.calls``. Returns frames/s."""
    from .kernels import common

    sync = _sync(device)
    sync()
    common.reset_launch_counts()
    run = schedule(eng, len(scene.R), fps, one, extract, recover, sync=sync, **sched)
    summary = run_summary(eng, scene, fps, run, with_scale=with_scale, occlude_at=sched["occlude_at"],
                          launches=dict(common.launches), batches=extract.calls)
    print(f"# {name}: " + json.dumps(summary), flush=True)
    return run["fps"]


def _counted(fn):
    """``fn`` with the number of its calls in ``.calls``."""
    def wrapper(*args):
        wrapper.calls += 1
        return fn(*args)

    wrapper.calls = 0
    return wrapper


def mono_images(cfg, device, n_frames: int = MONO_FRAMES):
    """The mono scene and its rendered images, each uploaded to ``device`` once."""
    from .datasets import synth

    scene = synth.make_scene(seed=3, n_points=2500, n_frames=n_frames, cfg=cfg)
    return scene, [torch.from_numpy(synth.render_image(scene, i)).to(device) for i in range(n_frames)]


def run_mono(kf_interval: int, images, cfg, scene, device, warm_end: int = 104, occlude_at: int = 48) -> float:
    """One mono workload at keyframe interval ``kf_interval`` (``bench.py:95-142``); frames/s.
    ``warm_end`` and ``occlude_at`` as in ``schedule`` (bench.py's numbers by default)."""
    from .containers import FrameArrays
    from .frontend import extract_features_batch
    from .system import Engine

    device = torch.device(device)
    eng = Engine(cfg, device=device)
    eng.kf_interval = kf_interval

    def one(i):
        eng.track_image(images[i], float(i) / MONO_FPS)

    @_counted
    def extract(i, n):
        return extract_features_batch(torch.stack(images[i : i + n]), cfg)

    def recover(i):
        # bench.py:125-131: the batched frontend on one image, its frame through track_features
        eng.track_features(FrameArrays(*[x[0] for x in extract(i, 1)]), float(i) / MONO_FPS)

    return _drive(f"tum_mono_kf{kf_interval}", eng, scene, MONO_FPS, one, extract, recover, with_scale=True,
                  device=device, sched=dict(n_single=MONO_SINGLE, warm_end=warm_end, occlude_at=occlude_at))


def run_stereo(device, n_frames: int = STEREO_FRAMES, warm_end: int = 64, occlude_at: int = 28) -> float:
    """The KITTI-class stereo workload, loop detection on (``bench.py:145-203``); frames/s.
    ``warm_end`` and ``occlude_at`` as in ``schedule`` (bench.py's numbers by default)."""
    from .datasets import synth
    from .stereo import extract_and_match_stereo_batch
    from .system import Engine

    device = torch.device(device)
    cfg = kitti_stereo_config()
    scene = synth.make_scene(seed=7, n_points=6000, n_frames=n_frames, cfg=cfg)
    scene_r = scene._replace(t=scene.t - np.array([cfg.baseline, 0.0, 0.0], np.float32))
    left = [torch.from_numpy(synth.render_image(scene, i)).to(device) for i in range(n_frames)]
    right = [torch.from_numpy(synth.render_image(scene_r, i)).to(device) for i in range(n_frames)]
    eng = Engine(cfg, device=device)

    def one(i):
        eng.track_stereo(left[i], right[i], float(i) / STEREO_FPS)

    @_counted
    def extract(i, n):
        return extract_and_match_stereo_batch(torch.stack(left[i : i + n]), torch.stack(right[i : i + n]), cfg)

    return _drive("kitti_stereo", eng, scene, STEREO_FPS, one, extract, one, with_scale=False, device=device,
                  sched=dict(n_single=STEREO_SINGLE, warm_end=warm_end, occlude_at=occlude_at))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dialog-tpu-torch bench", description="frames/s of the tracking pipeline")
    add_arguments(p)
    return p


def add_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--only", choices=["kf10", "kf30", "stereo"], default=None,
                   help="run a single workload (kf10 is the primary metric)")
    p.add_argument("--device", default="cuda", help="the engines' device: cuda (default) or cpu")


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    results: dict[str, dict] = {}

    def emit_workload(name: str, fps: float, baseline: float) -> None:
        results[name] = {"value": round(fps, 2), "unit": "frames/s", "vs_baseline": round(fps / baseline, 3)}
        _emit({"metric": f"tracking_fps_{name}", **results[name]})

    def emit_primary() -> None:
        # the last stdout line is the primary workload's; when it did not run,
        # the line is labelled by the workload that did
        if PRIMARY in results:
            name, r = "tum_class_mono", results[PRIMARY]
        elif results:
            name, r = next(iter(results.items()))
        else:
            return
        _emit({"metric": f"tracking_fps_{name}", "value": r["value"], "unit": "frames/s",
               "vs_baseline": r["vs_baseline"], "workloads": {k: v["value"] for k, v in results.items()}})

    try:
        if args.only in (None, "kf10", "kf30"):
            cfg = tum_mono_config()
            scene, images = mono_images(cfg, device)
            for kf_interval in (10, 30):
                if args.only in (None, f"kf{kf_interval}"):
                    emit_workload(f"tum_mono_kf{kf_interval}", run_mono(kf_interval, images, cfg, scene, device),
                                  BASELINE_FPS_MONO)
                    emit_primary()
        if args.only in (None, "stereo"):
            emit_workload("kitti_stereo", run_stereo(device), BASELINE_FPS_STEREO)
    finally:
        emit_primary()


if __name__ == "__main__":
    main()
