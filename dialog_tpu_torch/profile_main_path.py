"""The port's workloads, and where their time goes on one CUDA card.

    python3 -m dialog_tpu_torch.profile_main_path [--config mono|stereo|rgbd] [--batch] [--out PATH]

The workloads (also driven by ``chip_smoke.py``):

* ``mono``: ``Engine.track_image`` over the first 56 frames of the rendered
  sweep ``make_scene(seed=3, n_points=2500, n_frames=168)`` at bench.py's
  TUM-class 640x480 monocular configuration; measured window frames 16-55;
* ``stereo``: ``Engine.track_stereo`` over the first 48 rendered stereo
  pairs of bench.py's ``kitti_stereo`` workload (``make_scene(seed=7,
  n_points=6000, n_frames=168)``, the right camera ``baseline`` to the
  right) at the KITTI00 preset with bench.py's capacities, 1241x376 and
  2000 features; measured window frames 16-47;
* ``rgbd``: ``Engine.track_rgbd`` over 24 frames of the mono sweep scaled
  by ``RGBD_SCALE`` to indoor depths, with its depth map in TUM's units, at
  the TUM1 RGB-D settings; measured window frames 16-23.

With ``--batch`` (``mono`` and ``stereo``) the window goes through the batched
entries instead, ``frontend.extract_features_batch`` or
``stereo.extract_and_match_stereo_batch`` and ``Engine.track_batch`` at
``BATCH`` frames, flushed at the window's end; the frames before the window
go per frame as without it, and the phases timed are the batched ones.

Three runs of the chosen workload, each on a fresh engine:

1. plain: the window's wall time on the host clock, nothing added;
2. phases: the engine's tensor phases (feature extraction, stereo matching
   for ``stereo``, the tracking step, the keyframe pipeline, local BA) timed
   on the host clock, with the device synchronised at every phase boundary;
3. profiled: the window under ``torch.profiler``, which counts kernel
   launches, stream synchronisations and ``.item()`` reads, and gives the
   device's busy time as the union of its kernel, copy and set intervals.

The device's idle share is given against both the profiled window's wall
time and the plain run's: the profiler slows the host, not the device.
Prints one JSON object as the last line, and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import numpy as np
import torch

N_FRAMES = 56
FPS_FIRST = 16
STEREO_FRAMES = 48
RGBD_FRAMES = 24
BATCH = 8             # bench.py's batch (``bench.py:58``)
MONO_BATCH_FRAMES = 104     # bench.py's warm-up stretch: 8 frames one by one, then 12 batches
STEREO_BATCH_FRAMES = 44    # 4 pairs one by one, then 5 batches
RGBD_SCALE = 0.25   # sweep depths 4-12 -> 1-3 m, inside th_depth x baseline (3.09 m)
# the loop workload: the reference's own loop-closing orbit (tests/test_loopclosing.py), feature frames
LOOP_SEED, LOOP_POINTS, LOOP_FRAMES, LOOP_PERIOD = 7, 8000, 260, 200
LOOP_NOISE_PX, LOOP_DESC_FLIPS = 0.5, 6
# the pipelined and batched runs' lap: at LOOP_PERIOD the reference engine's batched path (one keyframe a
# batch, mapping a batch behind) loses the orbit at frame 21 (tools/reference_ate.py loop --batch 8), its
# pipelined path (mapping up to 3 frames behind) at frame 32 (loop --pipelined)
LOOP_BATCH_PERIOD = 400
SYNC_ROWS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "aten::item", "cudaMemcpyAsync")


def tum_mono_config():
    """bench.py's TUM-class monocular configuration (``bench.py:260-265``)."""
    from .config import EngineConfig

    return EngineConfig(
        width=640, height=480, n_features=1000, max_features=1024,
        max_keyframes=256, max_landmarks=16384, max_local_lms=2048,
        max_local_kfs=16, max_fixed_kfs=16, max_obs_per_lm=8,
        local_ba_iters=5, max_frames_between_kf=30,
    )


def loop_config():
    """The reference loop test's own configuration (``tests/test_loopclosing.py``:
    512 features, 96 keyframes, a keyframe at least every 6 frames, a
    512-word vocabulary from 5 keyframes), the rest at the defaults (640x480).
    At the TUM-class configuration with a keyframe every 6 frames the
    reference engine closes a loop on this orbit but its correction raises
    the ATE above the test's gate (``tools/reference_ate.py loop --tum``,
    PERF.md)."""
    from .config import EngineConfig

    return EngineConfig(max_features=512, max_keyframes=96, max_landmarks=16384, max_local_lms=4096,
                        max_frames_between_kf=6, vocab_words=512, vocab_min_kfs=5)


def loop_tum_config():
    """The TUM-class monocular configuration with a keyframe at least every 6 frames."""
    return tum_mono_config().replace(max_frames_between_kf=6)


def loop_scene(cfg, period: int = LOOP_PERIOD):
    """The orbit around a ring of LOOP_POINTS points, one lap every ``period``
    frames, over 1.3 laps (LOOP_FRAMES at LOOP_PERIOD), so the last 0.3 lap
    revisits the first."""
    from .datasets import synth

    return synth.make_scene(seed=LOOP_SEED, n_points=LOOP_POINTS, n_frames=LOOP_FRAMES * period // LOOP_PERIOD,
                            trajectory="loop", cfg=cfg, period=period)


def render_frames(cfg, n: int = N_FRAMES):
    """The rendered sweep and its first ``n`` frames (f32 [480, 640] each)."""
    from .datasets import synth

    scene = synth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=cfg)
    return scene, [synth.render_image(scene, i) for i in range(n)]


def kitti_stereo_config():
    """bench.py's ``kitti_stereo`` configuration (``bench.py:158``)."""
    from .config import KITTI00

    return KITTI00.replace(max_keyframes=256, max_landmarks=32768)


def render_stereo_frames(cfg, n: int = STEREO_FRAMES):
    """bench.py's stereo scene and its first ``n`` (left, right) pairs."""
    from .datasets import synth

    scene = synth.make_scene(seed=7, n_points=6000, n_frames=168, cfg=cfg)
    scene_r = scene._replace(t=scene.t - np.array([cfg.baseline, 0.0, 0.0], np.float32))
    return scene, [(synth.render_image(scene, i), synth.render_image(scene_r, i)) for i in range(n)]


def tum_rgbd_config():
    """TUM-class RGB-D: the mono configuration with ORB-SLAM2's
    ``Examples/RGB-D/TUM1.yaml`` depth settings (Camera.bf 40, ThDepth 40,
    DepthMapFactor 5000). No lens distortion: the renderer draws a pinhole
    image."""
    from .config import Sensor

    return tum_mono_config().replace(sensor=Sensor.RGBD, bf=40.0, th_depth=40.0, depth_map_factor=5000.0)


def render_rgbd_frames(cfg, n: int = RGBD_FRAMES):
    """The mono sweep scaled by RGBD_SCALE, and its first ``n`` (image,
    depth map x depth_map_factor) pairs."""
    from .datasets import synth

    scene = synth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=cfg)
    scene = scene._replace(xyz=scene.xyz * np.float32(RGBD_SCALE), t=scene.t * np.float32(RGBD_SCALE))
    return scene, [(synth.render_image(scene, i), synth.render_depth(scene, i) * np.float32(cfg.depth_map_factor))
                   for i in range(n)]


# name -> (config, frames, Engine entry point, frames per second of the stream)
WORKLOADS = {
    "mono": (tum_mono_config, render_frames, "track_image", 30.0),
    "stereo": (kitti_stereo_config, render_stereo_frames, "track_stereo", 10.0),
    "rgbd": (tum_rgbd_config, render_rgbd_frames, "track_rgbd", 30.0),
}


def track_frames(eng, method: str, frames, first: int, last: int, fps: float) -> float:
    """Feed frames [first, last) to ``eng.<method>``; returns the wall
    seconds, device synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(first, last):
        x = frames[i]
        getattr(eng, method)(*(x if isinstance(x, tuple) else (x,)), float(i) / fps)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def extract_batch(cfg, frames, first: int, dev, blank: int = 0):
    """Frames [first, first + BATCH) through the batched frontend of their
    kind (images, or (left, right) pairs): FrameArrays with a leading BATCH
    on ``dev``. The first ``blank`` frames of the batch are made invalid (an
    occlusion, as bench.py forces one in its warm-up)."""
    from .frontend import extract_features_batch
    from .stereo import extract_and_match_stereo_batch

    chunk = frames[first : first + BATCH]
    if isinstance(chunk[0], tuple):
        left = torch.from_numpy(np.stack([x[0] for x in chunk])).to(dev)
        right = torch.from_numpy(np.stack([x[1] for x in chunk])).to(dev)
        batch = extract_and_match_stereo_batch(left, right, cfg)
    else:
        batch = extract_features_batch(torch.from_numpy(np.stack(chunk)).to(dev), cfg)
    if blank:
        valid = batch.valid.clone()
        valid[:blank] = False
        batch = batch._replace(valid=valid)
    return batch


def track_batches(eng, frames, first: int, last: int, fps: float, occlude_at: int | None = None) -> float:
    """Feed frames [first, last) to ``eng.track_batch`` in batches of BATCH
    (the batch that starts at ``occlude_at`` with its first half blank), then
    flush; returns the wall seconds, device synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(first, last - BATCH + 1, BATCH):
        batch = extract_batch(eng.cfg, frames, i, eng.device, blank=BATCH // 2 if i == occlude_at else 0)
        eng.track_batch(batch, [float(i + j) / fps for j in range(BATCH)])
    eng.flush()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _window(eng, method, frames, fps, batch: bool) -> float:
    if batch:
        return track_batches(eng, frames, FPS_FIRST, len(frames), fps)
    return track_frames(eng, method, frames, FPS_FIRST, len(frames), fps)


def plain_run(cfg, frames, dev, method="track_image", fps=30.0, batch=False) -> float:
    from .system import Engine

    eng = Engine(cfg, device=dev)
    track_frames(eng, method, frames, 0, FPS_FIRST, fps)
    return _window(eng, method, frames, fps, batch)


def phase_run(cfg, frames, dev, method="track_image", fps=30.0, batch=False) -> dict:
    """Window wall time and each phase's synchronised host time."""
    from . import frontend, mapping, stereo, system, tracking

    spent: dict[str, float] = {}
    originals = [(system, "extract_features"), (system, "stereo_match_frames"), (tracking, "fused_track_step"),
                 (mapping, "process_new_keyframe"), (system, "local_bundle_adjustment")]
    if batch:
        # the batched stereo frontend holds its extraction: the two are timed apart
        originals = [(frontend, "extract_features_batch"), (stereo, "stereo_match_frames"),
                     (tracking, "fused_track_multi"), (system.Engine, "_resolve_batch")] + originals[3:]
    saved = [getattr(mod, name) for mod, name in originals]

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    eng = system.Engine(cfg, device=dev)
    track_frames(eng, method, frames, 0, FPS_FIRST, fps)
    kf0 = eng.kf_count
    try:
        for (mod, name), fn in zip(originals, saved):
            setattr(mod, name, timed(name, fn))
        total = _window(eng, method, frames, fps, batch)
    finally:
        for (mod, name), fn in zip(originals, saved):
            setattr(mod, name, fn)
    return {"total_s": total, "keyframes_in_window": eng.kf_count - kf0, **spent}


# the names torch.profiler leaves out of its event list (``torch.autograd.profiler._filter_name``)
_FILTERED = frozenset({"[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                       "profiler::_record_function_enter_new", "profiler::_record_function_exit", "aten::is_leaf",
                       "aten::output_nr", "aten::_version"})


def _union_seconds(spans) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def _busy_seconds(events) -> float:
    """Union of the device intervals of the profiler's events (``prof.events()``), in seconds."""
    return 1e-6 * _union_seconds((e.time_range.start, e.time_range.end) for e in events
                                 if e.device_type == torch.autograd.DeviceType.CUDA)


def read_profile(prof) -> dict:
    """The device's busy seconds, its kernels (copies and sets apart), and per
    name the events and their inclusive nanoseconds on the device and on the
    host (operators and runtime calls), from the profiler's raw event
    records under the filters of ``prof.events()``, but without the Python
    event tree that it builds: for the half million events of a 16-frame
    window that tree takes about a minute of the host's time. An operator
    nested in one of the same name (``aten::sum`` in ``aten::sum``), which the
    event list folds into one, counts at each level."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, kernels, device, host = [], 0, {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in _FILTERED or getattr(e, "is_hidden_event", lambda: False)():
            continue
        table = host
        if e.device_type() == cuda:
            spans.append((e.start_ns(), e.end_ns()))
            kernels += not name.startswith(("Memcpy", "Memset"))
            table = device
        n, ns = table.get(name, (0, 0))
        table[name] = (n + 1, ns + e.duration_ns())
    return {"device_busy_s": 1e-9 * _union_seconds(spans), "device_kernels": kernels, "device": device, "host": host}


def profiled(fn) -> dict:
    """``fn()`` (which returns its wall seconds) under ``torch.profiler``:
    the device's busy time, its kernels, the host's sync rows and the top
    rows by name: the device's kernels and copies, the host's operators and
    runtime calls, each with its events and inclusive ms (``read_profile``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = fn()
    r = read_profile(prof)

    def top(table):
        return [[k[:80], n, ns / 1e6] for k, (n, ns) in sorted(table.items(), key=lambda kv: -kv[1][1])[:15]]

    return {
        "wall_s": wall,
        "device_busy_s": r["device_busy_s"],
        "device_kernels": r["device_kernels"],
        "syncs": {k: r["host"][k][0] for k in SYNC_ROWS if k in r["host"]},
        "top_device_ms": top(r["device"]),
        "top_host_ms": top(r["host"]),
    }


def profiled_run(cfg, frames, dev, method="track_image", fps=30.0, batch=False) -> dict:
    from .system import Engine

    eng = Engine(cfg, device=dev)
    track_frames(eng, method, frames, 0, FPS_FIRST, fps)
    return profiled(lambda: _window(eng, method, frames, fps, batch))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=sorted(WORKLOADS), default="mono", help="the workload (module doc)")
    ap.add_argument("--batch", action="store_true", help="the window through the batched entries (mono, stereo)")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import dialog_tpu_torch  # noqa: F401  (pins exact f32)
    from .kernels import build

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.load_all()
    make_cfg, make_frames, method, fps = WORKLOADS[args.config]
    if args.batch and args.config == "rgbd":
        raise SystemExit("--batch drives the mono and stereo workloads")
    cfg = make_cfg()
    _, frames = make_frames(cfg)
    plain_s = plain_run(cfg, frames, dev, method, fps, args.batch)
    phases = phase_run(cfg, frames, dev, method, fps, args.batch)
    prof = profiled_run(cfg, frames, dev, method, fps, args.batch)
    n = len(frames) - FPS_FIRST
    out = {
        "card": card, "config": args.config, "batch": BATCH if args.batch else 0, "frames": n,
        "plain_wall_s": plain_s, "frames_per_s": n / plain_s,
        "phases": phases, "profiled": prof,
        "idle_share_profiled": 1.0 - prof["device_busy_s"] / prof["wall_s"],
        "idle_share_plain": 1.0 - prof["device_busy_s"] / plain_s,
        "kernels_per_frame": prof["device_kernels"] / n,
    }
    text = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
