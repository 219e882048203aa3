"""The main path's workload, and where its time goes on one CUDA card.

    python3 -m dialog_tpu_torch.profile_main_path [--out PATH]

The workload (also driven by ``chip_smoke.py``): ``Engine.track_image`` over
the first 56 frames of the rendered sweep ``make_scene(seed=3,
n_points=2500, n_frames=168)`` at bench.py's TUM-class 640x480 monocular
configuration; the measured window is frames 16-55.

Three runs of that workload, each on a fresh engine:

1. plain: the window's wall time on the host clock, nothing added;
2. phases: the engine's four tensor phases (feature extraction, the tracking
   step, the keyframe pipeline, local BA) timed on the host clock, with the
   device synchronised at every phase boundary;
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

import torch

N_FRAMES = 56
FPS_FIRST = 16
SYNC_ROWS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "aten::item", "cudaMemcpyAsync")


def tum_mono_config():
    """bench.py's TUM-class monocular configuration (``bench.py:260-265``)."""
    from .config import EngineConfig

    return EngineConfig(
        width=640, height=480, n_features=1000, max_features=1024,
        max_keyframes=256, max_landmarks=16384, max_local_lms=2048,
        max_local_kfs=16, max_fixed_kfs=16, max_obs_per_lm=8,
        local_ba_iters=5, max_frames_between_kf=30,
    )


def render_frames(cfg, n: int = N_FRAMES):
    """The rendered sweep and its first ``n`` frames (f32 [480, 640] each)."""
    from .datasets import synth

    scene = synth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=cfg)
    return scene, [synth.render_image(scene, i) for i in range(n)]


def _track(eng, images, first: int, last: int) -> float:
    """Track frames [first, last); returns the wall seconds, device synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(first, last):
        eng.track_image(images[i], float(i) / 30.0)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def plain_run(cfg, images, dev) -> float:
    from .system import Engine

    eng = Engine(cfg, device=dev)
    _track(eng, images, 0, FPS_FIRST)
    return _track(eng, images, FPS_FIRST, len(images))


def phase_run(cfg, images, dev) -> dict:
    """Window wall time and each phase's synchronised host time."""
    from . import mapping, system, tracking

    spent: dict[str, float] = {}
    originals = [(system, "extract_features"), (tracking, "fused_track_step"),
                 (mapping, "process_new_keyframe"), (system, "local_bundle_adjustment")]
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
    _track(eng, images, 0, FPS_FIRST)
    kf0 = eng.kf_count
    try:
        for (mod, name), fn in zip(originals, saved):
            setattr(mod, name, timed(name, fn))
        total = _track(eng, images, FPS_FIRST, len(images))
    finally:
        for (mod, name), fn in zip(originals, saved):
            setattr(mod, name, fn)
    return {"total_s": total, "keyframes_in_window": eng.kf_count - kf0, **spent}


def _busy_seconds(events) -> float:
    """Union of the device intervals of the profiler's events, in seconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy * 1e-6


def profiled_run(cfg, images, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from .system import Engine

    eng = Engine(cfg, device=dev)
    _track(eng, images, 0, FPS_FIRST)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _track(eng, images, FPS_FIRST, len(images))
    events = prof.events()
    rows = prof.key_averages()
    device_rows = sorted((r for r in rows if r.device_time_total > 0), key=lambda r: -r.device_time_total)
    host_rows = sorted(rows, key=lambda r: -r.cpu_time_total)
    kernels = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset")))
    return {
        "wall_s": wall,
        "device_busy_s": _busy_seconds(events),
        "device_kernels": kernels,
        "syncs": {r.key: r.count for r in rows if r.key in SYNC_ROWS},
        "top_device_ms": [[r.key[:80], r.count, r.device_time_total / 1e3] for r in device_rows[:15]],
        "top_host_ms": [[r.key[:80], r.count, r.cpu_time_total / 1e3] for r in host_rows[:15]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    cfg = tum_mono_config()
    _, images = render_frames(cfg)
    plain_s = plain_run(cfg, images, dev)
    phases = phase_run(cfg, images, dev)
    prof = profiled_run(cfg, images, dev)
    n = len(images) - FPS_FIRST
    out = {
        "card": card, "frames": n, "plain_wall_s": plain_s, "frames_per_s": n / plain_s,
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
