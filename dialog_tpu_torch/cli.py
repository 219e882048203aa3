"""Command-line entry points.

Replaces the reference's per-dataset example binaries (canonical
``Examples/{Monocular,Stereo,RGB-D}/*.cc`` — SURVEY.md §2.1): run a
sequence through the engine, print per-frame timing stats (median/mean
track time, as the reference mains do at exit), save the trajectory, and
evaluate ATE when ground truth is available.

Usage::

    dialog-tpu-torch run-tum  <seq_dir> [--settings TUM1.yaml] [--rgbd] [--pipelined] [--out traj.txt]
    dialog-tpu-torch run-kitti <seq_dir> [--settings KITTI00-02.yaml] [--mono] [--gt poses.txt] [--out traj.txt]
    dialog-tpu-torch run-euroc <seq_dir> [--settings EuRoC.yaml] [--mono] [--out traj.txt]
    dialog-tpu-torch run-synth [--frames N] [--trajectory sweep|loop]
    dialog-tpu-torch bench [--only kf10|kf30|stereo] [--device cuda|cpu]

Every subcommand takes ``--frames``, ``--out``, ``--render`` (PNG or SVG)
and ``--device`` (``cuda``, the default, or ``cpu``). Images are decoded
without cv2 (``datasets.png``) on a background thread (``datasets.prefetch``);
besides the reference's lines each run prints how long the loop waited for
the next decoded frame.

Where the reference differs: ``run-kitti --gt`` scores the frames tracked
OK only (ROADMAP R3: the reference also scores pre-initialization and LOST
placeholders); ``run-tum`` and ``run-euroc`` pair each OK frame with the
ground-truth row nearest its timestamp, and the render aligns over those
pairs (R8: the reference pairs the k-th OK frame with the k-th row); an ATE
that is not finite prints as undefined (R2). ``bench`` parses its own flags
and hands them to ``bench.main`` (R9: the reference's ``bench`` subcommand
hands its ``main`` the process's arguments, subcommand included, and
declares no ``--only``, so it exits with a usage error).
"""

from __future__ import annotations

import argparse
import itertools
import time

import numpy as np

from . import bench
from .config import EngineConfig, Sensor, load_yaml

# the reference CLI's settings when no --settings file is given
KITTI_DEFAULT = EngineConfig(
    fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
    bf=386.1448, width=1241, height=376, fps=10.0,
    n_features=2000, max_features=2048,
)
EUROC_DEFAULT = EngineConfig(
    # EuRoC cam0 defaults (ASL calibration, pinhole radtan)
    fx=458.654, fy=457.296, cx=367.215, cy=248.375,
    k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05,
    bf=47.90639384423901, width=752, height=480, fps=20.0,
)
GT_MAX_DT = 0.02   # s: a frame's ground truth lies within this of its timestamp (tum.associate's 20 ms)
SYNTH_CONFIG = EngineConfig(
    max_features=512, max_keyframes=128, max_landmarks=16384,
    max_local_lms=4096, max_frames_between_kf=8,
)


def settings(path: str | None, sensor: Sensor, default: EngineConfig = EngineConfig()) -> EngineConfig:
    """The run's configuration: the YAML file's, or ``default``, for ``sensor``."""
    return load_yaml(path, sensor) if path else default.replace(sensor=sensor)


def _timing_stats(times: list[float]) -> str:
    t = np.sort(np.asarray(times))
    if len(t) == 0:
        return "no frames"
    return (
        f"median track time: {np.median(t) * 1e3:.1f} ms | "
        f"mean: {t.mean() * 1e3:.1f} ms | fps: {1.0 / max(t.mean(), 1e-9):.1f}"
    )


def _ate_text(err: float, scale: float, unit: str) -> str:
    return f"{err * scale:.2f} {unit}" if np.isfinite(err) else "undefined"


def _drive(eng, src, frames, step) -> list[float]:
    """Feed ``src`` (prefetched) to ``step``; returns the per-frame track
    times and prints the loop's wait for decoded frames."""
    from .datasets.prefetch import prefetch

    if frames:
        src = itertools.islice(src, frames)
    times, wait = [], 0.0
    t_run = time.perf_counter()
    with prefetch(src) as it:
        while True:
            t_wait = time.perf_counter()
            item = next(it, None)
            wait += time.perf_counter() - t_wait
            if item is None:
                break
            t0 = time.perf_counter()
            step(item)
            times.append(time.perf_counter() - t0)
    eng.flush()
    wall = time.perf_counter() - t_run
    print(f"input wait: {wait:.3f} s of {wall:.3f} s in the loop ({wait / max(wall, 1e-9) * 100:.1f}%)")
    return times


def gt_per_frame(eng, gt) -> np.ndarray:
    """[T, 3] ground-truth position of each frame of the engine's trajectory:
    the row of ``gt`` (times, positions) nearest the frame's timestamp
    (ties to the later, as ``datasets.tum.associate``), NaN where none lies
    within GT_MAX_DT (R8: not the row at the frame's position in the list)."""
    times, pos = np.asarray(gt[0], np.float64), np.asarray(gt[1], np.float64)
    ts = np.array([r.timestamp for r in eng.trajectory], np.float64)
    out = np.full((len(ts), 3), np.nan)
    if len(times) == 0:
        return out
    order = np.argsort(times, kind="stable")
    times, pos = times[order], pos[order]
    hi = np.clip(np.searchsorted(times, ts), 0, len(times) - 1)
    lo = np.clip(hi - 1, 0, len(times) - 1)
    k = np.where(np.abs(times[hi] - ts) <= np.abs(times[lo] - ts), hi, lo)
    near = np.abs(times[k] - ts) <= GT_MAX_DT
    out[near] = pos[k[near]]
    return out


def _finish(eng, times, out_path, fmt, gt=None, render=None):
    print(_timing_stats(times))
    states = [r.state for r in eng.trajectory]
    n_ok = sum(1 for s in states if s == "OK")
    print(f"tracked {n_ok}/{len(states)} frames | keyframes: {eng.kf_count}")
    if out_path:
        if fmt == "kitti":
            eng.save_trajectory_kitti(out_path)
        else:
            eng.save_trajectory_tum(out_path)
        print(f"trajectory -> {out_path}")
    gt_frames = None if gt is None else gt_per_frame(eng, gt)
    if gt_frames is not None:
        from .eval.ate import ate_rmse

        idx = [i for i, s in enumerate(states) if s == "OK" and np.isfinite(gt_frames[i, 0])]
        if len(idx) > 10:
            err = ate_rmse(eng.positions[idx], gt_frames[idx])
            print(f"ATE RMSE (scale-aligned): {_ate_text(err, 100, 'cm')} over {len(idx)} OK frames with ground truth")
    if render:
        from .eval.render import render_map

        render_map(eng, render, gt_positions=gt_frames)
        print(f"map render -> {render}")


def run_tum(args) -> None:
    from .datasets import tum
    from .system import Engine

    cfg = settings(args.settings, Sensor.RGBD if args.rgbd else Sensor.MONOCULAR)
    eng = Engine(cfg, device=args.device)

    def step(item):
        if args.rgbd:
            eng.track_rgbd(item[1], item[2], item[0])
        elif args.pipelined:
            import torch

            from .frontend import extract_features

            img = torch.as_tensor(item[1], dtype=torch.float32).to(eng.device)
            eng.track_features_async(eng._undistort(extract_features(img, cfg)), item[0])
        else:
            eng.track_image(item[1], item[0])

    src = tum.iter_rgbd(args.seq) if args.rgbd else tum.iter_mono(args.seq)
    times = _drive(eng, src, args.frames, step)
    gt = None
    try:
        gt = tum.load_groundtruth(args.seq)
    except FileNotFoundError:
        pass
    _finish(eng, times, args.out, "tum", gt, render=args.render)


def run_kitti(args) -> None:
    from .datasets import kitti
    from .system import Engine

    cfg = settings(args.settings, Sensor.MONOCULAR if args.mono else Sensor.STEREO, KITTI_DEFAULT)
    eng = Engine(cfg, device=args.device)

    def step(item):
        if args.mono:
            eng.track_image(item[1], item[0])
        else:
            eng.track_stereo(item[1], item[2], item[0])

    src = kitti.iter_mono(args.seq) if args.mono else kitti.iter_stereo(args.seq)
    times = _drive(eng, src, args.frames, step)
    _finish(eng, times, args.out, "kitti", render=args.render)
    if args.gt:
        # KITTI odometry devkit metrics (no alignment needed: relative), over
        # the frames tracked OK (R3)
        from .eval.ate import ate_rmse
        from .eval.rpe import kitti_odometry_errors

        gt_R, gt_t = kitti.load_poses_full(args.gt)
        poses = eng.final_poses()
        n = min(len(poses), len(gt_R))
        ok = [i for i in range(n) if eng.trajectory[i].state == "OK"]
        if not ok:
            print("KITTI devkit: no frame tracked OK")
            return
        est_R = np.stack([poses[i][0] for i in ok])
        est_t = np.stack([poses[i][1] for i in ok])
        t_err, r_err, n_seg = kitti_odometry_errors(est_R, est_t, gt_R[ok], gt_t[ok])
        C_est = -np.einsum("nij,ni->nj", est_R, est_t)
        C_gt = -np.einsum("nij,ni->nj", gt_R[ok], gt_t[ok])
        print(
            f"KITTI devkit ({n_seg} segments, {len(ok)}/{n} frames OK): translation "
            f"{t_err * 100:.2f} % | rotation "
            f"{np.degrees(r_err) * 100:.4f} deg/100m | "
            f"ATE RMSE {_ate_text(ate_rmse(C_est, C_gt), 1, 'm')}"
        )


def run_euroc(args) -> None:
    """EuRoC MAV sequence (reference: Examples/*/mono_euroc, stereo_euroc)."""
    from .datasets import euroc
    from .system import Engine

    cfg = settings(args.settings, Sensor.MONOCULAR if args.mono else Sensor.STEREO, EUROC_DEFAULT)
    eng = Engine(cfg, device=args.device)

    def step(item):
        if args.mono:
            eng.track_image(item[1], item[0])
        else:
            eng.track_stereo(item[1], item[2], item[0])

    src = euroc.iter_mono(args.seq) if args.mono else euroc.iter_stereo(args.seq)
    times = _drive(eng, src, args.frames, step)
    gt = None
    try:
        gt = euroc.load_groundtruth(args.seq)
    except OSError:
        pass
    _finish(eng, times, args.out, "tum", gt, render=args.render)


def run_synth(args) -> None:
    from .datasets import synth
    from .eval.ate import ate_rmse
    from .system import Engine

    cfg = SYNTH_CONFIG
    n = args.frames or 60
    scene = synth.make_scene(seed=0, n_points=1500, n_frames=n, trajectory=args.trajectory, cfg=cfg)
    eng = Engine(cfg, device=args.device)
    times = []
    for i in range(n):
        fr, _ = synth.observe(scene, i, noise_px=0.5, device=args.device)
        t0 = time.perf_counter()
        eng.track_features(fr, float(i) / 30.0)
        times.append(time.perf_counter() - t0)
    eng.flush()   # drain pipeline + any in-flight async GBA before evaluating
    states = [r.state for r in eng.trajectory]
    idx = [i for i, s in enumerate(states) if s == "OK"]
    gt = np.stack([-scene.R[i].T @ scene.t[i] for i in range(n)])
    err = ate_rmse(eng.positions[idx], gt[idx]) if idx else float("nan")
    print(_timing_stats(times))
    print(f"tracked {len(idx)}/{n} | kfs {eng.kf_count} | ATE {_ate_text(err, 100, 'cm')}")
    if args.out:
        eng.save_trajectory_tum(args.out)
    if args.render:
        from .eval.render import render_map

        render_map(eng, args.render, gt_positions=gt)
        print(f"map render -> {args.render}")


def run_bench(args) -> None:
    bench.main((["--only", args.only] if args.only else []) + ["--device", args.device])


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dialog-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(s, settings_file: bool = True):
        if settings_file:
            s.add_argument("--settings", help="reference-format YAML settings file")
        s.add_argument("--frames", type=int)
        s.add_argument("--out", help="write the trajectory here")
        s.add_argument("--render", help="render map+trajectory to an image file (.png or .svg)")
        s.add_argument("--device", default="cuda", help="the engine's device: cuda (default) or cpu")

    t = sub.add_parser("run-tum", help="run a TUM sequence (mono or RGB-D)")
    t.add_argument("seq")
    t.add_argument("--rgbd", action="store_true")
    t.add_argument("--pipelined", action="store_true",
                   help="throughput mode: resolve results a few frames behind")
    common(t)
    t.set_defaults(fn=run_tum)

    k = sub.add_parser("run-kitti", help="run a KITTI sequence (stereo or mono)")
    k.add_argument("seq")
    k.add_argument("--mono", action="store_true")
    k.add_argument(
        "--gt", help="devkit poses file (3x4/line): print KITTI odometry "
        "metrics + ATE over the frames tracked OK",
    )
    common(k)
    k.set_defaults(fn=run_kitti)

    e = sub.add_parser("run-euroc", help="run a EuRoC MAV sequence (mono or stereo)")
    e.add_argument("seq", help="sequence dir containing mav0/")
    e.add_argument("--mono", action="store_true")
    common(e)
    e.set_defaults(fn=run_euroc)

    s = sub.add_parser("run-synth", help="run a synthetic sequence")
    s.add_argument("--trajectory", default="sweep", choices=["sweep", "loop"])
    common(s, settings_file=False)
    s.set_defaults(fn=run_synth)

    b = sub.add_parser("bench", help="frames/s of the tracking pipeline on bench.py's three workloads")
    bench.add_arguments(b)
    b.set_defaults(fn=run_bench)
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
