"""The JAX reference engine on the port's workloads.

    JAX_PLATFORMS=cpu python tools/reference_ate.py stereo
    JAX_PLATFORMS=cpu python tools/reference_ate.py rgbd
    JAX_PLATFORMS=cpu python tools/reference_ate.py loop
    JAX_PLATFORMS=cpu python tools/reference_ate.py mono_batch
    JAX_PLATFORMS=cpu python tools/reference_ate.py bench_kf10|bench_kf30|bench_stereo

Runs ``dialog_tpu``'s engine on the same frames that ``chip_smoke.py`` feeds
the port (``dialog_tpu_torch.profile_main_path``):

* ``stereo`` / ``rgbd``: ``Engine.track_stereo`` / ``track_rgbd`` over the
  rendered frames, with loop closing off and no vocabulary within the run, so
  that it takes the port's path as it stood before loop closing. Prints the
  metric ATE (no scale alignment) over the OK frames; ``chip_smoke.py`` takes
  its stereo ATE bound from this run (PERF.md).
* ``loop``: ``Engine.track_features`` over the synthetic orbit of
  ``chip_smoke.py``'s loop phase (``LOOP_FRAMES`` feature frames of
  ``loop_scene`` under ``loop_config``, the reference loop test's own
  configuration; ``--tum``: the TUM-class mono configuration with
  ``max_frames_between_kf`` 6), loop closing on, and the global BA after
  each closure on, as in both engines (``--no-gba``: off, ``_start_gba`` a
  no-op, as the port's runs were compared before it had one). Prints the
  closed pairs with their keyframes' insertion numbers, the
  similarity-aligned ATE of the frames so far just before and just after the
  first correction and just after its global BA folded in, the GBA runs, the
  OK share and the whole run's ATE against the reference test's gate (5% of
  the span). ``--batch B``: the
  first 8 frames one by one, then batches of B through ``track_batch``, and
  ``flush``; ``--pipelined``: every frame through ``track_features_async``,
  and ``flush``; ``--period P``: a lap of P frames (the run keeps its 1.3
  laps).
* ``mono_batch``: the 104 rendered frames of ``chip_smoke.py``'s
  ``mono_batch`` at keyframe interval 10, twice: per frame through
  ``track_image``, and as the chip phase drives it (8 frames one by one, then
  batches of 8 through ``extract_features_batch`` + ``track_batch``, the first
  half of the batch at frame 48 blanked, ``flush``). Prints the
  similarity-aligned ATE of both (ROADMAP D10).

* ``bench_kf10`` / ``bench_kf30`` / ``bench_stereo``: the reference's
  ``bench.py`` workloads (``tum_mono_kf10``, ``tum_mono_kf30``,
  ``kitti_stereo``), the engine driven exactly as ``bench.py`` drives it
  (``bench_schedule``, a copy of its loop, with its configurations, scenes
  and loop detection on), on the CPU: the OK share after the first OK frame
  outside the blanked frames, keyframes, relocalizations, recoveries from
  LOST, loop closures, the ATE (similarity-aligned for mono, metric for
  stereo) and the timed window's first frame and count. ``chip_smoke.py``
  takes its bench ATE bounds from these runs (PERF.md).

Each prints one line per frame (or batch) and a JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import time

import jax.numpy as jnp
import numpy as np

from dialog_tpu.config import EngineConfig as JConfig, Sensor as JSensor
from dialog_tpu.eval.ate import ate_rmse
from dialog_tpu.system import Engine
from dialog_tpu_torch import profile_main_path as pmp


def reference_config(tcfg, vocab: bool = False) -> JConfig:
    kw = {f: getattr(tcfg, f) for f in tcfg.__dataclass_fields__ if f != "sensor"}
    cfg = JConfig(**kw, sensor=JSensor(tcfg.sensor.value))
    return cfg if vocab else cfg.replace(vocab_min_kfs=1000)


def _ate(eng, scene, with_scale: bool, fps: float | None = None):
    """(ATE over the OK frames, span of their ground-truth centres, OK share after the first OK frame). Each record
    is scored against the scene's frame ``frame_id``, or, given ``fps``, frame timestamp x fps (bench.py's schedule
    skips frames, so its records' frame ids fall behind the frames they tracked)."""
    states = [r.state for r in eng.trajectory]
    ok = np.array([s == "OK" for s in states])
    if ok.sum() < 3:
        return None, None, 0.0
    fids = np.array([r.frame_id if fps is None else round(r.timestamp * fps) for r in eng.trajectory])
    est = eng.positions[ok]
    gt = np.stack([-scene.R[i].T @ scene.t[i] for i in fids[ok]])
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    share = float(ok[int(np.argmax(ok)):].mean())
    return float(ate_rmse(est, gt, with_scale=with_scale)), span, share


def run_images(workload: str) -> dict:
    make_cfg, make_frames, method, fps = pmp.WORKLOADS[workload]
    tcfg = make_cfg()
    scene, frames = make_frames(tcfg)
    eng = Engine(reference_config(tcfg))
    eng.loop_closing_enabled = False
    t0 = time.perf_counter()
    for i, x in enumerate(frames):
        rec = getattr(eng, method)(*[jnp.asarray(a) for a in (x if isinstance(x, tuple) else (x,))], float(i) / fps)
        print(f"frame {i}: {rec.state} tracked={rec.n_tracked} kfs={eng.kf_count} "
              f"t={time.perf_counter() - t0:.1f}s", flush=True)
    ok = np.array([r.state == "OK" for r in eng.trajectory])
    ate, _, _ = _ate(eng, scene, with_scale=False)
    return {"workload": workload, "frames": len(frames), "state": eng.state, "kf_count": eng.kf_count,
            "ok_frames": int(ok.sum()), "first_ok": int(np.argmax(ok)) if ok.any() else -1, "ate_m": ate}


def run_loop(tum: bool, batch: int, pipelined: bool, period: int, gba: bool = True) -> dict:
    from dialog_tpu.containers import FrameArrays
    from dialog_tpu.datasets import synth

    tcfg = pmp.loop_tum_config() if tum else pmp.loop_config()
    cfg = reference_config(tcfg, vocab=True)
    n_frames = pmp.LOOP_FRAMES * period // pmp.LOOP_PERIOD
    scene = synth.make_scene(seed=pmp.LOOP_SEED, n_points=pmp.LOOP_POINTS, n_frames=n_frames, trajectory="loop",
                             cfg=cfg, period=period)
    frames = [synth.observe(scene, i, noise_px=pmp.LOOP_NOISE_PX, desc_flips=pmp.LOOP_DESC_FLIPS)[0]
              for i in range(n_frames)]
    eng = Engine(cfg)
    if not gba:
        eng._start_gba = lambda iters: None
    t0 = time.perf_counter()
    around = {}
    # per frame throughout, or the first 8 frames one by one and then batches of ``batch``
    n_single = 8 if batch else n_frames
    steps = [(i, 1) for i in range(n_single)]
    if batch:
        steps += [(i, batch) for i in range(n_single, n_frames - batch + 1, batch)]
    for i, b in steps:
        n_closed = len(eng._loop.closed_loops)
        before = _ate(eng, scene, with_scale=True)[0] if n_closed == 0 else None
        in_flight = eng._gba is not None
        if i >= n_single:
            eng.track_batch(FrameArrays(*[jnp.stack(x) for x in zip(*frames[i : i + b])]),
                            [float(i + j) / 30.0 for j in range(b)])
        elif pipelined:
            eng.track_features_async(frames[i], float(i) / 30.0)
        else:
            eng.track_features(frames[i], float(i) / 30.0)
        if n_closed == 0 and eng._loop.closed_loops:
            around = {"first_closure_frame": i, "ate_before_m": before,
                      "ate_after_m": _ate(eng, scene, with_scale=True)[0]}
        if in_flight and eng._gba is None and "ate_after_gba_m" not in around:
            around.update(first_gba_folded_frame=i, ate_after_gba_m=_ate(eng, scene, with_scale=True)[0])
        if eng.trajectory and (len(eng._loop.closed_loops) > n_closed or i % 20 < b):
            rec = eng.trajectory[-1]   # the last resolved frame
            print(f"frame {i}: {rec.state} tracked={rec.n_tracked} kfs={eng.kf_count} "
                  f"closed={eng._loop.closed_loops} t={time.perf_counter() - t0:.1f}s", flush=True)
    in_flight = eng._gba is not None
    eng.flush()
    if in_flight and "ate_after_gba_m" not in around:
        around.update(first_gba_folded_frame="flush", ate_after_gba_m=_ate(eng, scene, with_scale=True)[0])
    ate, span, share = _ate(eng, scene, with_scale=True)
    seq = np.asarray(eng.m.kfs.seq)
    closed = [[int(a), int(b), int(seq[a]), int(seq[b])] for a, b in eng._loop.closed_loops]
    states = [r.state for r in eng.trajectory]
    return {"workload": "loop", "config": "tum" if tum else "loop test", "batch": batch,
            "pipelined": pipelined, "period": period, "gba": gba, "gba_runs": eng.stats["gba_runs"],
            "frames": len(states), "state": eng.state, "kf_count": eng.kf_count, "closed_slots_and_seqs": closed,
            **around, "ok_share": share, "ok_share_all_frames": states.count("OK") / len(states), "ate_m": ate,
            "span_m": span, "ate_gate_m": None if span is None else 0.05 * span,
            "lost_frames": [r.frame_id for r in eng.trajectory if r.state == "LOST"],
            "seconds": time.perf_counter() - t0}


def run_mono_batch() -> dict:
    from dialog_tpu.frontend import extract_features_batch

    tcfg = pmp.tum_mono_config()
    cfg = reference_config(tcfg, vocab=True)
    n_frames, n_single, occlude_at = pmp.MONO_BATCH_FRAMES, 8, 48
    scene, frames = pmp.render_frames(tcfg, n_frames)
    out = {"workload": "mono_batch", "frames": n_frames, "kf_interval": 10}
    t0 = time.perf_counter()

    per_frame = Engine(cfg)
    per_frame.kf_interval = 10
    for i in range(n_frames):
        rec = per_frame.track_image(jnp.asarray(frames[i]), float(i) / 30.0)
        print(f"per frame {i}: {rec.state} tracked={rec.n_tracked} kfs={per_frame.kf_count} "
              f"t={time.perf_counter() - t0:.1f}s", flush=True)
    ate, _, share = _ate(per_frame, scene, with_scale=True)
    out["per_frame"] = {"state": per_frame.state, "kf_count": per_frame.kf_count, "ok_share": share, "ate_m": ate,
                        "ate_by_frame_m": _ate_prefixes(per_frame, scene)}

    eng = Engine(cfg)
    eng.kf_interval = 10
    for i in range(n_single):
        eng.track_image(jnp.asarray(frames[i]), float(i) / 30.0)
    for i in range(n_single, n_frames - pmp.BATCH + 1, pmp.BATCH):
        batch = extract_features_batch(jnp.asarray(np.stack(frames[i : i + pmp.BATCH])), cfg)
        if i == occlude_at:
            batch = batch._replace(valid=batch.valid.at[: pmp.BATCH // 2].set(False))
        recs = eng.track_batch(batch, [float(i + j) / 30.0 for j in range(pmp.BATCH)])
        print(f"batch at {i}: resolved {[r.state for r in recs].count('OK')}/{len(recs)} OK kfs={eng.kf_count} "
              f"t={time.perf_counter() - t0:.1f}s", flush=True)
    eng.flush()
    ate, _, share = _ate(eng, scene, with_scale=True)
    out["batched"] = {"state": eng.state, "kf_count": eng.kf_count, "ok_share": share, "ate_m": ate,
                      "lost_frames": [r.frame_id for r in eng.trajectory if r.state == "LOST"]}
    out["seconds"] = time.perf_counter() - t0
    return out


def _ate_prefixes(eng, scene, step: int = 8) -> list:
    """The similarity-aligned ATE of the first n frames' OK records, every ``step`` frames (the
    poses as they stand at the end of the run)."""
    poses = eng.positions
    out = []
    for n in range(16, len(eng.trajectory) + 1, step):
        ok = [i for i, r in enumerate(eng.trajectory[:n]) if r.state == "OK"]
        gt = np.stack([-scene.R[eng.trajectory[i].frame_id].T @ scene.t[eng.trajectory[i].frame_id] for i in ok])
        out.append([n, float(ate_rmse(poses[ok], gt, with_scale=True))])
    return out


def _warm_loop_paths(eng):
    """bench.py's ``_warm_loop_paths`` (``bench.py:70-92``), copied: importing
    bench.py turns on JAX's persistent compilation cache for the process."""
    if eng._vocab is None:
        return
    saved = (eng._loop._pending_detect, list(eng._loop._consistent), eng._loop._eval_stamp,
             eng._loop.last_eval_det_seq)
    eng._loop._pending_detect = None
    eng._loop.dispatch(eng.m, eng._bow_db, eng._vocab, max(eng.kf_count - 1, 0))
    det = eng._loop.take_pending()
    if det is not None:
        eng._loop.evaluate(det[0], np.asarray(det[1]), det[2])
    (eng._loop._pending_detect, eng._loop._consistent, eng._loop._eval_stamp,
     eng._loop.last_eval_det_seq) = saved


def bench_schedule(eng, n_frames, fps, one, extract, recover, *, n_single, warm_end, occlude_at, B=8,
                   log=lambda msg: None) -> dict:
    """bench.py's loop (``bench.py:100-142``, ``172-203``), copied, over any
    frames: ``one(i)`` the per-frame entry of the first ``n_single`` frames,
    ``extract(i)`` frames [i, i + B) through the batched frontend, ``recover(i)``
    the per-frame entry until OK. Returns the timed window's first frame and
    its count by bench.py's formula."""
    def run_batch(i, occlude=False):
        batch = extract(i)
        if occlude:
            batch = batch._replace(valid=batch.valid.at[: B // 2].set(False))
        eng.track_batch(batch, [float(i + j) / fps for j in range(B)])
        log(f"batch at {i}: kfs={eng.kf_count} state={eng.state}")

    for i in range(n_single):
        one(i)
    for i in range(n_single, warm_end, B):
        run_batch(i, occlude=(i == occlude_at))
    eng.flush()
    _warm_loop_paths(eng)
    while eng.frame_id < warm_end + 2 * B and eng.state != "OK":
        recover(eng.frame_id)
    start = ((eng.frame_id + B - 1) // B) * B
    for i in range(start, n_frames - B + 1, B):
        run_batch(i)
    eng.flush()
    return {"start": start, "n_timed": ((n_frames - B + 1 - start) // B) * B}


BENCH_WARMUP = {"mono": dict(n_single=8, warm_end=104, occlude_at=48),
                "stereo": dict(n_single=4, warm_end=64, occlude_at=28)}


def run_bench(workload: str) -> dict:
    """One of bench.py's workloads on the reference engine, as bench.py runs it."""
    import jax

    from dialog_tpu.config import KITTI00
    from dialog_tpu.datasets import synth
    from dialog_tpu.frontend import extract_features_batch
    from dialog_tpu.stereo import extract_and_match_stereo_batch

    B = pmp.BATCH
    t0 = time.perf_counter()

    def log(msg):
        print(f"{msg} t={time.perf_counter() - t0:.1f}s", flush=True)

    if workload == "bench_stereo":
        cfg = KITTI00.replace(max_keyframes=256, max_landmarks=32768)
        n_frames, fps, stereo = 168, 10.0, True
        scene = synth.make_scene(seed=7, n_points=6000, n_frames=n_frames, cfg=cfg)
        scene_r = scene._replace(t=scene.t - np.array([cfg.baseline, 0.0, 0.0], np.float32))
        left = [jnp.asarray(synth.render_image(scene, i)) for i in range(n_frames)]
        right = [jnp.asarray(synth.render_image(scene_r, i)) for i in range(n_frames)]
        eng = Engine(cfg)

        def one(i):
            eng.track_stereo(left[i], right[i], float(i) / fps)

        def extract(i):
            return extract_and_match_stereo_batch(jnp.stack(left[i : i + B]), jnp.stack(right[i : i + B]), cfg)

        recover = one
    else:
        cfg = JConfig(
            width=640, height=480, n_features=1000, max_features=1024,
            max_keyframes=256, max_landmarks=16384, max_local_lms=2048,
            max_local_kfs=16, max_fixed_kfs=16, max_obs_per_lm=8,
            local_ba_iters=5, max_frames_between_kf=30,
        )
        n_frames, fps, stereo = 264, 30.0, False
        scene = synth.make_scene(seed=3, n_points=2500, n_frames=n_frames, cfg=cfg)
        images = [jnp.asarray(synth.render_image(scene, i)) for i in range(n_frames)]
        eng = Engine(cfg)
        eng.kf_interval = 10 if workload == "bench_kf10" else 30

        def one(i):
            eng.track_image(images[i], float(i) / fps)

        def extract(i, n=B):
            return extract_features_batch(jnp.stack(images[i : i + n]), cfg)

        def recover(i):
            eng.track_features(jax.tree_util.tree_map(lambda x: x[0], extract(i, 1)), float(i) / fps)

    relocalized = [0]
    try_relocalize = eng._try_relocalize

    def counted(*args):
        rec = try_relocalize(*args)
        relocalized[0] += rec is not None
        return rec

    eng._try_relocalize = counted
    warmup = BENCH_WARMUP["stereo" if stereo else "mono"]
    window = bench_schedule(eng, n_frames, fps, one, extract, recover, **warmup, B=B, log=log)
    states = [r.state for r in eng.trajectory]
    frames = [round(r.timestamp * fps) for r in eng.trajectory]
    blanked = set(range(warmup["occlude_at"], warmup["occlude_at"] + B // 2))
    first_ok = states.index("OK") if "OK" in states else len(states)
    kept = [s == "OK" for i, s in enumerate(states) if i >= first_ok and frames[i] not in blanked]
    ate, _, _ = _ate(eng, scene, with_scale=not stereo, fps=fps)
    return {"workload": workload, "frames": len(states), "state": eng.state, "first_ok": first_ok,
            "ok_share": float(np.mean(kept)) if kept else 0.0, "keyframes": eng.kf_count,
            "relocalizations": relocalized[0],
            "recovered": sum(1 for a, b in zip(states, states[1:]) if a == "LOST" and b == "OK"),
            "loop_closures": len(eng._loop.closed_loops),
            "lost_frames": [f for f, s in zip(frames, states) if s == "LOST"],
            "frames_not_fed": sorted(set(range(n_frames)) - set(frames)), "ate_m": ate,
            "ate_alignment": "metric" if stereo else "similarity", "timed_first_frame": window["start"],
            "timed_frames": window["n_timed"], "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("workload", choices=["stereo", "rgbd", "loop", "mono_batch", "bench_kf10", "bench_kf30",
                                         "bench_stereo"])
    ap.add_argument("--tum", action="store_true", help="loop: the TUM-class configuration (max_frames_between_kf 6)")
    ap.add_argument("--batch", type=int, default=0, help="loop: 8 frames one by one, then batches of this size")
    ap.add_argument("--pipelined", action="store_true", help="loop: every frame through track_features_async")
    ap.add_argument("--period", type=int, default=pmp.LOOP_PERIOD,
                    help="loop: frames a lap (the run keeps LOOP_FRAMES / LOOP_PERIOD laps)")
    ap.add_argument("--no-gba", action="store_true", help="loop: no global BA after a closure")
    args = ap.parse_args()
    if args.workload == "loop":
        out = run_loop(args.tum, args.batch, args.pipelined, args.period, gba=not args.no_gba)
    elif args.workload == "mono_batch":
        out = run_mono_batch()
    elif args.workload.startswith("bench_"):
        out = run_bench(args.workload)
    else:
        out = run_images(args.workload)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
