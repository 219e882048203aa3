"""One run of one cell: set-up, the timed window, and what the window held.

A cell is a configuration (``configs/<name>.json``: the engine's settings and
the scene) under a traffic mix
(``traffic/<name>.json``: the entry, the batch, the warm-up, the samples the
check draws). Both are data; this module drives any pairing of them.

Entries: ``batch`` feeds B consecutive sweep frames through the batched
frontend (``frontend.extract_features_batch``, or
``stereo.extract_and_match_stereo_batch`` for a stereo configuration) and
``Engine.track_batch``, the next batch after the previous call returns;
``online`` feeds one frame at a time through ``Engine.track_image`` (or
``track_stereo``), the next after the previous pose returns. The window runs
for the given seconds, ends in ``flush`` and a device synchronisation, and
counts every frame it submitted.
"""

from __future__ import annotations

import json
import math
import pathlib
import time

import numpy as np
import torch

from . import scene as scene_mod
from .probes import Probes

HERE = pathlib.Path(__file__).resolve().parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def engine_config(conf: dict):
    """The port's EngineConfig from a configuration file's ``engine`` block."""
    from dialog_tpu_torch.config import EngineConfig, Sensor

    kw = dict(conf["engine"])
    kw["sensor"] = Sensor[kw["sensor"]]
    return EngineConfig(**kw)


def camera(conf: dict) -> dict:
    """The numbers the generator and the reference read, from the configuration file."""
    e = conf["engine"]
    keys = ("fx", "fy", "cx", "cy", "width", "height", "n_features", "scale_factor", "n_levels", "ini_th_fast",
            "min_th_fast", "th_high")
    cam = {k: e[k] for k in keys if k in e}
    cam["bf"] = e.get("bf", 0.0)
    cam.setdefault("th_high", 100)
    return cam


class Stream:
    """The cell's frames on the device, and the sweep over them.

    The scene (geometry, trajectory and the landmarks' textures) is the
    configuration's own, drawn from ``scene.seed``: every run feeds the same
    frames in the same order, so every run does the same work. The run's seed
    draws which of the window's answers the output check samples. (Any change
    to the images changes the keyframes the engine takes, and with them the
    work: seeded scenes or textures spread the rate across seeds 3-20 times
    wider than the runs of one seed.)"""

    def __init__(self, conf: dict, device):
        sc = conf["scene"]
        cam = camera(conf)
        self.scene = scene_mod.make_scene(sc["seed"], sc["points"], sc["frames"])
        self.n = sc["frames"]
        self.fps = conf["engine"]["fps"]
        tex = scene_mod.textures(len(self.scene.xyz), sc["seed"])
        self.left = scene_mod.render(self.scene, cam, tex, device)
        self.right = None
        if sc.get("stereo"):
            self.right = scene_mod.render(scene_mod.shifted(self.scene, cam["bf"] / cam["fx"]), cam, tex, device)

    def frames(self, step: int, count: int) -> list[int]:
        """Scene frames of the run's steps [step, step + count)."""
        return scene_mod.sweep_order(self.n, step, count)


class Runner:
    """Drives one engine through set-up and the window for a (configuration, traffic) pair."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device, traced: bool):
        from dialog_tpu_torch.system import Engine

        self.conf, self.traffic = conf, traffic
        self.device = torch.device(device)
        self.cfg = engine_config(conf)
        self.stereo = bool(conf["scene"].get("stereo"))
        self.B = int(traffic["batch"])
        self.entry = traffic["entry"]
        self.stream = Stream(conf, self.device)
        self.eng = Engine(self.cfg, device=self.device)
        self.step = 0                 # the sweep step the next frame takes
        self.probes = Probes(seed, traffic["samples"], traced)
        self.frame_s = []             # per-call host seconds in the window (online)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ts(self, step: int) -> float:
        return float(step) / self.stream.fps

    # --- entries ------------------------------------------------------------

    def _one(self, k: int):
        left = self.stream.left[k]
        if self.stereo:
            return self.eng.track_stereo(left, self.stream.right[k], self.ts(self.step))
        return self.eng.track_image(left, self.ts(self.step))

    def feed_one(self):
        k = self.stream.frames(self.step, 1)[0]
        rec = self._one(k)
        self.step += 1
        return k, rec

    def extract(self, ks: list[int]):
        from dialog_tpu_torch.frontend import extract_features_batch
        from dialog_tpu_torch.stereo import extract_and_match_stereo_batch

        idx = torch.tensor(ks, device=self.device)
        if self.stereo:
            return extract_and_match_stereo_batch(self.stream.left[idx], self.stream.right[idx], self.cfg)
        return extract_features_batch(self.stream.left[idx], self.cfg)

    def feed_batch(self, sample=None):
        ks = self.stream.frames(self.step, self.B)
        batch = self.extract(ks)
        if sample is not None:
            sample(ks, batch)
        self.eng.track_batch(batch, [self.ts(self.step + j) for j in range(self.B)])
        self.step += self.B

    # --- set-up -------------------------------------------------------------

    def warm_up(self) -> dict:
        """Frames one by one until the engine is OK (the initialization both
        entries need); then, through the cell's own entry, until the map holds
        ``warm_kfs`` keyframes (the local BA and the vocabulary trained), and
        the loop detection's paths once. Returns what set-up did."""
        from dialog_tpu_torch.system import OK

        from .warm import warm_loop_paths

        want, limit = int(self.traffic["warm_kfs"]), int(self.traffic["warm_max_frames"])
        while self.eng.state != OK and self.step < limit:
            self.feed_one()
        while (self.eng.kf_count < want or self.eng.state != OK) and self.step < limit:
            if self.entry == "batch":
                self.feed_batch()
            else:
                self.feed_one()
        self.eng.flush()
        warm_loop_paths(self.eng)
        if self.eng.state != OK or self.eng.kf_count < want:
            raise RuntimeError(f"set-up: the engine is {self.eng.state} with {self.eng.kf_count} keyframes "
                               f"after {self.step} frames")
        self.sync()
        return {"warm_frames": self.step, "keyframes": self.eng.kf_count}

    # --- the window ---------------------------------------------------------

    def window(self, seconds: float, profiler=None) -> dict:
        """Feed the traffic for ``seconds``; every frame submitted counts.
        With ``profiler`` (a factory of a profiler context, given whether to
        trace the host too), the window is followed by two traced stretches of
        ``trace_frames`` frames each, which the end-to-end numbers leave out:
        the device alone (its busy and idle time, with the host's pace least
        disturbed), then host and device (the layers' ranges and the
        launches)."""
        from dialog_tpu_torch.system import OK

        eng = self.eng
        fid0 = eng.frame_id
        kf0, reloc0, loops0 = eng.kf_count, eng.stats["relocalizations"], len(eng._loop.closed_loops)
        trace = {}
        marks = []                    # (seconds into the window, frames submitted, keyframes) after each call
        self.probes.install()
        try:
            t0 = time.perf_counter()
            submitted = 0
            while time.perf_counter() - t0 < seconds:
                submitted += self._step(record_time=True)
                marks.append((time.perf_counter() - t0, submitted, eng.kf_count - kf0))
            eng.flush()
            self.sync()
            elapsed = time.perf_counter() - t0
            kf_win = eng.kf_count - kf0
            submitted_all = submitted
            if profiler is not None:
                for host in (False, True):
                    submitted_all += self._traced_stretch(profiler(host), host, trace)
        finally:
            self.probes.remove()
        recs = [r for r in eng.trajectory if fid0 <= r.frame_id < fid0 + submitted_all]
        states = [r.state for r in recs]
        # a tracked frame whose pose repeats the previous tracked frame's bit for bit (a LOST record
        # carries the last pose by design, and is counted as lost instead)
        poses = [(np.asarray(r.R, np.float32), np.asarray(r.t, np.float32)) for r in recs if r.state == OK]
        stuck = sum(1 for a, b in zip(poses, poses[1:]) if np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
        step0 = self.step - submitted_all
        not_ok = [(r.frame_id - fid0, r.state) for r in recs if r.state != OK]
        content = {
            "frames": submitted, "seconds": elapsed, "keyframes": kf_win,
            "not_ok": [[step0 + i, self.stream.frames(step0 + i, 1)[0], s] for i, s in not_ok[:20]],
            "loop_closures": len(eng._loop.closed_loops) - loops0,
            "relocalizations": eng.stats["relocalizations"] - reloc0,
            "states": {s: states.count(s) for s in sorted(set(states))},
            "sweep_passes": submitted / max(self.stream.n - 1, 1),
            "keyframes_in_map": eng.kf_count, "lm_dropped": eng.stats["lm_dropped"],
            "fifths": _fifths(marks, elapsed),
        }
        liveness = {"unanswered": submitted_all - len({r.frame_id for r in recs}),
                    "lost": sum(1 for s in states if s != OK), "stuck": stuck}
        return {"content": content, "liveness": liveness, "trace": trace}

    def _traced_stretch(self, prof, host: bool, trace: dict) -> int:
        """``trace_frames`` frames under ``prof``; records into ``trace`` the profiler and the
        stretch's frames, seconds and keyframes, under ``host`` or ``device``."""
        eng = self.eng
        prof.__enter__()
        self.probes.recording = host
        kf1, n, t1 = eng.kf_count, 0, time.perf_counter()
        while n < int(self.traffic["trace_frames"]):
            n += self._step(record_time=False)
        eng.flush()
        self.sync()
        trace["host" if host else "device"] = {"prof": prof, "frames": n, "window_s": time.perf_counter() - t1,
                                               "keyframes": eng.kf_count - kf1}
        self.probes.recording = False
        prof.__exit__(None, None, None)
        return n

    def _step(self, record_time: bool) -> int:
        """One call of the cell's entry; returns the frames it submitted."""
        if self.entry == "batch":
            self.feed_batch(self._sample_batch)
            return self.B
        res = self.probes.samples["frames"]
        slot = res.wants()
        k0 = time.perf_counter()
        k, _ = self.feed_one()
        if record_time:
            self.frame_s.append(time.perf_counter() - k0)
        if slot is not None:
            res.put(slot, ([k], _lead(self.probes.last["stereo" if self.stereo else "frontend"])))
        return 1

    def _sample_batch(self, ks, batch):
        res = self.probes.samples["frames"]
        for b, k in enumerate(ks):
            slot = res.wants()
            if slot is not None:
                res.put(slot, ([k], type(batch)(*[x[b : b + 1] for x in batch])))


def _lead(frame):
    """A single frame's FrameArrays with a leading batch of one."""
    return type(frame)(*[x[None] for x in frame])


def _fifths(marks, elapsed: float) -> list:
    """[frames/s, keyframes] in each fifth of the window (a call counts in the fifth it ends in):
    whether the window's pace drifts as the map grows."""
    out, prev_f, prev_k = [], 0, 0
    for i in range(1, 6):
        end = elapsed * i / 5
        f, k = prev_f, prev_k
        for t, fi, ki in marks:
            if t <= end:
                f, k = fi, ki
        out.append([(f - prev_f) / (elapsed / 5), k - prev_k])
        prev_f, prev_k = f, k
    return out


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by the nearest rank."""
    v = sorted(values)
    return float(v[max(0, min(len(v) - 1, math.ceil(q / 100.0 * len(v)) - 1))])
