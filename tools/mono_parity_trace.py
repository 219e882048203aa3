"""Where the port's mono bench warm-up first decides otherwise than the JAX engine (ROADMAP D22).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/mono_parity_trace.py [--draws own|reference] [--frames-from own|jax]
        [--frames 56|104] [--threads 4]
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/mono_parity_trace.py --jax-seeds 0-15

Drives ``tum_mono_kf10``, the bench's primary workload, exactly as the bench
does (``make_scene(seed=3, n_points=2500, n_frames=264)``, 640x480, 1,000
features, ``bench.py:260-266``'s capacities, ``kf_interval`` 10, loop
detection on): 8 frames one by one, then batches of 8 up to ``--frames`` (56
by default, 104 for the bench's whole warm-up) with the first half of the
batch at frame 48 blanked, ``flush``, the loop paths warmed, and frames one by
one until the run is OK. The JAX engine runs through
``tools/reference_ate.bench_schedule``, the port's (``device="cpu"``) through
``dialog_tpu_torch.bench.schedule``.

``--draws reference``: the port takes every random draw from the JAX engine's
key stream, in its order (``tests/test_torch_batch_engine.ReferenceStream``:
the two-view minimal sets, the vocabulary's initial words, the PnP and the
Sim3 minimal sets); ``own``: from its own generator (ROADMAP D3).
``--frames-from jax``: both engines take the JAX engine's extracted features
(its ``extract_features`` per image and ``extract_features_batch`` per
batch), so the frontends' rounding (D8) is set aside too.

Per frame it prints each engine's state, ``n_tracked`` and keyframe count,
the distance between the two camera centres and from each to the ground truth
(each trajectory similarity-aligned to it over the run), and the allocated and
valid landmark counts, each taken when the engine recorded the frame.

On the JAX engine's state, as it runs:

* the two-view initialization: the port's ``initialize_two_view`` on the JAX
  engine's matched pairs with the JAX engine's minimal sets (its key), against
  the JAX result: success, the model (F or H), the good points, R and t, and
  D2's conditioning (the baseline over the median depth of the points); and
  how many of 16 other draws (seeds 0-15 of each package's RNG) succeed on
  the same pairs;
* every ``fused_track_step`` and ``fused_track_multi`` call: the port's on the
  same inputs (``stereo_parity_trace.replay_track`` /
  ``replay_track_multi``), and at each batch's resolve ``_resolve_batch``'s
  two decisions (the first frame under ``min_inliers_local``, the keyframe
  at the last frame) from the JAX rows and from the port's;
* at each keyframe, the port's ``process_new_keyframe`` step by step on the
  JAX map (``stereo_parity_trace.replay_keyframe``: insert, neighbours,
  ``triangulate_fanout``, each fuse pair, recount, covisibility, refreshes,
  culls), and the port's local BA on the JAX engine's window
  (``replay_local_ba``);
* at every relocalization attempt: the JAX engine's map, codebook, BoW rows
  and bookkeeping carried into a port engine (as ``tests/test_torch_reloc.py``
  does), and the port's ``_try_relocalize`` run on the same frame with the JAX
  engine's PnP draws (its key as it stood). Per candidate: keyframe, BoW score
  and shared words, descriptor matches against 15, PnP inliers against 15
  (and with 16 other draws), refined inliers against 25, beside the JAX
  engine's (``tools/reloc_margin.Recorder``).

A step differs beyond a rounding edge when its output differs and the
difference is not explained by float32 rounding on the same inputs: a
triangulation candidate is explained when ``is_rounding_edge`` says so; a
tracking association when the final chi2 of the landmark either package bound
lies within TRACK_EDGE_REL of the gate; a pose alone (no association or count
differing) within TRACK_POSE_TOL; local BA within LBA_POSE_TOL; the
relocalization when the carried attempt's candidates, matches and outcome
agree and its inlier counts are within 2. Everything else is a split.

``--jax-seeds``: the JAX engine alone over the warm-up once per key
``PRNGKey(s)``, and per key the frame it initialized at, the frame-52
relocalization attempt and the ATE (how far the reference's own recovery
rests on its draws; ``tools/reloc_draw_sweep.py`` does the same for the port).

The last line is a JSON object: the first replayed step that differs beyond a
rounding edge (or null); per step kind the replays, those that differ and the
frame of the first split; the frame-52 relocalization of the JAX engine, of
the port and of the port on the JAX engine's carried map (candidate, score,
shared words, matches, PnP inliers with its draw and the range over 16 other
draws, refined inliers) beside the gates (15 / 15 / 25); the frames each
engine relocalized and initialized at; the first frame the two runs decide
differently (state, n_tracked or keyframe count); each engine's ATE over the
warm-up. CPU readings; 5-8 min to frame 56 or 103 at 2 threads.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import dialog_tpu.pnp as jpnp
import dialog_tpu.system as jsystem
import dialog_tpu.tracking as jtracking
from dialog_tpu import mapping as jmap, vocab as jvocab
from dialog_tpu.optim import local_ba as jlba
from dialog_tpu_torch import bench as tbench, init2view as tinit, interop, pnp as tpnp
from dialog_tpu_torch import system as tsystem, tracking as ttracking, vocab as tvocab
from dialog_tpu_torch.containers import FrameArrays
from dialog_tpu_torch.eval.ate import align_umeyama, ate_rmse
from dialog_tpu_torch.profile_main_path import tum_mono_config

from reference_ate import bench_schedule, reference_config
from reloc_margin import MIN_MATCHES, PNP_MIN_INLIERS, REDRAWS, Recorder, _bow_detail
from stereo_parity_trace import (REL_TOL, replay_keyframe, replay_local_ba, replay_track, replay_track_multi,
                                 to_port)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_batch_engine import ReferenceStream  # noqa: E402

B = 8
FPS = 30.0
OCCLUDE_AT = 48
RELOC_FRAME = 52          # the JAX engine's relocalization after the blanked frames
KF_INTERVAL = 10          # tum_mono_kf10
TRACK_EDGE_REL = 0.05     # an association flipped at the chi2 gate: the final chi2 this close to it, relative
TRACK_POSE_TOL = 1e-3     # a pose apart this far with every association equal: f32 solver rounding
LBA_POSE_TOL = 1e-3       # local BA keyframe poses on the same window
NEAR = 0.1                # map units (median depth 1): landmarks nearer than this to their camera
INIT_REDRAWS = 16        # two-view attempts solved again with other draws (seeds 0..15 of each package's RNG)
DRAW_PNP = tpnp.draw_pnp_sets     # the port's own draw, kept for the redraws while a stream is patched in


# ---------------------------------------------------------------------------
# the replays' verdicts
# ---------------------------------------------------------------------------


def track_split(rep: dict) -> bool:
    """A tracking replay differs beyond a rounding edge."""
    if not rep["diffs"]:
        return False
    feats = rep["features"]
    if not feats:
        return rep["pose_gap"] > TRACK_POSE_TOL
    for f in feats:
        near_gate = [abs(f[k][0] - f[k][1]) <= TRACK_EDGE_REL * f[k][1] for k in ("jax_chi2", "port_chi2") if k in f]
        if not any(near_gate):
            return True
    return False


def deciding(c: dict) -> bool:
    """A triangulation candidate (``tri_candidates``) on which the two packages decide differently at that
    neighbour: one package's ``_tri_candidates`` accepts it and the other's does not, or both accept it at points
    more than REL_TOL apart. The other entries list the same feature at neighbours where both decide alike."""
    if c["jax_tri_candidates_good"] != c["port_tri_candidates_good"]:
        return True
    if not c["jax_tri_candidates_good"]:
        return False
    a, b = np.array(c["jax"]["X"]), np.array(c["port"]["X"])
    return bool(np.linalg.norm(a - b) > REL_TOL * max(np.linalg.norm(a), 1e-12))


def keyframe_split(steps: list[dict]) -> dict | None:
    """The first step of a keyframe replay that differs beyond a rounding edge: a triangulation whose deciding
    candidates are all rounding edges (``is_rounding_edge``) is explained; any other difference is not."""
    for s in steps:
        if not s["diffs"]:
            continue
        decide = [c for c in s.get("candidates", []) if deciding(c)]
        if s["step"] == "triangulate_fanout" and decide and all(c["rounding_edge"] for c in decide):
            continue
        return s
    return None


def resolve_decisions(jeng, rows: np.ndarray, fids: list[int]) -> dict:
    """``_resolve_batch``'s two decisions from a batch's packed rows, on the
    JAX engine's state as the resolve starts."""
    n = rows[:, 24].astype(int)
    low = np.nonzero(n < jeng.cfg.min_inliers_local)[0]
    lost_at = int(low[0]) if len(low) else None
    kf = None if lost_at is not None else bool(jeng._need_keyframe(int(n[-1]), fid=fids[-1]))
    return {"lost_at": lost_at, "keyframe": kf}


# ---------------------------------------------------------------------------
# the JAX engine's relocalization, carried into the port
# ---------------------------------------------------------------------------


def carry(jeng, tcfg) -> tsystem.Engine:
    """A port engine holding the JAX engine's map, codebook, BoW rows and
    bookkeeping (``tests/test_torch_reloc.py``)."""
    teng = tsystem.Engine(tcfg, device="cpu")
    teng.loop_closing_enabled = False
    teng.m = to_port(jeng.m)
    teng._vocab = interop.vocab_from_numpy(jax.device_get(jeng._vocab), device="cpu")
    teng._bow_db = torch.from_numpy(np.array(jeng._bow_db))
    teng._vocab_trained_kfs = jeng._vocab_trained_kfs
    teng.kf_count, teng.ref_kf, teng.frame_id, teng.state = jeng.kf_count, jeng.ref_kf, jeng.frame_id, jeng.state
    teng._last_R, teng._last_t = np.array(jeng._last_R), np.array(jeng._last_t)
    teng._kf_valid_host = np.array(jeng.m.kfs.valid)
    return teng


def port_attempt(teng, frame, ts, key) -> dict:
    """The port's ``_try_relocalize`` on ``frame``, its PnP sets drawn from the
    JAX key ``key`` in the JAX engine's order (one split per PnP call)."""
    stream = {"key": key}

    def draws(valid, iters, generator=None):
        stream["key"], sub = jax.random.split(stream["key"])
        return torch.from_numpy(np.array(jax.random.randint(sub, (iters, 6), 0, max(int(valid.sum()), 1))))

    rec = Recorder(teng, ttracking, tpnp, tsystem, int, _port_redraw(teng.cfg))
    inner = teng._try_relocalize
    tpnp.draw_pnp_sets = draws
    try:
        inner(frame, ts)
        _bow_detail(rec, teng, frame, tvocab, lambda x: x.numpy())
    finally:
        tpnp.draw_pnp_sets = DRAW_PNP
        rec.restore()
    return rec.attempts[-1]


def _port_redraw(cfg):
    def redraw(a, kw, seed):
        return (*a[:7], DRAW_PNP(a[2], cfg.pnp_ransac_iters, torch.Generator().manual_seed(seed))), kw
    return redraw


def reloc_agrees(j: dict, t: dict) -> bool:
    """The carried attempt decides as the JAX engine's: the same candidates, the
    same outcome, matches and inliers within 2 at every candidate."""
    if j["relocalized"] != t["relocalized"] or [c["kf"] for c in j["candidates"]] != \
            [c["kf"] for c in t["candidates"]]:
        return False
    for cj, ct in zip(j["candidates"], t["candidates"]):
        for k in ("matches", "pnp_inliers", "refined_inliers"):
            if (k in cj) != (k in ct) or (k in cj and abs(cj[k][0] - ct[k][0]) > 2):
                return False
    return True


# ---------------------------------------------------------------------------
# the two runs
# ---------------------------------------------------------------------------


class Rows:
    """What an engine holds as it records each frame."""

    def __init__(self, eng, valid_count):
        self.rows = {}
        orig = eng._append_record

        def append(rec):
            orig(rec)
            self.rows[round(rec.timestamp * FPS)] = {
                "state": rec.state, "n_tracked": int(rec.n_tracked), "kfs": eng.kf_count,
                "lms": [int(eng.m.num_lms), valid_count(eng.m)],
                "centre": (-np.asarray(rec.R, np.float64).T @ np.asarray(rec.t, np.float64)).tolist()}

        eng._append_record = append


def jax_frames(images, jcfg, jeng):
    """The JAX engine's frames, one by one and by batch, cached by (i, n): the
    JAX run and a port run fed the JAX frames take the same ones."""
    from dialog_tpu.frontend import extract_features, extract_features_batch

    cache = {}

    def single(i):
        if ("one", i) not in cache:
            cache[("one", i)] = jeng._undistort(extract_features(images[i], jcfg))
        return cache[("one", i)]

    def batch(i, n):
        if (i, n) not in cache:
            cache[(i, n)] = jeng._undistort(extract_features_batch(jnp.stack(images[i:i + n]), jcfg))
        return cache[(i, n)]

    return single, batch


def run_jax(tcfg, warm_end: int, replay: bool, single, batch, log, key_seed: int | None = None) -> dict:
    jcfg = reference_config(tcfg, vocab=True)
    jeng = jsystem.Engine(jcfg)
    jeng.kf_interval = KF_INTERVAL
    if key_seed is not None:
        jeng._key = jax.random.PRNGKey(key_seed)
    rows = Rows(jeng, lambda m: int(jnp.sum(m.lms.valid)))
    events = []     # (frame, kind, replay, split)
    rec = Recorder(jeng, jtracking, jpnp, jsystem, lambda x: int(np.asarray(x)),
                   lambda a, kw, s: ((*a[:7], jax.random.PRNGKey(s)), kw))
    carried = []
    saved = {}
    in_multi = [False]

    def add(kind, rep, split, frame=None):
        frame = int(jeng.frame_id) if frame is None else frame
        events.append({"frame": frame, "kind": kind, "split": split, "replay": rep})
        if rep.get("diffs") or split:
            text = json.dumps({k: v for k, v in rep.items() if k != "port_rows"}, default=str)
            log(f"  {kind} at frame {frame}: " + (f"SPLIT {text}" if split else f"rounding: {text[:1500]}"))

    def init_hook(uv1, uv2, ok, fx, fy, cx, cy, key, iters=256, sigma=1.0, min_good=50):
        out = saved["init"](uv1, uv2, ok, fx, fy, cx, cy, key, iters=iters, sigma=sigma, min_good=min_good)
        a = [torch.from_numpy(np.array(x)) for x in (uv1, uv2, ok)]
        key_f, key_h = jax.random.split(key)
        n_valid = max(int(np.sum(np.asarray(ok))), 1)
        picks = (torch.from_numpy(np.array(jax.random.randint(key_f, (iters, 8), 0, n_valid))),
                 torch.from_numpy(np.array(jax.random.randint(key_h, (iters, 4), 0, n_valid))))
        rt = tinit.initialize_two_view(*a, fx, fy, cx, cy, picks=picks, iters=iters, sigma=sigma, min_good=min_good)
        oj = jax.device_get(out)
        good = np.asarray(oj.good)
        z = np.asarray(oj.points)[:, 2][good]
        # how far the draw decides the attempt: the same pairs under INIT_REDRAWS other draws in each package
        others = {"jax": sum(bool(saved["init"](uv1, uv2, ok, fx, fy, cx, cy, jax.random.PRNGKey(s), iters=iters,
                                                sigma=sigma, min_good=min_good).success) for s in range(INIT_REDRAWS)),
                  "port": sum(bool(tinit.initialize_two_view(
                      *a, fx, fy, cx, cy, iters=iters, sigma=sigma, min_good=min_good,
                      generator=torch.Generator().manual_seed(s)).success) for s in range(INIT_REDRAWS))}
        rep = {"success": [bool(oj.success), bool(rt.success)], "used_h": [bool(oj.used_h), bool(rt.used_h)],
               "successes_in_other_draws": others,
               "n_good": [int(oj.n_good), int(rt.n_good)],
               "good_differ": int((good != rt.good.numpy()).sum()),
               "R_gap": float(np.abs(np.asarray(oj.R) - rt.R.numpy()).max()),
               "t_gap": float(np.abs(np.asarray(oj.t) - rt.t.numpy()).max()),
               "baseline_over_median_depth": float(1.0 / np.median(z)) if len(z) else None,
               "matched_pairs": int(n_valid)}
        rep["diffs"] = [k for k in ("success", "used_h", "n_good") if rep[k][0] != rep[k][1]]
        if rep["good_differ"]:
            rep["diffs"].append("good")
        if rep["R_gap"] > TRACK_POSE_TOL or rep["t_gap"] > TRACK_POSE_TOL:
            rep["diffs"].append("pose")
        # the points differ where the model does: an f32 homography at a small baseline (D2) is the known edge
        add("initialize_two_view", rep, bool(rep["diffs"]) and rep["success"][0] != rep["success"][1])
        return out

    def step_hook(*a, **kw):
        out = saved["step"](*a, **kw)
        if not in_multi[0]:
            rep = replay_track(jax.device_get(a[:8]), dict(kw), jax.device_get(out), tcfg)
            add("fused_track_step", rep, track_split(rep))
        return out

    def multi_hook(*a, **kw):
        in_multi[0] = True
        try:
            out = saved["multi"](*a, **kw)
        finally:
            in_multi[0] = False
        rep = replay_track_multi(jax.device_get(a[:9]), dict(kw), jax.device_get(out), tcfg)
        saved["last_multi"] = rep
        add("fused_track_multi", rep, track_split(rep))
        return out

    def keyframe_hook(*a, **kw):
        args = jax.device_get(a[:9])
        out = saved["kf"](*a, **kw)
        jmap.process_new_keyframe = saved["kf"]
        try:
            steps = replay_keyframe(args, dict(kw), tcfg, jcfg)
        finally:
            jmap.process_new_keyframe = keyframe_hook
        split = keyframe_split(steps)
        diffs = [s for s in steps if s["diffs"]]
        add("process_new_keyframe", {"slot": int(args[7]), "frame_of_keyframe": int(args[5]),
                                     "diffs": [f"{s['step']}: {s['diffs']}" for s in diffs],
                                     "first_split": split, "steps": steps}, split is not None, frame=int(args[5]))
        return out

    def ba_hook(m, slot, cfg_, iters=10):
        out = saved["ba"](m, slot, cfg_, iters=iters)
        rep = replay_local_ba(jax.device_get((m, slot, iters)), jax.device_get(out), tcfg, near=NEAR)
        # keyframe poses and landmark geometry apart by f32 solver rounding; validity or observations are not
        geometry = ("keyframe poses", "lms.xyz", "lms.normal", "lms.dmin", "lms.dmax")
        add("local_bundle_adjustment", rep,
            rep["pose_gap"] > LBA_POSE_TOL or any(not d.startswith(geometry) for d in rep["diffs"]))
        return out

    track_batch, resolve = jeng.track_batch, jeng._resolve_batch
    by_pull = {}

    def track_batch_hook(frames, ts):
        n = len(jeng._pending_b)
        saved.pop("last_multi", None)
        out = track_batch(frames, ts)
        if len(jeng._pending_b) > n and "last_multi" in saved:
            by_pull[id(jeng._pending_b[-1][5])] = saved["last_multi"]
        return out

    def resolve_hook():
        entry = jeng._pending_b[0]
        rep = by_pull.pop(id(entry[5]), None)
        if rep is not None:
            fids = entry[2]
            dj = resolve_decisions(jeng, np.asarray(entry[5]).reshape(len(fids), 26), fids)
            dt = resolve_decisions(jeng, rep["port_rows"], fids)
            r = {"frames": [fids[0], fids[-1]], "jax": dj, "port": dt, "diffs": [] if dj == dt else ["decisions"]}
            add("_resolve_batch", r, bool(r["diffs"]) and track_split(rep), frame=fids[0])
        return resolve()

    reloc_inner = jeng._try_relocalize

    def reloc_hook(frame, ts):
        jeng._ensure_vocab()            # the attempt's first step; carried state includes its codebook
        if jeng._vocab is None:
            return reloc_inner(frame, ts)
        teng = carry(jeng, tcfg)
        key = jeng._key
        out = reloc_inner(frame, ts)
        _bow_detail(rec, jeng, frame, jvocab, lambda x: np.asarray(x))
        j = rec.attempts[-1]
        t = port_attempt(teng, interop.frame_from_numpy(jax.device_get(frame), device="cpu"), ts, key)
        agrees = reloc_agrees(j, t)
        carried.append({"frame": j["frame"], "jax": j, "port_on_jax_map": t, "agrees": agrees})
        log(f"  relocalization at frame {j['frame']}: jax {'OK' if j['relocalized'] else 'no'} "
            f"{json.dumps(j['candidates'])} | port on the JAX map {'OK' if t['relocalized'] else 'no'} "
            f"{json.dumps(t['candidates'])}")
        add("_try_relocalize", {"diffs": [] if agrees else ["carried attempt"], "jax": j, "port": t},
            not agrees, frame=j["frame"])
        return out

    if replay:
        saved.update(init=jsystem.initialize_two_view, step=jtracking.fused_track_step,
                     multi=jtracking.fused_track_multi, kf=jmap.process_new_keyframe, ba=jlba.local_bundle_adjustment)
        jsystem.initialize_two_view, jtracking.fused_track_step = init_hook, step_hook
        jtracking.fused_track_multi, jmap.process_new_keyframe = multi_hook, keyframe_hook
        jlba.local_bundle_adjustment = ba_hook
        jeng.track_batch, jeng._resolve_batch = track_batch_hook, resolve_hook
        jeng._try_relocalize = reloc_hook
    else:
        def reloc_plain(frame, ts):
            out = reloc_inner(frame, ts)
            if rec.attempts:
                _bow_detail(rec, jeng, frame, jvocab, lambda x: np.asarray(x))
            return out
        jeng._try_relocalize = reloc_plain
    t0 = time.perf_counter()
    try:
        bench_schedule(jeng, warm_end, FPS, lambda i: jeng.track_features(single(i), i / FPS),
                       lambda i: batch(i, B), lambda i: jeng.track_features(
                           jax.tree_util.tree_map(lambda x: x[0], batch(i, 1)), i / FPS),
                       n_single=B, warm_end=warm_end, occlude_at=OCCLUDE_AT, B=B,
                       log=lambda msg: log(f"jax {msg} t={time.perf_counter() - t0:.0f}s"))
    finally:
        rec.restore()
        if replay:
            jsystem.initialize_two_view, jtracking.fused_track_step = saved["init"], saved["step"]
            jtracking.fused_track_multi, jmap.process_new_keyframe = saved["multi"], saved["kf"]
            jlba.local_bundle_adjustment = saved["ba"]
    return {"eng": jeng, "rows": rows.rows, "events": events, "attempts": rec.attempts, "carried": carried,
            "seconds": time.perf_counter() - t0}


def run_port(tcfg, images, warm_end: int, draws: str, frames_from: str, single, batch, log) -> dict:
    teng = tsystem.Engine(tcfg, device="cpu")
    teng.kf_interval = KF_INTERVAL
    rows = Rows(teng, lambda m: int(m.lms.valid.sum()))
    rec = Recorder(teng, ttracking, tpnp, tsystem, int, _port_redraw(tcfg))
    inner = teng._try_relocalize

    def reloc(frame, ts):
        out = inner(frame, ts)
        if rec.attempts:
            _bow_detail(rec, teng, frame, tvocab, lambda x: x.numpy())
        return out

    teng._try_relocalize = reloc
    to_t = lambda f: interop.frame_from_numpy(jax.device_get(f), device="cpu")
    if frames_from == "jax":
        one = lambda i: teng.track_features(to_t(single(i)), i / FPS)
        extract = lambda i, n: to_t(batch(i, n))
    else:
        from dialog_tpu_torch.frontend import extract_features_batch
        one = lambda i: teng.track_image(images[i], i / FPS)
        extract = lambda i, n: extract_features_batch(torch.stack(images[i:i + n]), tcfg)
    recover = lambda i: teng.track_features(FrameArrays(*[x[0] for x in extract(i, 1)]), i / FPS)
    t0 = time.perf_counter()
    orig_batch = teng.track_batch

    def logged(frames, ts):
        out = orig_batch(frames, ts)
        log(f"port batch at {round(ts[0] * FPS)}: kfs={teng.kf_count} state={teng.state} "
            f"t={time.perf_counter() - t0:.0f}s")
        return out

    teng.track_batch = logged
    try:
        if draws == "reference":
            import pytest

            with pytest.MonkeyPatch.context() as mp:
                ReferenceStream(tcfg.n_features).patch(mp)
                tbench.schedule(teng, warm_end, FPS, one, extract, recover, n_single=B, warm_end=warm_end,
                                occlude_at=OCCLUDE_AT)
        else:
            tbench.schedule(teng, warm_end, FPS, one, extract, recover, n_single=B, warm_end=warm_end,
                            occlude_at=OCCLUDE_AT)
    finally:
        rec.restore()
    return {"eng": teng, "rows": rows.rows, "attempts": rec.attempts, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------


def aligned_errors(rows: dict, scene) -> dict:
    """Per OK frame, the camera centre's distance to the truth after a
    similarity alignment of the run's OK centres."""
    ok = sorted(f for f, r in rows.items() if r["state"] == "OK")
    if len(ok) < 3:
        return {}
    est = np.array([rows[f]["centre"] for f in ok])
    gt = np.stack([-scene.R[f].T.astype(np.float64) @ scene.t[f] for f in ok])
    s, R, t = align_umeyama(est, gt, with_scale=True)
    err = np.linalg.norm((s * (R @ est.T)).T + t - gt, axis=1)
    return dict(zip(ok, err.tolist()))


def warm_up_ate(eng, scene) -> float | None:
    """The similarity-aligned ATE over the OK records, each scored at its timestamp's frame (as the bench's)."""
    recs = eng.trajectory
    ok = [i for i, r in enumerate(recs) if r.state == "OK"]
    if len(ok) < 3:
        return None
    pos = np.asarray(eng.positions)[ok]
    gt = np.stack([-scene.R[round(recs[i].timestamp * FPS)].T @ scene.t[round(recs[i].timestamp * FPS)] for i in ok])
    return float(ate_rmse(pos, gt, with_scale=True))


def compact(a: dict | None) -> dict | None:
    """A relocalization attempt (``Recorder``) in one line: its outcome and its last candidate's numbers."""
    if a is None:
        return None
    c = a["candidates"][-1] if a["candidates"] else {}
    others = c.get("pnp_inliers_other_draws")
    return {"relocalized": a["relocalized"], "kf": c.get("kf"), "score": c.get("score"),
            "shared_words": c.get("shared_words"), "matches": c.get("matches", [None])[0],
            "pnp_inliers": c.get("pnp_inliers", [None])[0],
            "pnp_other_draws": [min(others), max(others)] if others else None,
            "refined_inliers": c.get("refined_inliers", [None])[0]}


def reloc_at(attempts: list[dict], frame: int) -> dict | None:
    return compact(next((a for a in attempts if a["frame"] == frame), None))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", choices=["own", "reference"], default="own",
                    help="the port's random draws: its own generator, or the JAX engine's key stream")
    ap.add_argument("--frames-from", choices=["own", "jax"], default="own",
                    help="each engine's own frontend, or the JAX engine's frames for both")
    ap.add_argument("--frames", type=int, default=56, help="the warm-up's end (56; 104: the bench's whole warm-up)")
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    ap.add_argument("--jax-seeds", default="",
                    help="the JAX engine alone, its key PRNGKey(s) for each s (e.g. 0-15): its frame-52 attempt")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    log = lambda msg: print(msg, flush=True)
    from dialog_tpu.datasets import synth as jsynth
    from dialog_tpu_torch.datasets import synth as tsynth

    tcfg = tum_mono_config()
    jcfg = reference_config(tcfg, vocab=True)
    n_img = args.frames + 2 * B
    scene = tsynth.make_scene(seed=3, n_points=2500, n_frames=264, cfg=tcfg)
    timg = [torch.from_numpy(tsynth.render_image(scene, i)) for i in range(n_img)]
    jscene = jsynth.make_scene(seed=3, n_points=2500, n_frames=264, cfg=jcfg)
    jimg = [jnp.asarray(jsynth.render_image(jscene, i)) for i in range(n_img)]
    same_images = all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(jimg, timg))
    helper = jsystem.Engine(jcfg)
    single, batch = jax_frames(jimg, jcfg, helper)

    if args.jax_seeds:
        from reloc_draw_sweep import seeds_arg

        sweep = []
        for k in seeds_arg(args.jax_seeds):
            run = run_jax(tcfg, args.frames, False, single, batch, log, key_seed=k)
            first_ok = min((f for f, r in run["rows"].items() if r["state"] == "OK"), default=None)
            sweep.append({"key_seed": k, "initialized_at": first_ok, "reloc_frame_52": reloc_at(run["attempts"],
                                                                                                RELOC_FRAME),
                          "ate_m": warm_up_ate(run["eng"], scene), "seconds": run["seconds"]})
            log(json.dumps(sweep[-1]))
        print(json.dumps({"workload": "tum_mono_kf10", "engine": "jax", "warm_end": args.frames, "runs": sweep,
                          "relocalized_at_52": sum(bool(r["reloc_frame_52"] and r["reloc_frame_52"]["relocalized"])
                                                   for r in sweep)}), flush=True)
        return 0
    jrun = run_jax(tcfg, args.frames, True, single, batch, log)
    trun = run_port(tcfg, timg, args.frames, args.draws, args.frames_from, single, batch, log)
    jeng, teng = jrun["eng"], trun["eng"]
    gj, gt_ = aligned_errors(jrun["rows"], scene), aligned_errors(trun["rows"], scene)
    first_decision = None
    for f in sorted(set(jrun["rows"]) | set(trun["rows"])):
        a, b = jrun["rows"].get(f), trun["rows"].get(f)
        if a is None or b is None:
            log(f"frame {f}: jax {a and a['state']} | port {b and b['state']}")
            if first_decision is None:
                first_decision = f
            continue
        gap = float(np.linalg.norm(np.subtract(a["centre"], b["centre"])))
        log(f"frame {f}: jax {a['state']} tracked={a['n_tracked']} kfs={a['kfs']} lms={a['lms'][0]}/{a['lms'][1]} | "
            f"port {b['state']} tracked={b['n_tracked']} kfs={b['kfs']} lms={b['lms'][0]}/{b['lms'][1]} | centre gap "
            f"{gap:.3g}, from the truth {gj.get(f, float('nan')):.3g} / {gt_.get(f, float('nan')):.3g}")
        if first_decision is None and (a["state"], a["n_tracked"], a["kfs"]) != (b["state"], b["n_tracked"], b["kfs"]):
            first_decision = f
    events = jrun["events"]
    per_kind = {}
    for kind in ("initialize_two_view", "fused_track_step", "fused_track_multi", "_resolve_batch",
                 "process_new_keyframe", "local_bundle_adjustment", "_try_relocalize"):
        ev = [e for e in events if e["kind"] == kind]
        split = next((e["frame"] for e in ev if e["split"]), None)
        per_kind[kind] = [len(ev), sum(1 for e in ev if e["replay"].get("diffs")), split]
    splits = [e for e in events if e["split"]]
    carried = next((c["port_on_jax_map"] for c in jrun["carried"] if c["frame"] == RELOC_FRAME), None)
    out = {"workload": "tum_mono_kf10", "draws": args.draws, "frames_from": args.frames_from,
           "warm_end": args.frames, "same_images": same_images,
           "first_split_beyond_rounding": None if not splits else {
               "frame": splits[0]["frame"], "kind": splits[0]["kind"],
               "step": (splits[0]["replay"].get("first_split") or {}).get("step")},
           "replays_differing_split": per_kind,
           "reloc_frame_52": {"jax": reloc_at(jrun["attempts"], RELOC_FRAME),
                              "port": reloc_at(trun["attempts"], RELOC_FRAME), "port_on_jax_map": compact(carried)},
           "gates": [MIN_MATCHES, PNP_MIN_INLIERS, tcfg.reloc_min_inliers],
           "relocalized_at": {"jax": [a["frame"] for a in jrun["attempts"] if a["relocalized"]],
                              "port": [a["frame"] for a in trun["attempts"] if a["relocalized"]]},
           "initialized_at": {"jax": min((f for f, r in jrun["rows"].items() if r["state"] == "OK"), default=None),
                              "port": min((f for f, r in trun["rows"].items() if r["state"] == "OK"), default=None)},
           "first_decision_split": first_decision,
           "ate_m": {"jax": warm_up_ate(jeng, scene), "port": warm_up_ate(teng, scene)},
           "kf_count": {"jax": jeng.kf_count, "port": teng.kf_count},
           "seconds": {"jax": round(jrun["seconds"]), "port": round(trun["seconds"])}}
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
