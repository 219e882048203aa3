"""How much room the bench's mono relocalization has, in both engines (ROADMAP D22).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/reloc_margin.py [--kf-interval 10]

Runs ``tum_mono_kf10`` (bench.py's primary workload: ``make_scene(seed=3,
n_points=2500, n_frames=264)``, 640x480, 1,000 features) on the CPU through
its warm-up up to and including the half-blanked batch at frame 48: 8 frames
one by one, batches of 8 from frame 8, frames 48-51 blanked, so the engine
goes LOST and re-tracks frames 48-55 one by one, relocalizing on the way. It
does so three times: the JAX engine; the port's engine (``device="cpu"``)
with its own draws; and the port's engine again with the JAX engine's
vocabulary (its words and idf, ``interop.vocab_from_numpy``, and the BoW rows
rebuilt under it) put in place just before its first relocalization, so that
the vocabulary's draws (D3) can be told apart from the code.

For each relocalization attempt it prints the frame, the BoW candidates tried
(keyframe slot, score, shared words), and per candidate: the descriptor
matches against 15, whether PnP RANSAC succeeds, its inliers against its
threshold (15), the inliers of the same PnP problem solved again with the
draws of seeds 0-15 (the engine's own RNG stream: ``jax.random.PRNGKey``,
``draw_pnp_sets`` on a ``torch.Generator``), in the JAX run the port's PnP
RANSAC on the JAX engine's own matches with the same 16 seeds, and the
inliers after the pose refinement against ``reloc_min_inliers`` (25). The last line is a JSON
object. CPU readings.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import dialog_tpu.pnp as jpnp
import dialog_tpu.system as jsystem
import dialog_tpu.tracking as jtracking
import dialog_tpu_torch.pnp as tpnp
import dialog_tpu_torch.system as tsystem
import dialog_tpu_torch.tracking as ttracking
from dialog_tpu_torch import interop, vocab as tvocab
from dialog_tpu_torch.config import EngineConfig as TConfig

from reference_ate import _warm_loop_paths, reference_config

PNP_MIN_INLIERS = 15     # solve_pnp_ransac's default in both packages
MIN_MATCHES = 15         # _try_relocalize's match gate in both packages
WARM_END = 56            # the warm-up cut after the blanked batch at 48 and its re-tracking
OCCLUDE_AT = 48
B = 8
FPS = 30.0
REDRAWS = 16             # PnP RANSAC solved again on the same matches with draws from seeds 0..15


def mono_config(kf_interval: int) -> TConfig:
    """bench.py's TUM mono configuration (``bench.py:260-266``)."""
    return TConfig(width=640, height=480, n_features=1000, max_features=1024, max_keyframes=256,
                   max_landmarks=16384, max_local_lms=2048, max_local_kfs=16, max_fixed_kfs=16, max_obs_per_lm=8,
                   local_ba_iters=5, max_frames_between_kf=30)


class Recorder:
    """Patches the three steps of ``_try_relocalize`` in one package's
    modules and records what each returns while a relocalization runs."""

    def __init__(self, eng, match_mod, pnp_mod, system_mod, to_int, redraw, cross=None):
        self.attempts, self.active, self.to_int = [], False, to_int
        orig_reloc = eng._try_relocalize
        orig_match, orig_pnp, orig_pose = match_mod.match_reference_kf, pnp_mod.solve_pnp_ransac, \
            system_mod.pose_optimization

        def reloc(frame, ts):
            self.attempts.append({"frame": int(eng.frame_id), "candidates": []})
            self.active = True
            try:
                rec = orig_reloc(frame, ts)
            finally:
                self.active = False
            self.attempts[-1]["relocalized"] = rec is not None
            return rec

        def match(m, cand, frame, cfg):
            out = orig_match(m, cand, frame, cfg)
            if self.active:
                self.attempts[-1]["candidates"].append({"kf": self.to_int(cand), "matches": [self.to_int(out[1]),
                                                                                            MIN_MATCHES]})
            return out

        def pnp(*a, **kw):
            out = orig_pnp(*a, **kw)
            if self.active:
                self.attempts[-1]["candidates"][-1].update(
                    pnp_success=bool(out.success), pnp_inliers=[self.to_int(out.n_inliers), PNP_MIN_INLIERS],
                    pnp_inliers_other_draws=[self.to_int(orig_pnp(*a2, **kw2).n_inliers)
                                             for a2, kw2 in (redraw(a, kw, s) for s in range(REDRAWS))])
                if cross is not None:
                    self.attempts[-1]["candidates"][-1]["port_pnp_inliers_on_these_matches"] = cross(a)
            return out

        def pose(*a, **kw):
            out = orig_pose(*a, **kw)
            if self.active:
                self.attempts[-1]["candidates"][-1]["refined_inliers"] = [self.to_int(out.n_inliers),
                                                                          eng.cfg.reloc_min_inliers]
            return out

        eng._try_relocalize = reloc
        match_mod.match_reference_kf, pnp_mod.solve_pnp_ransac, system_mod.pose_optimization = match, pnp, pose
        self.restore = lambda: (setattr(match_mod, "match_reference_kf", orig_match),
                                setattr(pnp_mod, "solve_pnp_ransac", orig_pnp),
                                setattr(system_mod, "pose_optimization", orig_pose))


def run_jax(kf_interval: int, log) -> tuple[dict, object]:
    from dialog_tpu import vocab as jvocab
    from dialog_tpu.datasets import synth
    from dialog_tpu.frontend import extract_features_batch

    cfg = reference_config(mono_config(kf_interval), vocab=True)
    scene = synth.make_scene(seed=3, n_points=2500, n_frames=264, cfg=cfg)
    images = [jnp.asarray(synth.render_image(scene, i)) for i in range(WARM_END + B)]
    eng = jsystem.Engine(cfg)
    eng.kf_interval = kf_interval
    def redraw(a, kw, seed):
        return (*a[:7], jax.random.PRNGKey(seed)), kw

    def cross(a):
        """The port's PnP RANSAC on the JAX engine's matches, draws of seeds 0..REDRAWS-1."""
        X, uv, ok = (torch.from_numpy(np.array(x)) for x in a[:3])
        return [int(tpnp.solve_pnp_ransac(X, uv, ok, *a[3:7], tpnp.draw_pnp_sets(
            ok, cfg.pnp_ransac_iters, torch.Generator().manual_seed(s))).n_inliers) for s in range(REDRAWS)]

    rec = Recorder(eng, jtracking, jpnp, jsystem, lambda x: int(np.asarray(x)), redraw, cross)
    vocab_at_reloc = []
    inner = eng._try_relocalize

    def reloc(frame, ts):
        if eng._vocab is not None and not vocab_at_reloc:
            vocab_at_reloc.append(jax.device_get(eng._vocab))
        out = inner(frame, ts)
        _bow_detail(rec, eng, frame, jvocab, lambda x: np.asarray(x))
        return out

    eng._try_relocalize = reloc
    try:
        _schedule(eng, images, lambda i, n: extract_features_batch(jnp.stack(images[i:i + n]), cfg),
                  lambda b, lo: b._replace(valid=b.valid.at[:lo].set(False)),
                  lambda b: jax.tree_util.tree_map(lambda x: x[0], b), _warm_loop_paths, log)
    finally:
        rec.restore()
    return {"engine": "jax", "kf_count": eng.kf_count, "state": eng.state, "attempts": rec.attempts}, \
        (vocab_at_reloc[0] if vocab_at_reloc else None)


def run_port(kf_interval: int, log, jax_vocab=None) -> dict:
    from dialog_tpu_torch.bench import warm_loop_paths
    from dialog_tpu_torch.containers import FrameArrays
    from dialog_tpu_torch.datasets import synth
    from dialog_tpu_torch.frontend import extract_features_batch

    cfg = mono_config(kf_interval)
    scene = synth.make_scene(seed=3, n_points=2500, n_frames=264, cfg=cfg)
    images = [torch.from_numpy(synth.render_image(scene, i)) for i in range(WARM_END + B)]
    eng = tsystem.Engine(cfg, device="cpu")
    eng.kf_interval = kf_interval
    def redraw(a, kw, seed):
        return (*a[:7], tpnp.draw_pnp_sets(a[2], cfg.pnp_ransac_iters, torch.Generator().manual_seed(seed))), kw

    rec = Recorder(eng, ttracking, tpnp, tsystem, lambda x: int(x), redraw)
    inner = eng._try_relocalize

    def reloc(frame, ts):
        if jax_vocab is not None and not getattr(eng, "_swapped", False):
            eng._ensure_vocab()
            eng._vocab = interop.vocab_from_numpy(jax_vocab, device="cpu")
            kfs = eng.m.kfs
            eng._bow_db = tvocab.bow_db_rows(eng._vocab, kfs.desc, kfs.feat_valid & kfs.valid[:, None])
            eng._vocab_trained_kfs = eng.kf_count
            eng._swapped = True
        out = inner(frame, ts)
        _bow_detail(rec, eng, frame, tvocab, lambda x: x.numpy())
        return out

    eng._try_relocalize = reloc

    def blank(b, lo):
        valid = b.valid.clone()
        valid[:lo] = False
        return b._replace(valid=valid)

    try:
        _schedule(eng, images, lambda i, n: extract_features_batch(torch.stack(images[i:i + n]), cfg), blank,
                  lambda b: FrameArrays(*[x[0] for x in b]), warm_loop_paths, log)
    finally:
        rec.restore()
    return {"engine": "port" + (" with the JAX vocabulary" if jax_vocab is not None else ""),
            "kf_count": eng.kf_count, "state": eng.state, "attempts": rec.attempts}


def _bow_detail(rec, eng, frame, vocab_mod, to_np) -> None:
    """Adds each tried candidate's BoW score and shared words to the last attempt."""
    if eng._vocab is None or not rec.attempts:
        return
    q = vocab_mod.bow_vector(eng._vocab, frame.desc, frame.valid)
    scores = to_np(vocab_mod.bow_l1_scores(q, eng._bow_db))
    db, qq = to_np(eng._bow_db), to_np(q)
    common = (db > 0).astype(np.float32) @ (qq > 0).astype(np.float32)
    for c in rec.attempts[-1]["candidates"]:
        c.update(score=float(scores[c["kf"]]), shared_words=int(common[c["kf"]]))
    rec.attempts[-1]["most_shared_words"] = int(common[to_np(eng.m.kfs.valid)].max())


def _schedule(eng, images, extract, blank, first, warm_loop, log) -> None:
    """bench.py's warm-up to WARM_END (``bench.py:100-131``): frames one by one, batches, the blanked batch, the
    loop paths warmed, re-tracking to OK."""
    t0 = time.perf_counter()
    for i in range(B):
        eng.track_image(images[i], float(i) / FPS)
    for i in range(B, WARM_END, B):
        batch = extract(i, B)
        if i == OCCLUDE_AT:
            batch = blank(batch, B // 2)
        eng.track_batch(batch, [float(i + j) / FPS for j in range(B)])
        log(f"batch at {i}: kfs={eng.kf_count} state={eng.state} t={time.perf_counter() - t0:.0f}s")
    eng.flush()
    warm_loop(eng)
    while eng.frame_id < WARM_END + 2 * B and eng.state != "OK":
        eng.track_features(first(extract(eng.frame_id, 1)), float(eng.frame_id) / FPS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kf-interval", type=int, default=10, help="10: tum_mono_kf10; 30: tum_mono_kf30")
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    log = lambda msg: print(msg, flush=True)
    runs = []
    jrun, jvocab = run_jax(args.kf_interval, log)
    runs.append(jrun)
    runs.append(run_port(args.kf_interval, log))
    if jvocab is not None:
        runs.append(run_port(args.kf_interval, log, jax_vocab=jvocab))
    for r in runs:
        for a in r["attempts"]:
            log(f"{r['engine']}: frame {a['frame']}: relocalized={a['relocalized']} " + json.dumps(a["candidates"]))
    print(json.dumps({"workload": f"tum_mono_kf{args.kf_interval}", "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
