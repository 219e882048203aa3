"""Loop-closure recall A/B: flat-2048 vs 16k words vs 16k two-level.

Descriptor noise is set high (56 of 256 bits flipped per observation,
~22%) so the retrieval task is NOT saturated — at the engine's default
noise every configuration scores 100% recall on this orbit.

Quantifies what vocabulary scale buys on the loop-orbit retrieval task, and
that the two-level quantizer (the ORBvoc-scale path,
``vocab.build_two_level``) does not cost recall against the flat argmin at
the same word count (PARITY.md records the reference's numbers).

Protocol: an orbit scene revisits its own trajectory (period frames per
lap). Lap-1 keyframes form the database (and the training corpus, as the
engine's ``_ensure_vocab`` does); every lap-2 keyframe queries it by BoW
l1 score. A query counts as recalled@N if any database keyframe within
``match_radius`` of its true pose ranks in the top N.

The initial words of each codebook are an argument (ROADMAP D3: the
reference draws them with ``jax.random``); by default they come from
``vocab.draw_init_words`` on a ``torch.Generator`` seeded with ``seed``.

Run: ``python -m dialog_tpu_torch.eval.vocab_recall [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import vocab as V
from ..config import EngineConfig
from ..datasets import synth

CFG = EngineConfig(max_features=512, vocab_words=2048)
PERIOD = 200
N_FRAMES = 400
N_POINTS = 8000
KF_EVERY = 5
MATCH_RADIUS_FRAC = 0.05     # of the orbit span
WORDS = (2048, 16384)        # flat codebook sizes; the largest is also run two-level
N_COARSE = 128


def _kf_sets(scene, idxs, device, noise_px=1.0, desc_flips=56):
    descs, valids, centers = [], [], []
    for i in idxs:
        fr, _ = synth.observe(scene, i, noise_px=noise_px, desc_flips=desc_flips, device=device)
        descs.append(fr.desc)
        valids.append(fr.valid)
        centers.append(-scene.R[i].T @ scene.t[i])
    return torch.stack(descs), torch.stack(valids), np.stack(centers)


def run(seed: int = 7, init_words: dict | None = None, words=WORDS, period: int = PERIOD,
        n_frames: int = N_FRAMES, device="cuda") -> dict:
    """Recall@1 and @5 of each codebook. ``init_words`` maps a word count W
    to its initial words i32[W, 8]; a W it does not hold is drawn."""
    scene = synth.make_scene(seed=seed, n_points=N_POINTS, n_frames=n_frames, trajectory="loop", cfg=CFG,
                             period=period)
    lap1 = list(range(0, period, KF_EVERY))
    lap2 = list(range(period, n_frames, KF_EVERY))
    d1, v1, c1 = _kf_sets(scene, lap1, device)
    d2, v2, c2 = _kf_sets(scene, lap2, device)
    span = float(np.linalg.norm(c1.max(0) - c1.min(0)))
    radius = MATCH_RADIUS_FRAC * span

    # training corpus = lap-1 keyframe descriptors (what the engine trains on)
    K1, F = d1.shape[:2]
    corpus = d1.reshape(K1 * F, 8)
    corpus_ok = v1.reshape(K1 * F)

    def recall_for(voc, name):
        db = V.bow_db_rows(voc, d1, v1)
        hits1 = hits5 = n = 0
        for qi in range(len(lap2)):
            true = np.linalg.norm(c1 - c2[qi], axis=1) < radius
            if not true.any():
                continue
            n += 1
            q = V.bow_vector(voc, d2[qi], v2[qi])
            s = V.bow_l1_scores(q, db).cpu().numpy()
            order = np.argsort(-s)
            hits1 += bool(true[order[0]])
            hits5 += bool(true[order[:5]].any())
        return {
            "name": name,
            "recall@1": round(hits1 / n, 3) if n else None,
            "recall@5": round(hits5 / n, 3) if n else None,
            "n_queries": n,
        }

    results = []
    for W in words:
        init = (init_words or {}).get(W)
        if init is None:
            gen = torch.Generator(device=corpus.device).manual_seed(seed)
            init = V.draw_init_words(corpus, corpus_ok, W, gen)
        voc = V.train_vocab(corpus, corpus_ok, init.to(corpus.device), n_words=W, iters=6)
        wid = V.quantize(voc, corpus, corpus_ok)
        doc = torch.arange(K1, dtype=torch.int32, device=corpus.device).repeat_interleave(F)
        voc = V.compute_idf(voc, wid, doc, K1)
        results.append(recall_for(voc, f"flat-{W}"))
        if W == max(words):
            hv = V.build_two_level(voc, n_coarse=N_COARSE)
            results.append(recall_for(hv, f"two-level-{W}(C0={N_COARSE})"))
    return {"span": round(span, 2), "radius": round(radius, 3), "results": results}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(device=args.device), indent=2))


if __name__ == "__main__":
    main()
