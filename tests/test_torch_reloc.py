"""Relocalization in the port's engine against the reference's.

The JAX engine tracks 24 synthetic frames and trains its vocabulary on the
way. Its map, codebook (``interop.vocab_from_numpy``), BoW rows and
bookkeeping are carried into a port engine; both are then set LOST and asked
to relocalize the same frames, the port drawing the reference's own PnP
minimal sets (the same ``pick``).

Gates: the same outcome (recovered or not); where recovered, the same
candidate keyframe, the same associations but for a few at the chi2 gate,
and a pose within 1e-3 of the reference's in R and t (the refinement after
PnP brings the two packages' slightly different EPnP hypotheses to one
optimum). The BoW vector and scores behind the candidate choice agree
within 1e-6. ``_ensure_vocab`` and ``_update_bow_row`` reproduce the carried
rows from the carried codebook.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dialog_tpu import vocab as jvocab
from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch import interop
from dialog_tpu_torch import pnp as tpnp
from dialog_tpu_torch import vocab as tvocab
from dialog_tpu_torch.config import EngineConfig as TConfig
from dialog_tpu_torch.system import LOST, OK, Engine as TEngine

torch.set_num_threads(2)

CFG = dict(max_features=256, max_keyframes=16, max_landmarks=2048, max_local_lms=512,
           max_local_kfs=6, max_fixed_kfs=4, max_obs_per_lm=6, max_frames_between_kf=4,
           vocab_min_kfs=3, vocab_words=64, pnp_ransac_iters=64)
N = 24
TOL = 1e-3


@pytest.fixture(scope="module")
def engines():
    scene = jsynth.make_scene(seed=4, n_points=400, n_frames=40, cfg=JConfig(**CFG))
    jeng = JEngine(JConfig(**CFG))
    jeng.loop_closing_enabled = False
    for i in range(N):
        jeng.track_features(jsynth.observe(scene, i, noise_px=0.4, desc_flips=6)[0], float(i) / 30.0)
    assert jeng.state == OK and jeng._vocab is not None and jeng.kf_count >= 6
    teng = TEngine(TConfig(**CFG), device="cpu")
    teng.loop_closing_enabled = False
    teng.m = interop.map_from_numpy(jax.device_get(jeng.m), device="cpu")
    teng._vocab = interop.vocab_from_numpy(jax.device_get(jeng._vocab), device="cpu")
    teng._bow_db = torch.from_numpy(np.array(jeng._bow_db))
    teng._vocab_trained_kfs = jeng._vocab_trained_kfs
    teng.kf_count, teng.ref_kf, teng.frame_id = jeng.kf_count, jeng.ref_kf, jeng.frame_id
    teng._last_R, teng._last_t = np.array(jeng._last_R), np.array(jeng._last_t)
    teng._kf_valid_host = np.array(jeng.m.kfs.valid)
    return scene, jeng, teng


def _relocalize_both(engines, frame_j):
    """Both engines LOST, then ``_try_relocalize`` of the same frame with the same draws."""
    _, jeng, teng = engines
    frame_t = interop.frame_from_numpy(jax.device_get(frame_j), device="cpu")
    for eng in (jeng, teng):
        eng.state, eng._vel = LOST, None
    key = jeng._key
    rec_j = jeng._try_relocalize(frame_j, 1.0)

    def draws(valid, iters, generator=None):
        sub = jax.random.split(key)[1]
        return torch.from_numpy(np.array(jax.random.randint(sub, (iters, 6), 0, max(int(valid.sum()), 1))))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpnp, "draw_pnp_sets", draws)
        rec_t = teng._try_relocalize(frame_t, 1.0)
    return rec_j, rec_t


@pytest.mark.parametrize("frame_id", [5, 13, 22])
def test_relocalization_picks_the_reference_candidate_and_pose(engines, frame_id):
    scene, jeng, teng = engines
    # a fresh view of a frame the engine has passed: other pixel noise, other flipped bits
    frame_j = jsynth.observe(scene, frame_id, noise_px=0.4, desc_flips=6, seed=1000 + frame_id)[0]
    rec_j, rec_t = _relocalize_both(engines, frame_j)
    assert rec_j is not None and rec_t is not None
    assert rec_t.state == OK and teng.state == OK and teng._vel is None
    assert rec_t.ref_kf == rec_j.ref_kf == teng.ref_kf
    assert abs(rec_t.n_tracked - rec_j.n_tracked) <= 2 and rec_t.n_tracked >= teng.cfg.reloc_min_inliers
    np.testing.assert_allclose(rec_t.R, np.asarray(rec_j.R), atol=TOL, rtol=0)
    np.testing.assert_allclose(rec_t.t, np.asarray(rec_j.t), atol=TOL, rtol=0)
    np.testing.assert_allclose(rec_t.R_rel, np.asarray(rec_j.R_rel), atol=TOL, rtol=0)
    differ = int((teng._last_lm_ids.numpy() != np.asarray(jeng._last_lm_ids)).sum())
    assert differ <= 2, differ
    # and the pose is the one the engine tracked that frame at (map units: median depth 1)
    R_trk, t_trk = jeng.final_poses()[frame_id]
    gap = np.abs(-rec_t.R.T @ rec_t.t - (-np.asarray(R_trk).T @ np.asarray(t_trk))).max()
    assert gap < 0.05, gap
    assert teng._last_frame is not None


def test_relocalization_fails_alike_on_a_blank_frame(engines):
    scene, jeng, teng = engines
    frame_j = jsynth.observe(scene, 9, noise_px=0.4, desc_flips=6)[0]
    frame_j = frame_j._replace(valid=jnp.zeros_like(frame_j.valid))
    rec_j, rec_t = _relocalize_both(engines, frame_j)
    assert rec_j is None and rec_t is None
    assert teng.state == LOST


def test_bow_scores_behind_the_candidates_match(engines):
    scene, jeng, teng = engines
    frame_j = jsynth.observe(scene, 13, noise_px=0.4, desc_flips=6, seed=77)[0]
    frame_t = interop.frame_from_numpy(jax.device_get(frame_j), device="cpu")
    q_j = jvocab.bow_vector(jeng._vocab, frame_j.desc, frame_j.valid)
    q_t = tvocab.bow_vector(teng._vocab, frame_t.desc, frame_t.valid)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-6, rtol=0)
    s_j = np.asarray(jvocab.bow_l1_scores(q_j, jeng._bow_db))
    s_t = tvocab.bow_l1_scores(q_t, teng._bow_db).numpy()
    np.testing.assert_allclose(s_t, s_j, atol=1e-6, rtol=0)
    valid = np.asarray(jeng.m.kfs.valid)
    assert int(np.argmax(np.where(valid, s_t, -1))) == int(np.argmax(np.where(valid, s_j, -1)))


def test_bow_rows_are_rebuilt_from_the_carried_codebook(engines):
    _, jeng, teng = engines
    kfs = teng.m.kfs
    rows = tvocab.bow_db_rows(teng._vocab, kfs.desc, kfs.feat_valid & kfs.valid[:, None])
    live = np.asarray(jeng.m.kfs.valid)
    np.testing.assert_allclose(rows.numpy()[live], np.asarray(jeng._bow_db)[live], atol=1e-6, rtol=0)
    before = teng._bow_db.clone()
    slot = int(np.nonzero(live)[0][-1])
    teng._bow_db[slot] = 0.0
    teng._update_bow_row(slot)
    np.testing.assert_allclose(teng._bow_db.numpy(), before.numpy(), atol=1e-6, rtol=0)


def test_ensure_vocab_trains_at_min_kfs_and_retrains_on_doubling(engines):
    _, _, carried = engines
    eng = TEngine(TConfig(**CFG), device="cpu")
    eng.m = carried.m
    eng.kf_count = CFG["vocab_min_kfs"] - 1
    eng._ensure_vocab()
    assert eng._vocab is None and eng._bow_db is None
    eng._update_bow_row(0)                      # no codebook yet: nothing to update
    eng.kf_count = 4
    eng._ensure_vocab()
    first = eng._vocab
    assert first is not None and eng._vocab_trained_kfs == 4
    assert first.words.shape == (64, 8) and first.coarse is None
    assert eng._bow_db.shape == (16, 64) and float(eng._bow_db.sum()) > 0
    eng.kf_count = 7
    eng._ensure_vocab()
    assert eng._vocab is first                  # not doubled yet
    eng.kf_count = 8
    eng._ensure_vocab()
    assert eng._vocab is not first and eng._vocab_trained_kfs == 8
    live = eng.m.kfs.valid.numpy()
    # l1-normalized rows (a keyframe whose words all occur in nearly every keyframe has idf 0 throughout)
    sums = eng._bow_db.numpy()[live].sum(1)
    assert (np.isclose(sums, 1.0, atol=1e-5) | (sums == 0.0)).all() and (sums > 0).sum() >= 3
