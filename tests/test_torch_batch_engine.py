"""Both engines in batched and pipelined mode, on the scene of
``tests/test_batch_mode.py`` (48 synthetic frames, batches of 4).

The port takes every random draw from the reference engine's own
``jax.random`` key stream (``ReferenceStream``: the two-view minimal sets,
the vocabulary's initial words, the PnP minimal sets, in the order the
reference splits its key), so both engines start from the same hypotheses
and the same codebook.

Gates:
* ``track_batch``: a record per frame in both, the same state on every
  frame, the same keyframes, and camera positions within 2e-4 m of each
  other (synthetic observations; the engines differ by f32 rounding alone);
* frames 24-27 blank: both engines end OK with the same number of LOST
  records, in the same frames.

The pipelined per-frame entry is in ``test_torch_async_engine.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch import init2view as ti
from dialog_tpu_torch import interop
from dialog_tpu_torch import pnp as tpnp
from dialog_tpu_torch import vocab as tvocab
from dialog_tpu_torch.config import EngineConfig as TConfig
from dialog_tpu_torch.containers import FrameArrays
from dialog_tpu_torch.system import LOST, OK, Engine as TEngine

torch.set_num_threads(2)

# test_batch_mode's configuration with a local map and a codebook sized for the CPU
CFG = dict(max_features=512, max_keyframes=64, max_landmarks=8192, max_local_lms=768,
           max_frames_between_kf=8, vocab_words=128)
N, B = 48, 4
POS_TOL = 2e-4


class ReferenceStream:
    """The port's random draws, taken from the reference engine's key stream
    (``PRNGKey(n_features)``) in the reference's order: one split per
    initialization attempt and per PnP call; per vocabulary (re)train one
    split, and a second one whose subkey draws a fresh codebook's words."""

    def __init__(self, n_features: int = 1000):
        self.key = jax.random.PRNGKey(n_features)
        self._drew_init = False
        self._train = tvocab.train_vocab

    def _split(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def minimal_sets(self, valid, iters, generator=None):
        key_f, key_h = jax.random.split(self._split())
        n_valid = max(int(valid.sum()), 1)
        return (torch.from_numpy(np.array(jax.random.randint(key_f, (iters, 8), 0, n_valid))),
                torch.from_numpy(np.array(jax.random.randint(key_h, (iters, 4), 0, n_valid))))

    def init_words(self, desc, valid, n_words, generator=None):
        self._split()                     # the trainer's own key, unused with init_words
        p = jnp.asarray(valid.numpy(), jnp.float32)
        idx = jax.random.choice(self._split(), desc.shape[0], (n_words,), replace=True,
                                p=p / jnp.maximum(jnp.sum(p), 1.0))
        self._drew_init = True
        return desc[torch.from_numpy(np.array(idx))]

    def train_vocab(self, *args, **kwargs):
        if not self._drew_init:
            self._split()                 # a retrain: the trainer's key alone
        self._drew_init = False
        return self._train(*args, **kwargs)

    def pnp_sets(self, valid, iters, generator=None):
        n_valid = max(int(valid.sum()), 1)
        return torch.from_numpy(np.array(jax.random.randint(self._split(), (iters, 6), 0, n_valid)))

    def patch(self, mp):
        mp.setattr(ti, "draw_minimal_sets", self.minimal_sets)
        mp.setattr(tvocab, "draw_init_words", self.init_words)
        mp.setattr(tvocab, "train_vocab", self.train_vocab)
        mp.setattr(tpnp, "draw_pnp_sets", self.pnp_sets)


@pytest.fixture(scope="module")
def frames():
    scene = jsynth.make_scene(seed=51, n_points=700, n_frames=N, cfg=JConfig(**CFG))
    fj = [jsynth.observe(scene, i, noise_px=0.4)[0] for i in range(N)]
    ft = [interop.frame_from_numpy(jax.device_get(f), device="cpu") for f in fj]
    return fj, ft


def _blank(frame, lib):
    return frame._replace(valid=lib.zeros_like(frame.valid))


def _run_batches(frames, occlude):
    fj, ft = frames
    hidden = range(24, 28) if occlude else ()
    jeng = JEngine(JConfig(**CFG))
    jeng.loop_closing_enabled = False
    teng = TEngine(TConfig(**CFG), device="cpu")
    teng.loop_closing_enabled = False
    with pytest.MonkeyPatch.context() as mp:
        ReferenceStream().patch(mp)
        for i in range(0, N, B):
            ts = [j / 30.0 for j in range(i, i + B)]
            bj = [_blank(fj[j], jnp) if j in hidden else fj[j] for j in range(i, i + B)]
            bt = [_blank(ft[j], torch) if j in hidden else ft[j] for j in range(i, i + B)]
            jeng.track_batch(jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *bj), ts)
            teng.track_batch(FrameArrays(*[torch.stack(x) for x in zip(*bt)]), ts)
        jeng.flush()
        teng.flush()
    return jeng, teng


@pytest.fixture(scope="module")
def batched(frames):
    return _run_batches(frames, occlude=False)


@pytest.fixture(scope="module")
def occluded(frames):
    return _run_batches(frames, occlude=True)


def _kf_frames(eng):
    valid = np.asarray(eng.m.kfs.valid)
    return sorted(np.asarray(eng.m.kfs.frame_id)[valid].tolist())


def _positions(eng):
    return np.stack([-R.T @ t for R, t in eng.final_poses()])


def test_track_batch_states_follow_the_reference(batched):
    jeng, teng = batched
    assert len(teng.trajectory) == len(jeng.trajectory) == N
    assert [r.frame_id for r in teng.trajectory] == list(range(N))
    assert [r.state for r in teng.trajectory] == [r.state for r in jeng.trajectory]
    assert teng.state == OK and not teng._pending_b and teng._dev_state is None
    # f32 rounding moves an observation across the chi2 gate now and then
    assert max(abs(a.n_tracked - b.n_tracked) for a, b in zip(teng.trajectory, jeng.trajectory)) <= 2


def test_track_batch_keyframes_follow_the_reference(batched):
    jeng, teng = batched
    assert teng.kf_count == jeng.kf_count >= 5
    assert _kf_frames(teng) == _kf_frames(jeng)
    assert [r.ref_kf for r in teng.trajectory] == [r.ref_kf for r in jeng.trajectory]
    # one keyframe per batch at most, each from a batch's last frame
    late = [f for f in _kf_frames(teng) if f >= B]
    assert late and all(f % B == B - 1 for f in late) and len(set(f // B for f in late)) == len(late)


def test_track_batch_positions_follow_the_reference(batched):
    jeng, teng = batched
    ok = np.array([r.state == OK for r in teng.trajectory])
    gap = np.abs(_positions(jeng) - _positions(teng))[ok]
    assert float(gap.max()) < POS_TOL, float(gap.max())


def test_track_batch_trains_the_reference_codebook(batched):
    jeng, teng = batched
    assert teng._vocab is not None and teng._vocab_trained_kfs == jeng._vocab_trained_kfs
    np.testing.assert_array_equal(teng._vocab.words.numpy().view(np.uint32), np.asarray(jeng._vocab.words))
    np.testing.assert_allclose(teng._vocab.idf.numpy(), np.asarray(jeng._vocab.idf), atol=1e-6)
    np.testing.assert_allclose(teng._bow_db.numpy(), np.asarray(jeng._bow_db), atol=1e-6)


def test_occlusion_is_lost_and_recovered_as_in_the_reference(occluded):
    jeng, teng = occluded
    sj = [r.state for r in jeng.trajectory]
    st = [r.state for r in teng.trajectory]
    assert len(st) == len(sj) == N and [r.frame_id for r in teng.trajectory] == list(range(N))
    assert st[-1] == OK and sj[-1] == OK and teng.state == OK
    assert st.count(LOST) == sj.count(LOST) >= 4
    assert st == sj
    assert all(s == LOST for s in st[24:28])


def test_occlusion_recovers_by_relocalization_like_the_reference(occluded):
    jeng, teng = occluded
    # the first frame after the gap is tied to the keyframe relocalization picked
    first_ok = [r.state for r in teng.trajectory].index(OK, 28)
    assert teng.trajectory[first_ok].ref_kf == jeng.trajectory[first_ok].ref_kf
    assert teng.trajectory[first_ok].n_tracked >= teng.cfg.reloc_min_inliers
    ok = np.array([r.state == OK for r in teng.trajectory])
    gap = np.abs(_positions(jeng) - _positions(teng))[ok]
    # the recovered pose goes through EPnP, whose f32 eigenvectors differ between the packages
    assert float(gap.max()) < 5e-3, float(gap.max())
