"""Parity of the port's two-view initialization and keyframe mapping.

Tolerances:
* ``initialize_two_view`` on the reference's own ``jax.random`` minimal sets:
  the same success flag, model choice, good-point mask and count; R and t
  within 1e-4;
* the keyframe pipeline, stage by stage, from a map the JAX engine built on
  synthetic observations: identical integer state (slots, ids, counts,
  covisibility, validity) and float state within 1e-3 (triangulation solves
  3x3 normal equations whose conditioning amplifies f32 op order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dialog_tpu import init2view as ji
from dialog_tpu import mapping as jmap
from dialog_tpu import tracking as jt
from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch import init2view as ti
from dialog_tpu_torch import interop
from dialog_tpu_torch import mapping as tmap
from dialog_tpu_torch.config import EngineConfig as TConfig

torch.set_num_threads(2)

SMALL = dict(max_features=256, max_keyframes=16, max_landmarks=2048, max_local_lms=512,
             max_local_kfs=6, max_fixed_kfs=4, max_obs_per_lm=6, max_frames_between_kf=6,
             vocab_min_kfs=1000)
JCFG = JConfig(**SMALL)
TCFG = TConfig(**SMALL)
FLOAT_TOL = 1e-3


def _t(x):
    x = np.array(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


# A plane at z=5 seen across a 1 m baseline: the homography's 8-motion
# decomposition is then well conditioned in f32. At z=7 with a 0.5 m baseline
# the two SVD backends already part by ~2e-4 in t.
PLANAR = dict(t=(-1.0, 0.1, 0.05), ang=0.1, z=5.0)


def _two_view(planar: bool, seed: int, n=180, t=(-0.5, 0.05, 0.02), ang=0.06, z=7.0):
    rng = np.random.default_rng(seed)
    if planar:
        X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), np.full(n, z)], -1)
    else:
        X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1)
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    t = np.array(t)
    f, c = 500.0, (320.0, 240.0)

    def proj(P):
        return np.stack([f * P[:, 0] / P[:, 2] + c[0], f * P[:, 1] / P[:, 2] + c[1]], -1)

    uv1 = proj(X) + rng.normal(0, 0.5, (n, 2))
    uv2 = proj(X @ R.T + t) + rng.normal(0, 0.5, (n, 2))
    uv2[:15] += rng.uniform(-30, 30, (15, 2))
    valid = rng.random(n) > 0.05
    return uv1.astype(np.float32), uv2.astype(np.float32), valid


@pytest.mark.parametrize("planar,seed", [(False, 0), (False, 2), (True, 0), (True, 1)])
def test_initialize_two_view_on_reference_draws(planar, seed):
    uv1, uv2, valid = _two_view(planar, seed, **(PLANAR if planar else {}))
    key = jax.random.PRNGKey(7 + seed)
    iters = 128
    ref = ji.initialize_two_view(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid),
                                 500.0, 500.0, 320.0, 240.0, key, iters=iters)
    n_valid = max(int(valid.sum()), 1)
    key_f, key_h = jax.random.split(key)
    picks = (torch.from_numpy(np.array(jax.random.randint(key_f, (iters, 8), 0, n_valid))),
             torch.from_numpy(np.array(jax.random.randint(key_h, (iters, 4), 0, n_valid))))
    got = ti.initialize_two_view(_t(uv1), _t(uv2), _t(valid), 500.0, 500.0, 320.0, 240.0, picks, iters=iters)
    assert bool(ref.success) and bool(got.success)
    assert bool(ref.used_h) == bool(got.used_h)
    assert int(ref.n_good) == int(got.n_good)
    np.testing.assert_array_equal(np.asarray(ref.good), got.good.numpy())
    np.testing.assert_allclose(np.asarray(ref.R), got.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref.t), got.t.numpy(), atol=1e-4)


def test_initialize_two_view_own_draws_recovers_motion():
    """The engine's own draws: every minimal set indexes a valid pair, and the
    motion comes back. The winner is one unrefined minimal-set hypothesis (the
    reference's too, which misses by 1.6-9.5 deg on the 0.5 m baseline), so
    the gate is on the median over seeds at the 1 m baseline."""
    t_true = np.array(PLANAR["t"]) / np.linalg.norm(PLANAR["t"])
    errs = []
    for seed in range(3, 8):
        uv1, uv2, valid = _two_view(False, seed, **PLANAR)
        gen = torch.Generator().manual_seed(seed)
        pick_f, pick_h = ti.draw_minimal_sets(_t(valid), 128, gen)
        assert pick_f.shape == (128, 8) and pick_h.shape == (128, 4)
        for p in (pick_f, pick_h):
            assert int(p.min()) >= 0 and int(p.max()) < int(valid.sum())
        got = ti.initialize_two_view(_t(uv1), _t(uv2), _t(valid), 500.0, 500.0, 320.0, 240.0,
                                     iters=128, generator=torch.Generator().manual_seed(seed))
        assert bool(got.success)
        errs.append(np.degrees(np.arccos(np.clip(got.t.numpy() @ t_true, -1, 1))))
    assert np.median(errs) < 3.0 and max(errs) < 8.0, errs


def _assert_maps(mj, mt):
    a = jax.device_get(mj)
    b = interop.map_to_numpy(mt)
    for part in ("kfs", "lms"):
        for name in getattr(a, part)._fields:
            x = np.asarray(getattr(getattr(a, part), name))
            y = b[part][name]
            if np.issubdtype(x.dtype, np.floating):
                fin = np.isfinite(x)
                np.testing.assert_array_equal(fin, np.isfinite(y), err_msg=f"{part}.{name}")
                np.testing.assert_allclose(x[fin], y[fin], atol=FLOAT_TOL, rtol=FLOAT_TOL, err_msg=f"{part}.{name}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{part}.{name}")
    for name in ("covis", "num_kfs", "num_lms", "lm_dropped"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), b[name], err_msg=name)


@pytest.fixture(scope="module")
def kf_inputs():
    """JAX engine after 8 synthetic frames + the tracked 9th frame as a keyframe candidate."""
    scene = jsynth.make_scene(seed=4, n_points=400, n_frames=40, cfg=JCFG)
    eng = JEngine(JCFG)
    eng.loop_closing_enabled = False
    for i in range(8):
        fr, _ = jsynth.observe(scene, i, noise_px=0.4, desc_flips=6)
        eng.track_features(fr, float(i) / 30.0)
    assert eng.state == "OK" and eng.kf_count >= 3
    frame, _ = jsynth.observe(scene, 8, noise_px=0.4, desc_flips=6)
    Rv, tv = eng._vel
    R, t, lm_ids, _, _ = jt.fused_track_step(
        eng.m, eng._last_lm_ids, frame, jnp.asarray(Rv @ eng._last_R), jnp.asarray(Rv @ eng._last_t + tv),
        jnp.asarray(eng._last_R), jnp.asarray(eng._last_t), jnp.int32(eng.ref_kf), JCFG,
    )
    slot = int(np.nonzero(~np.asarray(eng.m.kfs.valid))[0][0])
    return eng.m, frame, R, t, lm_ids, slot, int(eng.ref_kf)


def _both(kf_inputs):
    mj, frame, R, t, lm_ids, slot, parent = kf_inputs
    mt = interop.map_from_numpy(jax.device_get(mj), device="cpu")
    jargs = (frame, R, t, lm_ids, jnp.int32(8), jnp.float32(0.25), jnp.int32(slot), jnp.int32(parent))
    targs = (interop.frame_from_numpy(jax.device_get(frame), device="cpu"), _t(R), _t(t), _t(lm_ids), 8, 0.25, slot, parent)
    return mj, mt, jargs, targs, slot


STAGES = ["insert", "triangulate", "fuse", "refresh_and_cull_landmarks", "cull_keyframes", "process"]


@pytest.mark.parametrize("stage", STAGES)
def test_keyframe_pipeline_stage_matches_reference(kf_inputs, stage):
    mj, mt, jargs, targs, slot = _both(kf_inputs)
    if stage == "process":
        mj = jmap.process_new_keyframe(mj, *jargs, JCFG, n_neighbors=JCFG.kf_tri_neighbors)
        mt = tmap.process_new_keyframe(mt, *targs, TCFG, n_neighbors=TCFG.kf_tri_neighbors)
        _assert_maps(mj, mt)
        return
    mj = jmap.insert_keyframe(mj, *jargs, JCFG)
    mt = tmap.insert_keyframe(mt, *targs, TCFG)
    if stage != "insert":
        w = np.where(np.asarray(mj.kfs.valid), np.asarray(mj.covis[slot]), 0)
        w[slot] = 0
        order = np.argsort(-w, kind="stable")[:2]
        nbs = np.where(w[order] > 0, order, slot).astype(np.int32)
        mj = jmap.triangulate_fanout(mj, jnp.int32(slot), jnp.asarray(nbs), JCFG)
        mt = tmap.triangulate_fanout(mt, slot, torch.from_numpy(nbs.astype(np.int64)), TCFG)
        if stage != "triangulate":
            nb = int(nbs[0])
            mj = jmap.fuse_landmarks_into_kf(mj, jnp.int32(slot), jnp.int32(nb), JCFG)
            mt = tmap.fuse_landmarks_into_kf(mt, slot, nb, TCFG)
            mj = jmap.fuse_landmarks_into_kf(mj, jnp.int32(nb), jnp.int32(slot), JCFG, recount=False)
            mt = tmap.fuse_landmarks_into_kf(mt, nb, slot, TCFG, recount=False)
        if stage == "refresh_and_cull_landmarks":
            mj = jmap.refresh_landmark_geometry(jmap.refresh_landmark_descriptors(mj, jnp.int32(slot), JCFG),
                                                jnp.int32(slot), JCFG)
            mt = tmap.refresh_landmark_geometry(tmap.refresh_landmark_descriptors(mt, slot, TCFG), slot, TCFG)
            mj = jmap.cull_landmarks(mj, jnp.int32(slot), JCFG)
            mt = tmap.cull_landmarks(mt, slot, TCFG)
        if stage == "cull_keyframes":
            mj = jmap.cull_keyframes(mj, jnp.int32(slot), JCFG)
            mt = tmap.cull_keyframes(mt, slot, TCFG)
    _assert_maps(mj, mt)


def test_alloc_landmarks_matches_reference(kf_inputs):
    mj, mt, _, _, _ = _both(kf_inputs)
    rng = np.random.default_rng(5)
    N = 300
    X = rng.normal(size=(N, 3)).astype(np.float32) + np.array([0, 0, 6], np.float32)
    desc = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    octv = rng.integers(0, 8, N).astype(np.int32)
    mask = rng.random(N) > 0.3
    cam = np.array([0.1, -0.2, 0.3], np.float32)
    aj, sj = jmap.alloc_landmarks(mj, jnp.asarray(X), jnp.asarray(desc), jnp.asarray(octv), jnp.asarray(mask),
                                  jnp.int32(1), jnp.asarray(cam), JCFG)
    at, st = tmap.alloc_landmarks(mt, _t(X), _t(desc), _t(octv), _t(mask), 1, _t(cam), TCFG)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    _assert_maps(aj, at)
