"""Parity of the port's LM helpers, pose optimization and tracking step.

The tracking inputs (map, last associations, next frame) come from the JAX
engine run on synthetic observations and are carried across with
``dialog_tpu_torch.interop``. Tolerances:
* LM helpers: 1e-5 relative (closed-form f32);
* pose optimization and the ``__graft_entry__.entry()`` step at a small
  config: same inlier set and count, R and t within 1e-4;
* ``fused_track_step``: identical landmark associations and counters, pose
  within 1e-4 (the reference's CPU path and the port's fused matcher give
  the same matches).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from dialog_tpu import frontend as jfe
from dialog_tpu import geometry as jg
from dialog_tpu import tracking as jt
from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.optim import lm as jlm
from dialog_tpu.optim import pose_only as jpose
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch import frontend as tfe
from dialog_tpu_torch import geometry as tg
from dialog_tpu_torch import interop
from dialog_tpu_torch import matching as tm
from dialog_tpu_torch import tracking as tt
from dialog_tpu_torch.config import EngineConfig as TConfig
from dialog_tpu_torch.optim import lm as tlm
from dialog_tpu_torch.optim import pose_only as tpose

torch.set_num_threads(2)

SMALL = dict(max_features=256, max_keyframes=16, max_landmarks=2048, max_local_lms=512,
             max_local_kfs=6, max_fixed_kfs=4, max_obs_per_lm=6, max_frames_between_kf=6,
             vocab_min_kfs=1000)
JCFG = JConfig(**SMALL)
TCFG = TConfig(**SMALL)


def _t(x):
    x = np.array(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def test_lm_helpers():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    spd = (A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)).astype(np.float32)
    Lj = jlm.chol3x3(jnp.asarray(spd))
    Lt = tlm.chol3x3(torch.from_numpy(spd))
    np.testing.assert_allclose(np.asarray(Lj), Lt.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jlm.tri_inv3x3_lower(Lj)), tlm.tri_inv3x3_lower(Lt).numpy(),
                               rtol=1e-5, atol=1e-5)
    chi2 = rng.uniform(0, 20, 100).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jlm.huber_weight(jnp.asarray(chi2), 5.991)),
                               tlm.huber_weight(torch.from_numpy(chi2), 5.991).numpy(), rtol=1e-6)
    H = (A[0] @ A[0].T + np.eye(3)).astype(np.float32)
    g = rng.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jlm.solve_damped(jnp.asarray(H), jnp.asarray(g), 1e-2)),
                               tlm.solve_damped(torch.from_numpy(H), torch.from_numpy(g), 1e-2).numpy(),
                               rtol=1e-4, atol=1e-6)
    assert bool(tlm.all_finite(torch.ones(3), torch.zeros(2)))
    assert not bool(tlm.all_finite(torch.tensor([1.0, float("nan")])))


def _pose_problem(seed, n=200, outliers=30):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1).astype(np.float32)
    R, t = jg.se3_exp(jnp.asarray((rng.normal(size=6) * 0.05).astype(np.float32)))
    R, t = np.array(R), np.array(t)
    Xc = X @ R.T + t
    uv = np.stack([500 * Xc[:, 0] / Xc[:, 2] + 320, 500 * Xc[:, 1] / Xc[:, 2] + 240], -1)
    uv = (uv + rng.normal(0, 0.7, uv.shape)).astype(np.float32)
    uv[:outliers] += rng.uniform(-40, 40, (outliers, 2)).astype(np.float32)
    inv_s2 = (1.2 ** (-2.0 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.random(n) > 0.05
    R0, t0 = jg.se3_retract(jnp.asarray(R), jnp.asarray(t),
                            jnp.asarray((rng.normal(size=6) * 0.02).astype(np.float32)))
    return X, uv, inv_s2, valid, np.array(R0), np.array(t0)


@pytest.mark.parametrize("seed,rounds", [(0, 4), (1, 2)])
def test_pose_optimization_matches_reference(seed, rounds):
    X, uv, inv_s2, valid, R0, t0 = _pose_problem(seed)
    ref = jpose.pose_optimization(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X), jnp.asarray(uv),
                                  jnp.asarray(inv_s2), jnp.asarray(valid), 500.0, 500.0, 320.0, 240.0,
                                  rounds=rounds, iters=10)
    got = tpose.pose_optimization(_t(R0), _t(t0), _t(X), _t(uv), _t(inv_s2), _t(valid),
                                  500.0, 500.0, 320.0, 240.0, rounds=rounds, iters=10)
    np.testing.assert_array_equal(np.asarray(ref.inlier), got.inlier.numpy())
    assert int(ref.n_inliers) == int(got.n_inliers)
    np.testing.assert_allclose(np.asarray(ref.R), got.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref.t), got.t.numpy(), atol=1e-4)


def test_graft_entry_step_matches_reference(monkeypatch):
    """The reference's fused forward step (extract -> project -> match -> pose)
    from ``__graft_entry__.entry()`` at its small config, against the same
    chain in the port, on a rendered frame whose landmarks are its features."""
    small = graft._cfg(small=True)
    monkeypatch.setattr(graft, "_cfg", lambda small_=False: small)
    step, _ = graft.entry()
    cfg_t = TConfig(**{f: getattr(small, f) for f in small.__dataclass_fields__ if f != "sensor"})
    scene = jsynth.make_scene(seed=1, n_points=300, n_frames=8, cfg=small)
    img = jsynth.render_image(scene, 0, patch_r=3)
    fr = jax.device_get(jfe.extract_features(jnp.asarray(img), small))
    rng = np.random.default_rng(2)
    n = int(fr.valid.sum())
    depth = rng.uniform(4, 8, small.max_features).astype(np.float32)
    Xc = np.array(jg.backproject(jnp.asarray(fr.uv), jnp.asarray(depth), small.fx, small.fy, small.cx, small.cy))
    Xc[n:] = Xc[0]
    desc = np.array(fr.desc)
    R0, t0 = jg.se3_exp(jnp.asarray(np.array([0.02, -0.01, 0.03, 0.004, -0.003, 0.002], np.float32)))
    R0, t0 = np.array(R0), np.array(t0)

    Rj, tj, nj = step(jnp.asarray(img), jnp.asarray(Xc), jnp.asarray(desc), jnp.asarray(R0), jnp.asarray(t0))

    frame = tfe.extract_features(torch.from_numpy(img), cfg_t)
    lm_xyz, R0t, t0t = _t(Xc), _t(R0), _t(t0)
    uv_pred, z = tg.project(R0t, t0t, lm_xyz, cfg_t.fx, cfg_t.fy, cfg_t.cx, cfg_t.cy)
    vis = (z > 1e-3) & (uv_pred[:, 0] >= 0) & (uv_pred[:, 0] < cfg_t.width) \
        & (uv_pred[:, 1] >= 0) & (uv_pred[:, 1] < cfg_t.height)
    match_ft, _ = tm.match_projected(_t(desc), uv_pred, vis, torch.zeros(lm_xyz.shape[0], dtype=torch.int32),
                                     frame.desc, frame.uv, frame.valid, frame.octave, radius=15.0,
                                     scale_factor=cfg_t.scale_factor, max_dist=cfg_t.th_high, ratio=0.9)
    ft = torch.clamp(match_ft, 0, cfg_t.max_features - 1).long()
    res = tpose.pose_optimization(R0t, t0t, lm_xyz, frame.uv[ft], torch.ones(lm_xyz.shape[0]), match_ft >= 0,
                                  cfg_t.fx, cfg_t.fy, cfg_t.cx, cfg_t.cy)
    assert int(nj) > 10
    assert int(nj) == int(res.n_inliers)
    np.testing.assert_allclose(np.asarray(Rj), res.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(tj), res.t.numpy(), atol=1e-4)


@pytest.fixture(scope="module")
def tracked():
    """JAX engine state after 10 synthetic frames, plus the 11th frame."""
    scene = jsynth.make_scene(seed=4, n_points=400, n_frames=40, cfg=JCFG)
    eng = JEngine(JCFG)
    eng.loop_closing_enabled = False
    for i in range(10):
        fr, _ = jsynth.observe(scene, i, noise_px=0.4, desc_flips=6)
        eng.track_features(fr, float(i) / 30.0)
    assert eng.state == "OK" and eng.kf_count >= 3
    frame, _ = jsynth.observe(scene, 10, noise_px=0.4, desc_flips=6)
    Rv, tv = eng._vel
    R_pred, t_pred = Rv @ eng._last_R, Rv @ eng._last_t + tv
    args_j = (eng.m, eng._last_lm_ids, frame, jnp.asarray(R_pred), jnp.asarray(t_pred),
              jnp.asarray(eng._last_R), jnp.asarray(eng._last_t), jnp.int32(eng.ref_kf))
    args_t = (interop.map_from_numpy(jax.device_get(eng.m), device="cpu"), _t(eng._last_lm_ids),
              interop.frame_from_numpy(jax.device_get(frame), device="cpu"), _t(R_pred), _t(t_pred),
              _t(eng._last_R), _t(eng._last_t), int(eng.ref_kf))
    return args_j, args_t


def test_fused_track_step_matches_reference(tracked):
    args_j, args_t = tracked
    Rj, tj, lmj, pj, (vj, fj) = jt.fused_track_step(*args_j, JCFG)
    Rt, tt_, lmt, pt, (vt, ft) = tt.fused_track_step(*args_t, TCFG)
    np.testing.assert_array_equal(np.asarray(lmj), lmt.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), atol=1e-4)
    assert int(np.asarray(pj)[24]) > 50


def test_tracking_helpers_match_reference(tracked):
    (mj, lastj, frj, Rpj, tpj, _, _, refj), (mt, lastt, frt, Rpt, tpt, _, _, reft) = tracked
    for frustum in (False, True):
        ids_j = jnp.where(lastj >= 0, lastj, JCFG.max_landmarks)
        a = jt._project_landmarks(mj, ids_j, Rpj, tpj, JCFG, frustum=frustum)
        b = tt._project_landmarks(mt, torch.where(lastt >= 0, lastt, TCFG.max_landmarks), Rpt, tpt, TCFG,
                                  frustum=frustum)
        for k, (x, y) in enumerate(zip(a, b)):
            if k == 2:
                np.testing.assert_allclose(np.asarray(x), y.numpy(), atol=1e-3)
            else:
                np.testing.assert_array_equal(np.asarray(x).view(np.int32) if k == 1 else np.asarray(x), y.numpy())
    for x, y in zip(jt._motion_match(mj, lastj, frj, Rpj, tpj, JCFG, 15.0),
                    tt._motion_match(mt, lastt, frt, Rpt, tpt, TCFG, 15.0)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    for x, y in zip(jt._ref_kf_match(mj, refj, frj, JCFG), tt._ref_kf_match(mt, reft, frt, TCFG)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    lj = jt.local_landmark_ids(mj, refj, JCFG)
    lt = tt.local_landmark_ids(mt, reft, TCFG)
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    lm0_j, _ = jt._motion_match(mj, lastj, frj, Rpj, tpj, JCFG, 15.0)
    lm0_t, _ = tt._motion_match(mt, lastt, frt, Rpt, tpt, TCFG, 15.0)
    for x, y in zip(jt.track_local_map_match(mj, lj, frj, lm0_j, Rpj, tpj, JCFG),
                    tt.track_local_map_match(mt, lt, frt, lm0_t, Rpt, tpt, TCFG)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    for x, y in zip(jt.filter_outlier_assoc(Rpj, tpj, mj, frj, lm0_j, JCFG),
                    tt.filter_outlier_assoc(Rpt, tpt, mt, frt, lm0_t, TCFG)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    counts_t = (torch.ones_like(mt.lms.n_visible), torch.zeros_like(mt.lms.n_found))
    got = tt.apply_track_counts(mt, counts_t)
    np.testing.assert_array_equal(got.lms.n_visible.numpy(), np.asarray(mj.lms.n_visible) + 1)


def test_track_motion_model_matches_reference(tracked):
    """The public projection search (TrackWithMotionModel), default radius 15
    and a wider one: equal associations and count; TrackOut carries a pose."""
    (mj, lastj, frj, Rpj, tpj, _, _, _), (mt, lastt, frt, Rpt, tpt, _, _, _) = tracked
    for kw in ({}, {"radius": 30.0}):
        lj, nj = jt.track_motion_model(mj, lastj, frj, Rpj, tpj, JCFG, **kw)
        lt, nt = tt.track_motion_model(mt, lastt, frt, Rpt, tpt, TCFG, **kw)
        np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
        assert int(nj) == int(nt) > 50
    out = tt.TrackOut(Rpt, tpt)
    assert out._fields == jt.TrackOut._fields and out.R is Rpt and out.t is tpt


def test_inv3x3_matches_reference():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(256, 3, 3)).astype(np.float32)
    A = (A @ A.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)).astype(np.float32)   # well conditioned
    got = tlm.inv3x3(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlm.inv3x3(jnp.asarray(A))), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got @ A, np.broadcast_to(np.eye(3), A.shape), atol=1e-4)
    z = np.zeros((2, 3, 3), np.float32)   # a singular batch: the determinant guard, as the reference's
    np.testing.assert_array_equal(tlm.inv3x3(torch.from_numpy(z)).numpy(), np.asarray(jlm.inv3x3(jnp.asarray(z))))


def test_gt_relative_pose_matches_reference():
    from dialog_tpu_torch.datasets import synth as tsynth

    js = jsynth.make_scene(seed=5, n_points=50, n_frames=12, cfg=JCFG)
    ts = tsynth.make_scene(seed=5, n_points=50, n_frames=12, cfg=TCFG)
    for i, j in ((0, 1), (3, 11), (7, 2)):
        for a, b in zip(jsynth.gt_relative_pose(js, i, j), tsynth.gt_relative_pose(ts, i, j)):
            assert b.dtype == np.float32
            np.testing.assert_array_equal(np.asarray(a), b)
