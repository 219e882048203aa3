"""Parity of the port's stereo and RGB-D modules with ``dialog_tpu``.

Each test feeds both packages the same numpy inputs. Tolerances:
* ``stereo_project_jacobians``: 1e-5 on unit-scale values and 1e-3 on
  pixels against the reference (f32 in another op order); against
  ``torch.func.jacfwd`` of ``stereo_project``, the reference's own autodiff
  bounds (``tests/test_stereo_ba.py``: rtol 1e-4, atol 1e-3);
* ``observe`` and ``render_depth``: equal arrays;
* ``stereo_match_frames`` on a rendered 320x240 pair, from the same
  extracted features: without the images (descriptor match only) equal;
  with the SAD refinement u_right within 1e-3 px, depth within 1e-5
  relative, and the matched masks equal except at SAD near-ties (two SAD
  offsets within 1e-5 relative in float64), which are counted and expected
  to be none;
* ``depth_from_rgbd``: equal;
* stereo ``pose_optimization``: same inliers, R and t within 1e-4;
* ``fused_track_step`` with ``use_stereo``: equal associations and
  counters, pose within 1e-4;
* ``spawn_depth_landmarks``: equal ids and counts, xyz within 1e-5;
  ``process_new_keyframe`` with ``spawn_depth``: integer state equal, float
  state within 1e-3 (the triangulation's tolerance, test_torch_init_mapping).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dialog_tpu import frontend as jfe
from dialog_tpu import geometry as jg
from dialog_tpu import mapping as jmap
from dialog_tpu import stereo as jst
from dialog_tpu import tracking as jt
from dialog_tpu.config import EngineConfig as JConfig, Sensor as JSensor
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.optim import pose_only as jpose
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch import geometry as tg
from dialog_tpu_torch import interop
from dialog_tpu_torch import mapping as tmap
from dialog_tpu_torch import stereo as tst
from dialog_tpu_torch import tracking as tt
from dialog_tpu_torch.config import EngineConfig as TConfig, Sensor as TSensor
from dialog_tpu_torch.datasets import synth as tsynth
from dialog_tpu_torch.optim import pose_only as tpose

torch.set_num_threads(2)

SMALL = dict(max_features=256, max_keyframes=16, max_landmarks=2048, max_local_lms=512,
             max_local_kfs=6, max_fixed_kfs=4, max_obs_per_lm=6, max_frames_between_kf=6,
             vocab_min_kfs=1000, bf=517.3 * 0.54, th_depth=35.0)
JCFG = JConfig(**SMALL, sensor=JSensor.STEREO)
TCFG = TConfig(**SMALL, sensor=TSensor.STEREO)
IMAGE = dict(width=320, height=240, fx=258.653204, fy=258.2346075, cx=159.32152, cy=127.6569945,
             n_features=300, max_features=320, n_levels=4, bf=258.653204 * 0.3, th_depth=40.0)
JIMG = JConfig(**IMAGE, sensor=JSensor.STEREO)
TIMG = TConfig(**IMAGE, sensor=TSensor.STEREO)


def _t(x):
    x = np.array(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def _frame_t(frame_j):
    return interop.frame_from_numpy(jax.device_get(frame_j), device="cpu")


def test_stereo_project_jacobians_match_reference_and_jacfwd():
    rng = np.random.default_rng(0)
    xi = (rng.normal(size=(16, 6)) * 0.3).astype(np.float32)
    R, t = (np.asarray(a) for a in jg.se3_exp(jnp.asarray(xi)))
    X = np.stack([rng.uniform(-2, 2, 16), rng.uniform(-2, 2, 16), rng.uniform(3, 9, 16)], -1).astype(np.float32)
    fx, fy, cx, cy, bf = 500.0, 510.0, 320.0, 240.0, 60.0
    want = jg.stereo_project_jacobians(jnp.asarray(R), jnp.asarray(t), jnp.asarray(X), fx, fy, cx, cy, bf)
    got = tg.stereo_project_jacobians(_t(R), _t(t), _t(X), fx, fy, cx, cy, bf)
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(np.asarray(w), g.numpy(), atol=1e-3 if k in (0, 2, 3) else 1e-5, rtol=1e-5)
    pj, zj = jg.stereo_project(jnp.asarray(R), jnp.asarray(t), jnp.asarray(X), fx, fy, cx, cy, bf)
    pt, zt = tg.stereo_project(_t(R), _t(t), _t(X), fx, fy, cx, cy, bf)
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(np.asarray(zj), zt.numpy(), atol=1e-5, rtol=0)

    # the autodiff oracle runs in float64
    Rt, tt_, Xt = _t(R).double(), _t(t).double(), _t(X).double()
    for i in range(4):
        def res_pose(d, i=i):
            Rp, tp = tg.se3_retract(Rt[i], tt_[i], d)
            return tg.stereo_project(Rp, tp, Xt[i], fx, fy, cx, cy, bf)[0]

        def res_point(Xi, i=i):
            return tg.stereo_project(Rt[i], tt_[i], Xi, fx, fy, cx, cy, bf)[0]

        Jp = torch.func.jacfwd(res_pose)(torch.zeros(6, dtype=torch.float64))
        Jx = torch.func.jacfwd(res_point)(Xt[i])
        np.testing.assert_allclose(got[2][i].numpy(), Jp.numpy(), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got[3][i].numpy(), Jx.numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("stereo", [True, False])
def test_observe_matches_reference(stereo):
    cfg_kw = dict(SMALL) if stereo else {k: v for k, v in SMALL.items() if k not in ("bf", "th_depth")}
    sj = jsynth.make_scene(seed=9, n_points=900, n_frames=40, cfg=JConfig(**cfg_kw))
    st = tsynth.make_scene(seed=9, n_points=900, n_frames=40, cfg=TConfig(**cfg_kw))
    for i in (0, 7):
        fj, idj = jsynth.observe(sj, i, noise_px=0.4, desc_flips=6, drop_rate=0.1)
        ft, idt = tsynth.observe(st, i, noise_px=0.4, desc_flips=6, drop_rate=0.1, device="cpu")
        np.testing.assert_array_equal(idj, idt)
        fj = jax.device_get(fj)
        for name in ft._fields:
            a = np.asarray(getattr(fj, name))
            np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.uint32 else a,
                                          getattr(ft, name).numpy(), err_msg=name)
        assert bool((ft.u_right >= 0).any()) == stereo


def test_render_depth_matches_reference():
    sj = jsynth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=JIMG)
    st = tsynth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=TIMG)
    for i in (0, 11):
        d = tsynth.render_depth(st, i)
        np.testing.assert_array_equal(jsynth.render_depth(sj, i), d)
        assert (d > 0).mean() > 0.05


@pytest.fixture(scope="module")
def stereo_pair():
    """A rendered 320x240 stereo pair (right camera 0.3 m to the right) and
    both frames' features from the reference frontend."""
    scene = tsynth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=TIMG)
    scene_r = scene._replace(t=scene.t - np.array([TIMG.baseline, 0.0, 0.0], np.float32))
    img_l, img_r = tsynth.render_image(scene, 4), tsynth.render_image(scene_r, 4)
    left = jfe.extract_features(jnp.asarray(img_l), JIMG)
    right = jfe.extract_features(jnp.asarray(img_r), JIMG)
    return scene, img_l, img_r, left, right


def _sad_near_ties(img_l, img_r, uv_raw, uR0, cand, rel=1e-5) -> int:
    """Candidates whose two best SAD offsets lie within ``rel`` (float64)."""
    H, W = img_l.shape
    P, WIDE = 2 * tst.SAD_W + 1, 2 * tst.SAD_W + 1 + 2 * tst.SAD_L
    n = 0
    for i in np.nonzero(cand)[0]:
        xl, yl, xr = (int(np.round(v)) for v in (uv_raw[i, 0], uv_raw[i, 1], uR0[i]))
        y0, x0 = np.clip(yl - tst.SAD_W, 0, H - P), np.clip(xl - tst.SAD_W, 0, W - P)
        r0 = np.clip(xr - tst.SAD_W - tst.SAD_L, 0, W - WIDE)
        pl = img_l[y0:y0 + P, x0:x0 + P].astype(np.float64)
        sr = img_r[y0:y0 + P, r0:r0 + WIDE].astype(np.float64)
        s = np.sort([np.abs(pl - sr[:, o:o + P]).sum() for o in range(2 * tst.SAD_L + 1)])
        n += int(s[1] - s[0] <= rel * max(s[0], 1.0))
    return n


def test_stereo_match_frames_matches_reference(stereo_pair):
    _, img_l, img_r, left, right = stereo_pair
    lt, rt = _frame_t(left), _frame_t(right)
    # descriptor match alone: integer gates and a gather
    mj = jax.device_get(jst.stereo_match_frames(left, right, JIMG))
    mt = tst.stereo_match_frames(lt, rt, TIMG)
    np.testing.assert_array_equal(mj.u_right, mt.u_right.numpy())
    np.testing.assert_array_equal(mj.depth, mt.depth.numpy())
    cand = mj.u_right >= 0
    assert cand.sum() > 50
    # with the SAD refinement
    sj = jax.device_get(jst.stereo_match_frames(left, right, JIMG, img_left=jnp.asarray(img_l),
                                                img_right=jnp.asarray(img_r)))
    stf = tst.stereo_match_frames(lt, rt, TIMG, img_left=torch.from_numpy(img_l), img_right=torch.from_numpy(img_r))
    okj, okt = sj.u_right >= 0, stf.u_right.numpy() >= 0
    ties = _sad_near_ties(img_l, img_r, np.asarray(jax.device_get(left.uv_raw)), mj.u_right, cand)
    assert ties == 0
    np.testing.assert_array_equal(okj, okt)
    assert okj.sum() > 50
    np.testing.assert_allclose(sj.u_right[okj], stf.u_right.numpy()[okj], atol=1e-3, rtol=0)
    np.testing.assert_allclose(sj.depth[okj], stf.depth.numpy()[okj], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(sj.depth[~okj], stf.depth.numpy()[~okj])


def test_depth_from_rgbd_matches_reference(stereo_pair):
    scene, _, _, left, _ = stereo_pair
    cfg_kw = dict(IMAGE, bf=40.0, depth_map_factor=5000.0)
    depth = tsynth.render_depth(scene, 4) * np.float32(5000.0)
    for bf in (40.0, 0.0):
        cj = JConfig(**dict(cfg_kw, bf=bf), sensor=JSensor.RGBD)
        ct = TConfig(**dict(cfg_kw, bf=bf), sensor=TSensor.RGBD)
        fj = jax.device_get(jst.depth_from_rgbd(left, jnp.asarray(depth), cj))
        ft = tst.depth_from_rgbd(_frame_t(left), torch.from_numpy(depth), ct)
        np.testing.assert_array_equal(fj.depth, ft.depth.numpy())
        np.testing.assert_array_equal(fj.u_right, ft.u_right.numpy())
        assert (ft.depth.numpy() > 0).sum() > 50


def _stereo_pose_problem(seed, n=200, outliers=30, bf=60.0):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1).astype(np.float32)
    R, t = (np.array(a) for a in jg.se3_exp(jnp.asarray((rng.normal(size=6) * 0.05).astype(np.float32))))
    Xc = X @ R.T + t
    uv = np.stack([500 * Xc[:, 0] / Xc[:, 2] + 320, 500 * Xc[:, 1] / Xc[:, 2] + 240], -1)
    uv = (uv + rng.normal(0, 0.7, uv.shape)).astype(np.float32)
    ur = (uv[:, 0] - bf / Xc[:, 2] + rng.normal(0, 0.7, n)).astype(np.float32)
    ur[rng.random(n) < 0.4] = -1.0                       # monocular observations
    uv[:outliers] += rng.uniform(-40, 40, (outliers, 2)).astype(np.float32)
    inv_s2 = (1.2 ** (-2.0 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.random(n) > 0.05
    R0, t0 = jg.se3_retract(jnp.asarray(R), jnp.asarray(t), jnp.asarray((rng.normal(size=6) * 0.02).astype(np.float32)))
    return X, uv, ur, inv_s2, valid, np.array(R0), np.array(t0)


@pytest.mark.parametrize("seed,rounds", [(0, 4), (1, 2)])
def test_stereo_pose_optimization_matches_reference(seed, rounds):
    X, uv, ur, inv_s2, valid, R0, t0 = _stereo_pose_problem(seed)
    ref = jpose.pose_optimization(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X), jnp.asarray(uv),
                                  jnp.asarray(inv_s2), jnp.asarray(valid), 500.0, 500.0, 320.0, 240.0,
                                  chi2_th=7.815, rounds=rounds, iters=10, u_right=jnp.asarray(ur), bf=60.0,
                                  use_stereo=True)
    got = tpose.pose_optimization(_t(R0), _t(t0), _t(X), _t(uv), _t(inv_s2), _t(valid), 500.0, 500.0, 320.0, 240.0,
                                  chi2_th=7.815, rounds=rounds, iters=10, u_right=_t(ur), bf=60.0, use_stereo=True)
    np.testing.assert_array_equal(np.asarray(ref.inlier), got.inlier.numpy())
    assert int(ref.n_inliers) == int(got.n_inliers) > 100
    np.testing.assert_allclose(np.asarray(ref.R), got.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref.t), got.t.numpy(), atol=1e-4)


@pytest.fixture(scope="module")
def tracked():
    """JAX stereo engine after 8 synthetic stereo frames, plus the 9th frame."""
    scene = jsynth.make_scene(seed=9, n_points=900, n_frames=40, cfg=JCFG)
    eng = JEngine(JCFG)
    eng.loop_closing_enabled = False
    for i in range(8):
        fr, _ = jsynth.observe(scene, i, noise_px=0.4, desc_flips=6)
        eng.track_features(fr, float(i) / 30.0)
    assert eng.state == "OK" and eng.kf_count >= 2
    frame, _ = jsynth.observe(scene, 8, noise_px=0.4, desc_flips=6)
    Rv, tv = eng._vel
    R_pred, t_pred = Rv @ eng._last_R, Rv @ eng._last_t + tv
    args_j = (eng.m, eng._last_lm_ids, frame, jnp.asarray(R_pred), jnp.asarray(t_pred),
              jnp.asarray(eng._last_R), jnp.asarray(eng._last_t), jnp.int32(eng.ref_kf))
    args_t = (interop.map_from_numpy(jax.device_get(eng.m), device="cpu"), _t(eng._last_lm_ids), _frame_t(frame),
              _t(R_pred), _t(t_pred), _t(eng._last_R), _t(eng._last_t), int(eng.ref_kf))
    return args_j, args_t


def test_stereo_fused_track_step_matches_reference(tracked):
    args_j, args_t = tracked
    Rj, tj, lmj, pj, (vj, fj) = jt.fused_track_step(*args_j, JCFG, use_stereo=True)
    Rt, tt_, lmt, pt, (vt, ft) = tt.fused_track_step(*args_t, TCFG, use_stereo=True)
    np.testing.assert_array_equal(np.asarray(lmj), lmt.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), atol=1e-4)
    assert int(np.asarray(pj)[24]) > 50


@pytest.fixture(scope="module")
def new_keyframe(tracked):
    """Both maps with the tracked 9th frame inserted as a keyframe."""
    args_j, _ = tracked
    Rj, tj, lmj, _, _ = jt.fused_track_step(*args_j, JCFG, use_stereo=True)
    mj, frame = args_j[0], args_j[2]
    slot = int(np.nonzero(~np.asarray(mj.kfs.valid))[0][0])
    parent = int(args_j[7])
    jargs = (frame, Rj, tj, lmj, jnp.int32(8), jnp.float32(0.25), jnp.int32(slot), jnp.int32(parent))
    targs = (_frame_t(frame), _t(Rj), _t(tj), _t(lmj), 8, 0.25, slot, parent)
    return mj, interop.map_from_numpy(jax.device_get(mj), device="cpu"), jargs, targs, slot


def test_spawn_depth_landmarks_matches_reference(new_keyframe):
    mj, mt, jargs, targs, slot = new_keyframe
    mj = jmap.spawn_depth_landmarks(jmap.insert_keyframe(mj, *jargs, JCFG), jnp.int32(slot), JCFG)
    mt = tmap.spawn_depth_landmarks(tmap.insert_keyframe(mt, *targs, TCFG), slot, TCFG)
    a, b = jax.device_get(mj), interop.map_to_numpy(mt)
    spawned = np.asarray(a.kfs.obs_lm[slot]) >= 0
    assert spawned.sum() > (np.asarray(jargs[3]) >= 0).sum() + 10
    for name in ("obs_lm", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(a.kfs, name)), b["kfs"][name], err_msg=name)
    for name in ("valid", "n_obs", "ref_kf", "first_seq", "n_visible", "n_found"):
        np.testing.assert_array_equal(np.asarray(getattr(a.lms, name)), b["lms"][name], err_msg=name)
    np.testing.assert_array_equal(np.asarray(a.lms.desc), b["lms"]["desc"])
    for name in ("xyz", "normal", "dmin", "dmax"):
        np.testing.assert_allclose(np.asarray(getattr(a.lms, name)), b["lms"][name], atol=1e-5, rtol=1e-6,
                                   err_msg=name)
    assert int(a.num_lms) == int(b["num_lms"])


def test_process_new_keyframe_spawn_depth_matches_reference(new_keyframe):
    mj, mt, jargs, targs, _ = new_keyframe
    mj = jmap.process_new_keyframe(mj, *jargs, JCFG, spawn_depth=True, n_neighbors=JCFG.kf_tri_neighbors)
    mt = tmap.process_new_keyframe(mt, *targs, TCFG, spawn_depth=True, n_neighbors=TCFG.kf_tri_neighbors)
    a, b = jax.device_get(mj), interop.map_to_numpy(mt)
    for part in ("kfs", "lms"):
        for name in getattr(a, part)._fields:
            x, y = np.asarray(getattr(getattr(a, part), name)), b[part][name]
            if np.issubdtype(x.dtype, np.floating):
                np.testing.assert_allclose(x, y, atol=1e-3, rtol=1e-3, err_msg=f"{part}.{name}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{part}.{name}")
    np.testing.assert_array_equal(np.asarray(a.covis), b["covis"])
