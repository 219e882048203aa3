"""Both engines, end to end, on stereo and RGB-D input.

The JAX engine (loop closing off, no vocabulary within the run, so both take
the same path) and the port's ``Engine`` track the same frames:

* synthetic stereo observations (``observe`` with the stereo right-x and
  depth) through ``track_features``, as ``tests/test_stereo_rgbd.py`` runs
  the reference;
* rendered 320x240 RGB-D frames (the image and ``render_depth`` in TUM's
  units) through ``track_rgbd``, each package with its own frontend, on the
  sweep scaled to indoor depths (1-3 m) so that its points lie within
  ``th_depth x baseline``.

Gates: both engines OK from frame 0 to the end, the same keyframe count, a
metric ATE (no scale alignment) below 0.05 m for each (the reference's own
stereo gate, ``tests/test_stereo_rgbd.py``). On the synthetic observations
the two trajectories differ by at most 1e-3 m in any frame (the engines
make the same decisions there). On the rendered run they part at the first
triangulation, across the 4.5 mm between the first two keyframes, where f32
rounding decides the reprojection and parallax gates of near-degenerate
candidates (ROADMAP D5): there the frames tracked before the first local BA
agree within 1e-3 m, and every frame's positions within 3e-2 m (the
readings: at most 2.4e-2 m, from frame 4 on). ``test_torch_stereo_render.py``
compares the engines on rendered stereo pairs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dialog_tpu.config import EngineConfig as JConfig, Sensor as JSensor
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch import interop
from dialog_tpu_torch.config import EngineConfig as TConfig, Sensor as TSensor
from dialog_tpu_torch.datasets import synth as tsynth
from dialog_tpu_torch.eval.ate import ate_rmse
from dialog_tpu_torch.profile_main_path import RGBD_SCALE
from dialog_tpu_torch.system import OK, Engine as TEngine

torch.set_num_threads(2)

NO_VOCAB = dict(vocab_min_kfs=1000)
STEREO_CFG = dict(bf=517.3 * 0.54, th_depth=35.0, max_features=256, max_keyframes=32, max_landmarks=4096,
                  max_local_lms=1024, max_local_kfs=6, max_fixed_kfs=4, max_obs_per_lm=6,
                  max_frames_between_kf=8, **NO_VOCAB)
RGBD_CFG = dict(width=320, height=240, fx=258.653204, fy=258.2346075, cx=159.32152, cy=127.6569945,
                bf=20.0, th_depth=40.0, depth_map_factor=5000.0, n_features=300, max_features=320, n_levels=4,
                max_keyframes=32, max_landmarks=4096, max_local_lms=1024, max_local_kfs=8, max_fixed_kfs=8,
                max_obs_per_lm=8, local_ba_iters=5, max_frames_between_kf=10, **NO_VOCAB)
N_STEREO, N_RGBD = 30, 12
RGBD_GAP_M = 3e-2


def _engines(cfg_kw, sensor):
    jeng = JEngine(JConfig(**cfg_kw, sensor=JSensor(sensor.value)))
    teng = TEngine(TConfig(**cfg_kw, sensor=sensor), device="cpu")
    jeng.loop_closing_enabled = teng.loop_closing_enabled = False
    return jeng, teng


@pytest.fixture(scope="module")
def observed():
    jeng, teng = _engines(STEREO_CFG, TSensor.STEREO)
    scene = jsynth.make_scene(seed=9, n_points=900, n_frames=40, cfg=jeng.cfg)
    for i in range(N_STEREO):
        fr, _ = jsynth.observe(scene, i, noise_px=0.4, desc_flips=6)
        jeng.track_features(fr, float(i) / 30.0)
        teng.track_features(interop.frame_from_numpy(jax.device_get(fr), device="cpu"), float(i) / 30.0)
    return scene, jeng, teng


@pytest.fixture(scope="module")
def rendered_rgbd():
    jeng, teng = _engines(RGBD_CFG, TSensor.RGBD)
    scene = tsynth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=teng.cfg)
    scene = scene._replace(xyz=scene.xyz * np.float32(RGBD_SCALE), t=scene.t * np.float32(RGBD_SCALE))
    for i in range(N_RGBD):
        img = tsynth.render_image(scene, i)
        depth = tsynth.render_depth(scene, i) * np.float32(RGBD_CFG["depth_map_factor"])
        jeng.track_rgbd(jnp.asarray(img), jnp.asarray(depth), float(i) / 30.0)
        teng.track_rgbd(img, depth, float(i) / 30.0)
    return scene, jeng, teng


def _positions(eng):
    return np.stack([-R.T @ t for R, t in eng.final_poses()])


@pytest.mark.parametrize("run", ["observed", "rendered_rgbd"])
def test_both_engines_track_alike(run, request):
    scene, jeng, teng = request.getfixturevalue(run)
    for eng in (jeng, teng):
        assert [r.state for r in eng.trajectory] == [OK] * len(eng.trajectory)
    assert jeng.kf_count == teng.kf_count >= 2
    pj, pt = _positions(jeng), _positions(teng)
    gt = np.stack([-scene.R[i].T @ scene.t[i] for i in range(len(pj))])
    ate_j, ate_t = ate_rmse(pj, gt, with_scale=False), ate_rmse(pt, gt, with_scale=False)
    assert np.isfinite(ate_j) and np.isfinite(ate_t)
    assert ate_j < 0.05 and ate_t < 0.05, (ate_j, ate_t)
    apart = np.linalg.norm(pj - pt, axis=1)
    if run == "observed":
        assert float(apart.max()) < 1e-3, apart
        return
    # local BA first runs on the third keyframe
    kfs = jax.device_get(jeng.m.kfs)
    first_ba = int(np.sort(np.asarray(kfs.frame_id)[np.asarray(kfs.valid)])[2])
    assert first_ba >= 3 and float(apart[:first_ba].max()) < 1e-3, apart
    assert float(apart.max()) < RGBD_GAP_M, apart


def test_rgbd_keyframes_spawn_depth_landmarks(rendered_rgbd):
    """Every keyframe of the RGB-D run carries landmarks from its own depth."""
    _, jeng, teng = rendered_rgbd
    for eng in (jeng, teng):
        kfs = jax.device_get(eng.m.kfs) if eng is jeng else interop.map_to_numpy(eng.m)["kfs"]
        kfs = kfs if isinstance(kfs, dict) else kfs._asdict()
        live = np.nonzero(np.asarray(kfs["valid"]))[0]
        assert len(live) == eng.kf_count
        for k in live:
            with_depth = (np.asarray(kfs["depth"][k]) > 0) & np.asarray(kfs["feat_valid"][k])
            assert int((np.asarray(kfs["obs_lm"][k])[with_depth] >= 0).sum()) > 30
