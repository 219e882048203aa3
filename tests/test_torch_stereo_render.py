"""Both engines, frame by frame, on rendered stereo pairs.

The KITTI00 preset at half its resolution (620x188, intrinsics and bf
halved, 600 features) on the scene of the port's ``stereo`` workload
(``profile_main_path.render_stereo_frames``: ``make_scene(seed=7)``, the
right camera ``baseline`` to the right), with a local window small enough
for the CPU. The JAX engine (loop closing off, no vocabulary within the
run) and the port's ``Engine`` each run their own frontend, stereo matching,
tracking, keyframe pipeline and local BA with kernel C's stereo variant
(its plain version here) over the same 12 pairs.

Gates, from the readings of both engines on this run: they make the same
decisions on every frame (state, inliers tracked, keyframe taken), and up to
their first differing decision each frame's camera positions lie within
1e-2 m of each other (the readings: at most 3.5e-3 m, at frame 4, and
below 3e-5 m elsewhere).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dialog_tpu.config import EngineConfig as JConfig, Sensor as JSensor
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch.config import KITTI00, EngineConfig as TConfig, Sensor as TSensor
from dialog_tpu_torch.eval.ate import ate_rmse
from dialog_tpu_torch.profile_main_path import render_stereo_frames
from dialog_tpu_torch.system import OK, Engine as TEngine

torch.set_num_threads(2)

HALF_KITTI = dict(width=620, height=188, fx=KITTI00.fx / 2, fy=KITTI00.fy / 2, cx=KITTI00.cx / 2,
                  cy=KITTI00.cy / 2, bf=KITTI00.bf / 2, fps=KITTI00.fps, th_depth=KITTI00.th_depth,
                  n_features=600, max_features=640, max_keyframes=32, max_landmarks=4096,
                  max_local_lms=1024, max_local_kfs=6, max_fixed_kfs=4, max_obs_per_lm=8,
                  max_frames_between_kf=8, vocab_min_kfs=1000)
N_PAIRS = 12
GAP_M = 1e-2


@pytest.fixture(scope="module")
def runs():
    jeng = JEngine(JConfig(**HALF_KITTI, sensor=JSensor.STEREO))
    jeng.loop_closing_enabled = False
    teng = TEngine(TConfig(**HALF_KITTI, sensor=TSensor.STEREO))
    scene, pairs = render_stereo_frames(teng.cfg, N_PAIRS)
    steps = []
    for i, (left, right) in enumerate(pairs):
        a = jeng.track_stereo(jnp.asarray(left), jnp.asarray(right), float(i) / KITTI00.fps)
        b = teng.track_stereo(left, right, float(i) / KITTI00.fps)
        steps.append(((a.state, a.n_tracked, jeng.kf_count), (b.state, b.n_tracked, teng.kf_count)))
    return scene, jeng, teng, steps


def _positions(eng):
    return np.stack([-R.T @ t for R, t in eng.final_poses()])


def test_rendered_stereo_engines_decide_alike(runs):
    _, jeng, teng, steps = runs
    assert [j for j, _ in steps] == [t for _, t in steps]
    assert [s for (s, _, _), _ in steps] == [OK] * N_PAIRS
    assert jeng.kf_count == teng.kf_count >= 3


def test_rendered_stereo_engines_track_alike(runs):
    scene, jeng, teng, steps = runs
    same = [j == t for j, t in steps]
    first_apart = same.index(False) if False in same else N_PAIRS
    pj, pt = _positions(jeng), _positions(teng)
    gap = np.linalg.norm(pj - pt, axis=1)[:first_apart]
    assert first_apart >= 8 and float(gap.max()) < GAP_M, (first_apart, gap)
    gt = np.stack([-scene.R[i].T @ scene.t[i] for i in range(N_PAIRS)])
    ate_j, ate_t = ate_rmse(pj, gt, with_scale=False), ate_rmse(pt, gt, with_scale=False)
    assert np.isfinite(ate_t) and abs(ate_t - ate_j) < GAP_M, (ate_j, ate_t)
