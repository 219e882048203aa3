"""Both engines, end to end, on the same input sequences.

The JAX engine (loop closing off, no vocabulary within the run, so both take
the same path) and the port's ``Engine`` track the same frames: rendered
320x240 images through each package's own frontend, and pre-extracted
synthetic observations through ``track_features``. The port draws its
two-view RANSAC minimal sets from the reference's own ``jax.random`` stream
here, so both engines start from the same hypotheses; the engine's own
``torch.Generator`` draws are covered by ``test_torch_init_mapping``.

Gates:
* both engines end OK, reach OK on the same frame, with the same keyframe
  count;
* synthetic observations: each ATE below 2% of the sweep's span (at least
  1 m), the ``test_e2e_synth`` gate;
* rendered images: each ATE below 35% of the span -- the ``test_e2e_image``
  gate of 0.35 m over its ~1 m sweep, scaled to this shorter one (on this
  thin early map the reference itself sits near 18%);
* the two trajectories, each aligned to ground truth, differ by an RMS below
  2% of the span on synthetic observations (measured: 5e-5 m over 2.2 m).
  On rendered images the engines part from the first keyframe after the
  initial map on: f32 rounding moves a projected point or an orientation
  across a match gate, one or two tracked features differ per frame, and
  the difference grows to ~10% of the span. There the gate is that the two
  engines differ from each other by less than either differs from ground
  truth;
* a map saved by either package's ``save_map`` loads in the other.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dialog_tpu import containers as jc
from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.eval import trajectory as jtraj
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch import containers as tc
from dialog_tpu_torch import init2view as ti
from dialog_tpu_torch import interop
from dialog_tpu_torch.config import EngineConfig as TConfig
from dialog_tpu_torch.datasets import synth as tsynth
from dialog_tpu_torch.eval.ate import align_umeyama, ate_rmse
from dialog_tpu_torch.eval.trajectory import load_tum
from dialog_tpu_torch.system import OK, Engine as TEngine

torch.set_num_threads(2)

NO_VOCAB = dict(vocab_min_kfs=1000)
IMAGE_CFG = dict(width=320, height=240, fx=258.653204, fy=258.2346075, cx=159.32152, cy=127.6569945,
                 n_features=300, max_features=320, n_levels=4, max_keyframes=32, max_landmarks=4096,
                 max_local_lms=1024, max_local_kfs=8, max_fixed_kfs=8, max_obs_per_lm=8,
                 local_ba_iters=5, max_frames_between_kf=10, init_min_features=80,
                 init_min_matches=60, init_min_good=40, **NO_VOCAB)
SYNTH_CFG = dict(max_features=256, max_keyframes=16, max_landmarks=2048, max_local_lms=512,
                 max_local_kfs=6, max_fixed_kfs=4, max_obs_per_lm=6, max_frames_between_kf=6, **NO_VOCAB)


class ReferenceDraws:
    """``draw_minimal_sets`` fed from the reference engine's key stream
    (``PRNGKey(n_features)``, one split per initialization attempt)."""

    def __init__(self, n_features: int):
        self.key = jax.random.PRNGKey(n_features)

    def __call__(self, valid, iters, generator=None):
        self.key, sub = jax.random.split(self.key)
        key_f, key_h = jax.random.split(sub)
        n_valid = max(int(valid.sum()), 1)
        return (torch.from_numpy(np.array(jax.random.randint(key_f, (iters, 8), 0, n_valid))),
                torch.from_numpy(np.array(jax.random.randint(key_h, (iters, 4), 0, n_valid))))


def _run_both(cfg_kw, method, inputs_j, inputs_t):
    jeng = JEngine(JConfig(**cfg_kw))
    jeng.loop_closing_enabled = False
    teng = TEngine(TConfig(**cfg_kw), device="cpu")
    teng.loop_closing_enabled = False
    track_j, track_t = getattr(jeng, method), getattr(teng, method)
    for i, x in enumerate(inputs_j):
        track_j(x, float(i) / 30.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ti, "draw_minimal_sets", ReferenceDraws(cfg_kw.get("n_features", 1000)))
        for i, x in enumerate(inputs_t):
            track_t(x, float(i) / 30.0)
    return jeng, teng


@pytest.fixture(scope="module")
def rendered():
    cfg = TConfig(**IMAGE_CFG)
    scene = tsynth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=cfg)
    images = [tsynth.render_image(scene, i) for i in range(20)]
    jeng, teng = _run_both(IMAGE_CFG, "track_image", [jnp.asarray(im) for im in images], images)
    return scene, jeng, teng


@pytest.fixture(scope="module")
def observed():
    scene = jsynth.make_scene(seed=4, n_points=400, n_frames=40, cfg=JConfig(**SYNTH_CFG))
    frames = [jsynth.observe(scene, i, noise_px=0.4, desc_flips=6)[0] for i in range(30)]
    jeng, teng = _run_both(SYNTH_CFG, "track_features", frames, [interop.frame_from_numpy(jax.device_get(f), device="cpu") for f in frames])
    return scene, jeng, teng


def _positions(eng):
    ok = np.array([r.state == OK for r in eng.trajectory])
    return np.stack([-R.T @ t for R, t in eng.final_poses()]), ok


def _metrics(scene, jeng, teng):
    pj, okj = _positions(jeng)
    pt, okt = _positions(teng)
    n = len(pj)
    gt = np.stack([-scene.R[i].T @ scene.t[i] for i in range(n)])
    both = okj & okt
    span = float(np.linalg.norm(gt[both].max(0) - gt[both].min(0)))

    def aligned(p):
        s, R, t = align_umeyama(p[both], gt[both])
        return (s * (R @ p[both].T)).T + t

    diff = float(np.sqrt(np.mean(np.sum((aligned(pj) - aligned(pt)) ** 2, 1))))
    return ate_rmse(pj[okj], gt[okj]), ate_rmse(pt[okt], gt[okt]), span, diff


@pytest.mark.parametrize("run", ["rendered", "observed"])
def test_both_engines_track_alike(run, request):
    scene, jeng, teng = request.getfixturevalue(run)
    assert jeng.state == OK and teng.state == OK
    sj = [r.state for r in jeng.trajectory]
    st = [r.state for r in teng.trajectory]
    assert sj.index(OK) == st.index(OK)
    assert all(s == OK for s in st[st.index(OK):])
    assert jeng.kf_count == teng.kf_count >= 4
    ate_j, ate_t, span, diff = _metrics(scene, jeng, teng)
    gate = 0.35 * span if run == "rendered" else 0.02 * max(span, 1.0)
    assert ate_j < gate and ate_t < gate, (ate_j, ate_t, gate)
    apart = min(ate_j, ate_t) if run == "rendered" else 0.02 * span
    assert diff < apart, (diff, apart)


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_engine_maps_cross_load(observed, saver, tmp_path):
    _, jeng, teng = observed
    path = str(tmp_path / "map.npz")
    if saver == "reference":
        jc.save_map(jeng.m, path)
        got = interop.map_to_numpy(tc.load_map(TConfig(**SYNTH_CFG), path, device="cpu"))
        want = jax.device_get(jeng.m)
    else:
        tc.save_map(teng.m, path)
        got = jax.device_get(jc.load_map(JConfig(**SYNTH_CFG), path))
        want = interop.map_to_numpy(teng.m)
    got, want = _as_dict(got), _as_dict(want)
    for part in ("kfs", "lms"):
        for name, x in want[part].items():
            y = got[part][name]
            if np.asarray(x).dtype == np.uint32 or np.asarray(y).dtype == np.uint32:
                x, y = np.asarray(x).view(np.int32), np.asarray(y).view(np.int32)
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{part}.{name}")
    for name in ("covis", "num_kfs", "num_lms"):
        np.testing.assert_array_equal(np.asarray(want[name]), np.asarray(got[name]), err_msg=name)


def test_trajectory_export_roundtrip(observed, tmp_path):
    _, jeng, teng = observed
    path = str(tmp_path / "traj.txt")
    teng.save_trajectory_tum(path)
    ts, pos, quat = load_tum(path)
    assert len(ts) == len(teng.trajectory)
    np.testing.assert_allclose(pos, teng.positions, atol=1e-5)
    # the reference reads the port's file alike, and writes the same format
    for got, want in zip(jtraj.load_tum(path), (ts, pos, quat)):
        np.testing.assert_array_equal(got, want)
    ref_path = str(tmp_path / "ref.txt")
    jeng.save_trajectory_tum(ref_path)
    assert load_tum(ref_path)[1].shape == pos.shape


def _as_dict(m):
    """A MapState (NamedTuples of arrays) or ``map_to_numpy`` dict, as dicts."""
    if isinstance(m, dict):
        return m
    out = {k: np.asarray(v) for k, v in m._asdict().items() if k not in ("kfs", "lms")}
    out["kfs"] = {k: np.asarray(v) for k, v in m.kfs._asdict().items()}
    out["lms"] = {k: np.asarray(v) for k, v in m.lms._asdict().items()}
    return out
