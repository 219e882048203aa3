"""Parity of the port's local BA and kernel C's plain version with ``dialog_tpu``.

Tolerances:
* ``dedupe_row_landmarks``, ``bucket_observations`` and the problem that
  ``build_problem`` gathers from an engine map: equal (integer bookkeeping
  and plain gathers);
* kernel C's direct outputs (Hll^-1, g_l, Y, Hcc, g_c, g_red, S_pair), the
  port's plain version against the reference's Pallas body run in interpret
  mode: 1e-4 of each output's largest magnitude (f32 sums in another order);
  mono, and stereo (``obs_ur`` on half the observations, bf = 0.12 fx);
* ``solve_ba``, 5 LM iterations, against the reference's einsum path and its
  Pallas kernel: the ``kernels/selfcheck`` bounds, R and t within 2e-3, xyz
  within 5e-3, mono and stereo; the frozen-landmark (``lm_opt``) path likewise;
* ``local_bundle_adjustment`` on a map the JAX engine built (mono, and a
  stereo engine's map, whose problem carries ``obs_ur``): poses and points
  within 1e-3, the stripped outlier observations equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dialog_tpu.config import EngineConfig as JConfig, Sensor as JSensor
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.kernels import schur as jschur
from dialog_tpu.optim import local_ba as jba
from dialog_tpu.optim.synth_problem import FIXTURE_CFG, make_problem
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch import interop
from dialog_tpu_torch.config import EngineConfig as TConfig, Sensor as TSensor
from dialog_tpu_torch.kernels import schur as tschur
from dialog_tpu_torch.optim import local_ba as tba

torch.set_num_threads(2)

TCFG_FIXTURE = TConfig(**{f: getattr(FIXTURE_CFG, f) for f in FIXTURE_CFG.__dataclass_fields__ if f != "sensor"})
STEREO_FIXTURE = FIXTURE_CFG.replace(bf=FIXTURE_CFG.fx * 0.12)     # 12 cm baseline (tests/test_stereo_ba.py)
TSTEREO_FIXTURE = TCFG_FIXTURE.replace(bf=FIXTURE_CFG.fx * 0.12)
SMALL = dict(max_features=256, max_keyframes=16, max_landmarks=2048, max_local_lms=512,
             max_local_kfs=6, max_fixed_kfs=4, max_obs_per_lm=6, max_frames_between_kf=6,
             vocab_min_kfs=1000)
JCFG = JConfig(**SMALL)
TCFG = TConfig(**SMALL)
STEREO = dict(SMALL, bf=517.3 * 0.54, th_depth=35.0)
JCFG_ST = JConfig(**STEREO, sensor=JSensor.STEREO)
TCFG_ST = TConfig(**STEREO, sensor=TSensor.STEREO)
REL_TOL = 1e-4
SOLVE_RT, SOLVE_XYZ = 2e-3, 5e-3


def _prob_to_torch(prob) -> tba.BAProblem:
    return interop.problem_from_numpy(jax.device_get(prob))


def _reduce_args(prob, lam):
    return (prob.R, prob.t, prob.cam_opt, prob.xyz, prob.obs_cam, prob.obs_uv, prob.obs_w, lam)


@pytest.mark.parametrize("seed", [0, 1])
def test_schur_reduce_plain_matches_pallas_interpret(seed, monkeypatch):
    monkeypatch.setenv("DIALOG_TPU_PALLAS_INTERPRET", "1")
    prob, *_ = make_problem(seed=seed)
    c = (FIXTURE_CFG.fx, FIXTURE_CFG.fy, FIXTURE_CFG.cx, FIXTURE_CFG.cy, FIXTURE_CFG.chi2_mono)
    want = jschur.schur_reduce(*_reduce_args(prob, jnp.float32(1e-3)), *c)
    tp = _prob_to_torch(prob)
    got = tschur.schur_reduce(*_reduce_args(tp, torch.tensor(1e-3)), *c)
    names = ["Hll_inv", "g_l", "Y", "Hcc", "g_c", "g_red", "S_pair"]
    for name, w, g in zip(names, want, got):
        w = np.asarray(w)
        assert w.shape == tuple(g.shape), name
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(w - g.numpy()).max()) <= REL_TOL * scale, name


@pytest.mark.parametrize("seed", [0, 1])
def test_schur_reduce_plain_stereo_matches_pallas_interpret(seed, monkeypatch):
    monkeypatch.setenv("DIALOG_TPU_PALLAS_INTERPRET", "1")
    prob, *_, n_pts = make_problem(seed=seed, cfg=STEREO_FIXTURE, stereo_frac=0.5)
    assert 0 < float(np.mean(np.asarray(prob.obs_ur) >= 0)) < 1
    c = (STEREO_FIXTURE.fx, STEREO_FIXTURE.fy, STEREO_FIXTURE.cx, STEREO_FIXTURE.cy, STEREO_FIXTURE.chi2_mono)
    st = dict(bf=STEREO_FIXTURE.bf, delta2_stereo=STEREO_FIXTURE.chi2_stereo)
    want = jschur.schur_reduce(*_reduce_args(prob, jnp.float32(1e-3)), *c, obs_ur=prob.obs_ur, **st)
    mono = jschur.schur_reduce(*_reduce_args(prob, jnp.float32(1e-3)), *c)
    tp = _prob_to_torch(prob)
    got = tschur.schur_reduce(*_reduce_args(tp, torch.tensor(1e-3)), *c, obs_ur=tp.obs_ur, **st)
    names = ["Hll_inv", "g_l", "Y", "Hcc", "g_c", "g_red", "S_pair"]
    for k, (name, w, m, g) in enumerate(zip(names, want, mono, got)):
        w, m, g = np.asarray(w), np.asarray(m), g.numpy()
        assert w.shape == g.shape, name
        if k < 3:   # per-landmark outputs: the observed landmarks (padding holds 1/1e-9)
            w, m, g = w[:n_pts], m[:n_pts], g[:n_pts]
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(w - g).max()) <= REL_TOL * scale, name
        # the uR rows move every output well beyond the tolerance
        assert float(np.abs(w - m).max()) > 100 * REL_TOL * scale, name


@pytest.mark.parametrize("use_kernel", [False, True])
def test_solve_ba_matches_reference(use_kernel, monkeypatch):
    if use_kernel:
        monkeypatch.setenv("DIALOG_TPU_PALLAS_INTERPRET", "1")
    prob, Rs, ts, pts, n_cams, n_pts = make_problem(seed=0)
    Rj, tj, xj, cj = jba.solve_ba(prob, FIXTURE_CFG, iters=5, use_kernel=use_kernel)
    Rt, tt, xt, ct = tba.solve_ba(_prob_to_torch(prob), TCFG_FIXTURE, iters=5)
    assert float(np.abs(np.asarray(Rj) - Rt.numpy()).max()) < SOLVE_RT
    assert float(np.abs(np.asarray(tj) - tt.numpy()).max()) < SOLVE_RT
    assert float(np.abs(np.asarray(xj)[:n_pts] - xt.numpy()[:n_pts]).max()) < SOLVE_XYZ
    # the solve converges: cost falls to the 0.4 px noise floor, as the reference's does
    assert float(ct) < 3.0 * n_pts * 6 * 2 * 0.4**2
    assert float(ct) < 1.1 * float(cj)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_solve_ba_stereo_matches_reference(use_kernel, monkeypatch):
    if use_kernel:
        monkeypatch.setenv("DIALOG_TPU_PALLAS_INTERPRET", "1")
    prob, Rs, ts, pts, n_cams, n_pts = make_problem(seed=4, cfg=STEREO_FIXTURE, stereo_frac=0.5)
    Rj, tj, xj, cj = jba.solve_ba(prob, STEREO_FIXTURE, iters=5, use_kernel=use_kernel)
    Rt, tt, xt, ct = tba.solve_ba(_prob_to_torch(prob), TSTEREO_FIXTURE, iters=5)
    assert float(np.abs(np.asarray(Rj) - Rt.numpy()).max()) < SOLVE_RT
    assert float(np.abs(np.asarray(tj) - tt.numpy()).max()) < SOLVE_RT
    assert float(np.abs(np.asarray(xj)[:n_pts] - xt.numpy()[:n_pts]).max()) < SOLVE_XYZ
    assert float(ct) < 1.1 * float(cj)
    # the stereo rows are in the solve: without them it ends elsewhere
    _, _, xm, _ = tba.solve_ba(_prob_to_torch(prob._replace(obs_ur=None)), TSTEREO_FIXTURE, iters=5)
    assert float(np.abs(xm.numpy()[:n_pts] - xt.numpy()[:n_pts]).max()) > 2 * SOLVE_XYZ


def test_solve_ba_frozen_landmarks_match_reference():
    prob, *_, n_pts = make_problem(seed=2)
    lm_opt = np.arange(prob.xyz.shape[0]) % 3 != 0
    prob = prob._replace(lm_opt=jnp.asarray(lm_opt))
    Rj, tj, xj, _ = jba.solve_ba(prob, FIXTURE_CFG, iters=5, use_kernel=False)
    Rt, tt, xt, _ = tba.solve_ba(_prob_to_torch(prob), TCFG_FIXTURE, iters=5)
    assert float(np.abs(np.asarray(Rj) - Rt.numpy()).max()) < SOLVE_RT
    assert float(np.abs(np.asarray(tj) - tt.numpy()).max()) < SOLVE_RT
    assert float(np.abs(np.asarray(xj)[:n_pts] - xt.numpy()[:n_pts]).max()) < SOLVE_XYZ
    frozen = ~lm_opt[:n_pts]
    np.testing.assert_array_equal(xt.numpy()[:n_pts][frozen], np.asarray(prob.xyz)[:n_pts][frozen])


@pytest.mark.parametrize("seed", [0, 1])
def test_bucketing_matches_reference(seed):
    rng = np.random.default_rng(seed)
    C, F, P, O = 10, 64, 40, 4
    li = rng.integers(0, P + 1, (C, F)).astype(np.int32)   # P = no landmark; duplicates per row
    dj = np.asarray(jba.dedupe_row_landmarks(jnp.asarray(li), P))
    dt = tba.dedupe_row_landmarks(torch.from_numpy(li), P)
    np.testing.assert_array_equal(dj, dt.numpy())
    for w, g in zip(jba.bucket_observations(jnp.asarray(dj), P, O), tba.bucket_observations(dt, P, O)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _engine_map(cfg, seed, n_points):
    """The JAX engine's map after 10 synthetic frames, and its reference keyframe."""
    scene = jsynth.make_scene(seed=seed, n_points=n_points, n_frames=40, cfg=cfg)
    eng = JEngine(cfg)
    eng.loop_closing_enabled = False
    for i in range(10):
        fr, _ = jsynth.observe(scene, i, noise_px=0.4, desc_flips=6)
        eng.track_features(fr, float(i) / 30.0)
    assert eng.state == "OK" and eng.kf_count >= 3
    return eng.m, int(eng.ref_kf)


@pytest.fixture(scope="module", params=["mono", "stereo"])
def engine_map(request):
    """(map, center keyframe, reference config, port config) of a mono or a stereo engine."""
    if request.param == "mono":
        return (*_engine_map(JCFG, 4, 400), JCFG, TCFG)
    return (*_engine_map(JCFG_ST, 9, 900), JCFG_ST, TCFG_ST)


def test_build_problem_matches_reference(engine_map):
    mj, center, jcfg, tcfg = engine_map
    pj = jax.device_get(jba.build_problem(mj, jnp.int32(center), jcfg))
    pt = tba.build_problem(interop.map_from_numpy(jax.device_get(mj)), center, tcfg)
    assert int(np.asarray(pj.obs_ok).sum()) > 100
    assert (pt.obs_ur is not None) == (tcfg.bf > 0)
    if pt.obs_ur is not None:
        assert int((pt.obs_ur >= 0).sum()) > 100
    for name in tba.BAProblem._fields:
        a, b = getattr(pj, name), getattr(pt, name)
        if a is None:
            assert b is None, name
            continue
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def test_local_bundle_adjustment_matches_reference(engine_map):
    mj, center, jcfg, tcfg = engine_map
    # the engine's last BA left the window converged: perturb the points
    noise = np.random.default_rng(3).normal(0, 0.01, mj.lms.xyz.shape).astype(np.float32)
    mj = mj._replace(lms=mj.lms._replace(xyz=mj.lms.xyz + jnp.asarray(noise)))
    rj = jax.device_get(jba.local_bundle_adjustment(mj, center, jcfg, iters=5))
    rt = interop.map_to_numpy(tba.local_bundle_adjustment(interop.map_from_numpy(jax.device_get(mj)),
                                                          center, tcfg, iters=5))
    for part, name in (("kfs", "R"), ("kfs", "t"), ("lms", "xyz")):
        np.testing.assert_allclose(getattr(getattr(rj, part), name), rt[part][name], atol=1e-3, err_msg=name)
    np.testing.assert_array_equal(rj.kfs.obs_lm, rt["kfs"]["obs_lm"])
    moved = np.abs(np.asarray(rj.lms.xyz) - np.asarray(mj.lms.xyz)).max()
    assert moved > 1e-5   # the window really was optimized
