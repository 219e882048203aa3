"""The port's global BA problem, fold and solve (``dialog_tpu_torch/optim/global_ba.py``).

The map comes from a 30-frame synthetic run of the JAX engine (as in
``tests/test_global_ba_sharded.py``) and reaches the port through numpy
(``interop.map_from_numpy``), so both packages start from the same bits.

* ``build_global_problem``: every integer field bit for bit (``obs_cam``,
  ``obs_feat``, ``obs_ok``, ``lm_ids``, ``cam_slots``, ``cam_opt``,
  ``n_dropped``) and the gathered floats exactly, on the map as it is, with
  one landmark repeated within a keyframe row, and with observations cut at a
  small ``max_obs_per_lm`` (``n_dropped > 0``).
* ``fold_gba_result`` on ``tests/test_async_gba.py``'s two cases (a gauge
  change that must reach a keyframe and a landmark made after the snapshot; a
  recycled slot): poses and landmarks within 1e-5 of the reference's fold
  where they are taken over, 1e-4 where they are re-based, as that test holds
  the reference.
* ``global_bundle_adjustment`` against the reference's, 4 LM iterations from
  the map with its optimized keyframes and its landmarks moved off the
  engine's optimum by seeded noise (1e-2): the dense branch (K = 32 cameras) and the PCG branch (the same map in 200
  keyframe slots, above ``DENSE_SCHUR_MAX_CAMS``): poses within 1e-4,
  landmarks within 1e-3 (the reference's own bounds for 8 devices against
  1), the same observations stripped as outliers, the same drop count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.optim import global_ba as jgba
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.interop import map_from_numpy
from dialog_tpu_torch.optim import global_ba as tgba

torch.set_num_threads(2)

CFG_KW = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0, n_features=256, max_features=256,
              max_keyframes=32, max_landmarks=2048, max_local_lms=1024, max_local_kfs=8, max_fixed_kfs=4,
              max_obs_per_lm=8, init_min_features=40, init_min_matches=40, init_min_good=25)


@pytest.fixture(scope="module")
def ref_map():
    """The JAX engine's map after 30 frames of a synthetic sweep (numpy leaves)."""
    cfg = JConfig(**CFG_KW)
    scene = jsynth.make_scene(seed=5, n_points=600, n_frames=30, cfg=cfg)
    eng = JEngine(cfg)
    eng.loop_closing_enabled = False
    for i in range(30):
        eng.track_features(jsynth.observe(scene, i, noise_px=0.4)[0], float(i) / 30.0)
    assert eng.kf_count >= 4
    return jax.device_get(eng.m)


def _both(m_np, **cfg_kw):
    """(reference map, port map on the CPU, reference config, port config)."""
    kw = {**CFG_KW, **cfg_kw}
    jm = jax.tree_util.tree_map(jnp.asarray, m_np)
    return jm, map_from_numpy(m_np, device="cpu"), JConfig(**kw), EngineConfig(**kw)


def _with_repeat(m_np):
    """The map with one keyframe row observing a landmark twice (as fusion's
    global replace can leave it): a later feature takes the first one's id."""
    obs = m_np.kfs.obs_lm.copy()
    k = int(np.nonzero(m_np.kfs.valid)[0][2])
    f = np.nonzero((obs[k] >= 0) & m_np.kfs.feat_valid[k])[0]
    obs[k, f[-1]] = obs[k, f[0]]
    return m_np._replace(kfs=m_np.kfs._replace(obs_lm=obs))


def _padded(m_np, K):
    """The same map in K keyframe slots (the new slots invalid)."""
    def pad(x, fill):
        out = np.full((K,) + x.shape[1:], fill, x.dtype)
        out[: x.shape[0]] = x
        return out

    k0 = m_np.kfs.valid.shape[0]
    fills = {"R": 0.0, "cull_R": 0.0, "valid": False, "feat_valid": False, "obs_lm": -1, "frame_id": -1,
             "parent": -1, "seq": -1, "cull_parent": -1, "cull_seq": -1, "u_right": -1.0, "depth": -1.0}
    kfs = m_np.kfs._replace(**{f: pad(getattr(m_np.kfs, f), fills.get(f, 0)) for f in m_np.kfs._fields})
    eye = np.eye(3, dtype=np.float32)
    kfs = kfs._replace(R=np.concatenate([m_np.kfs.R, np.broadcast_to(eye, (K - k0, 3, 3))]),
                       cull_R=np.concatenate([m_np.kfs.cull_R, np.broadcast_to(eye, (K - k0, 3, 3))]))
    covis = np.zeros((K, K), m_np.covis.dtype)
    covis[:k0, :k0] = m_np.covis
    return m_np._replace(kfs=kfs, covis=covis)


def _perturbed(m_np, seed=0, sigma=1e-2):
    """The map with the keyframes it optimizes (slot >= 2) and its landmarks
    moved by N(0, sigma) in translation and position."""
    rng = np.random.default_rng(seed)
    t = m_np.kfs.t.copy()
    t[2:] += (rng.normal(0.0, sigma, t[2:].shape) * m_np.kfs.valid[2:, None]).astype(np.float32)
    xyz = m_np.lms.xyz + (rng.normal(0.0, sigma, m_np.lms.xyz.shape) * m_np.lms.valid[:, None]).astype(np.float32)
    return m_np._replace(kfs=m_np.kfs._replace(t=t), lms=m_np.lms._replace(xyz=xyz))


def _assert_problem_equal(want, got):
    jprob, jn = want
    tprob, tn = got
    assert int(jn) == int(tn)
    for name in tgba.BAProblem._fields:
        w, g = getattr(jprob, name), getattr(tprob, name)
        if w is None or g is None:
            assert w is None and g is None, name
            continue
        w, g = np.asarray(w), g.numpy()
        assert w.shape == g.shape and w.dtype == g.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("case", ["as-is", "repeat-in-row", "truncated"])
def test_build_global_problem_matches_reference(ref_map, case):
    m_np = _with_repeat(ref_map) if case == "repeat-in-row" else ref_map
    jm, tm, jcfg, tcfg = _both(m_np, **({"max_obs_per_lm": 2} if case == "truncated" else {}))
    want, got = jgba.build_global_problem(jm, jcfg), tgba.build_global_problem(tm, tcfg)
    _assert_problem_equal(want, got)
    n_live = int(got[0].obs_ok.sum())
    assert n_live > 500
    if case == "truncated":
        assert int(got[1]) > 0
    if case == "repeat-in-row":
        # the repeated landmark keeps one observation from that keyframe
        cam = got[0].obs_cam
        assert all(len(set(r[r < 32].tolist())) == int((r < 32).sum()) for r in cam)


def test_build_global_problem_stereo_rows(ref_map):
    """A configuration with a baseline gathers each observation's right-x."""
    jm, tm, jcfg, tcfg = _both(ref_map, bf=40.0)
    _assert_problem_equal(jgba.build_global_problem(jm, jcfg), tgba.build_global_problem(tm, tcfg))


# --- the fold: tests/test_async_gba.py's two cases, in both packages ------

def _rand_pose(rng):
    from dialog_tpu_torch.geometry import so3_exp

    phi = rng.normal(size=3).astype(np.float32) * 0.4
    return so3_exp(torch.from_numpy(phi)).numpy(), rng.normal(size=3).astype(np.float32)


def _base_map():
    from dialog_tpu.containers import empty_map

    cfg = JConfig(max_features=32, max_keyframes=8, max_landmarks=16, max_local_lms=16, max_obs_per_lm=4)
    m = jax.device_get(empty_map(cfg))
    rng = np.random.default_rng(0)
    poses = [_rand_pose(rng) for _ in range(4)]
    R, t = m.kfs.R.copy(), m.kfs.t.copy()
    R[:4], t[:4] = np.stack([p[0] for p in poses]), np.stack([p[1] for p in poses])
    kfs = m.kfs._replace(valid=np.array([1, 1, 1, 0, 0, 0, 0, 0], bool),
                         seq=np.array([0, 1, 2, -1, -1, -1, -1, -1], np.int32),
                         parent=np.array([-1, 0, 1, -1, -1, -1, -1, -1], np.int32), R=R, t=t)
    X = rng.normal(size=(2, 3)).astype(np.float32) + np.array([0, 0, 8], np.float32)
    lms = m.lms
    valid, first, ref, xyz = lms.valid.copy(), lms.first_seq.copy(), lms.ref_kf.copy(), lms.xyz.copy()
    valid[:2], first[:2], ref[:2], xyz[:2] = True, [0, 1], [0, 1], X
    return m._replace(kfs=kfs, lms=lms._replace(valid=valid, first_seq=first, ref_kf=ref, xyz=xyz)), X, rng


def _gauge(m0, rng):
    """Snapshot poses under a gauge change G: T_opt = T o G^-1."""
    Rg, tg = _rand_pose(rng)
    Rgi, tgi = Rg.T, -Rg.T @ tg
    R_opt, t_opt = m0.kfs.R.copy(), m0.kfs.t.copy()
    for k in range(3):
        R_opt[k], t_opt[k] = m0.kfs.R[k] @ Rgi, m0.kfs.R[k] @ tgi + m0.kfs.t[k]
    return Rg, tg, R_opt, t_opt


def _fold_both(m0, m, R_opt, t_opt, xyz_opt):
    jsnap = jgba.GBASnapshot(jax.tree_util.tree_map(jnp.asarray, m0))
    jout = jgba.fold_gba_result(jax.tree_util.tree_map(jnp.asarray, m), jsnap.kf_seq, jsnap.kf_valid, jsnap.lm_valid,
                                jsnap.lm_first_seq, jsnap.lm_ref, jnp.asarray(R_opt), jnp.asarray(t_opt),
                                jnp.asarray(xyz_opt))
    tsnap = tgba.GBASnapshot(map_from_numpy(m0, device="cpu"))
    tout = tgba.fold_gba_result(map_from_numpy(m, device="cpu"), tsnap.kf_seq, tsnap.kf_valid, tsnap.lm_valid,
                                tsnap.lm_first_seq, tsnap.lm_ref, torch.from_numpy(R_opt), torch.from_numpy(t_opt),
                                torch.from_numpy(np.asarray(xyz_opt)))
    return jax.device_get(jout), tout


def test_fold_propagates_a_gauge_change_like_the_reference():
    m0, X, rng = _base_map()
    Rg, tg, R_opt, t_opt = _gauge(m0, rng)
    xyz_opt = m0.lms.xyz.copy()
    xyz_opt[:2] = X @ Rg.T + tg
    # the live map grew after the snapshot: keyframe 3 (seq 3, parent 2) and a landmark anchored at it
    R3, t3 = _rand_pose(rng)
    X2 = np.array([0.5, -0.3, 9.0], np.float32)
    kfs, lms = m0.kfs, m0.lms
    valid, seq, parent, R, t = kfs.valid.copy(), kfs.seq.copy(), kfs.parent.copy(), kfs.R.copy(), kfs.t.copy()
    valid[3], seq[3], parent[3], R[3], t[3] = True, 3, 2, R3, t3
    lv, lf, lr, lx = lms.valid.copy(), lms.first_seq.copy(), lms.ref_kf.copy(), lms.xyz.copy()
    lv[2], lf[2], lr[2], lx[2] = True, 3, 3, X2
    m = m0._replace(kfs=kfs._replace(valid=valid, seq=seq, parent=parent, R=R, t=t),
                    lms=lms._replace(valid=lv, first_seq=lf, ref_kf=lr, xyz=lx))
    want, got = _fold_both(m0, m, R_opt, t_opt, xyz_opt)
    np.testing.assert_allclose(got.kfs.R[:3].numpy(), want.kfs.R[:3], atol=1e-5)
    np.testing.assert_allclose(got.kfs.t[:3].numpy(), want.kfs.t[:3], atol=1e-5)
    np.testing.assert_allclose(got.kfs.R[3:].numpy(), want.kfs.R[3:], atol=1e-4)
    np.testing.assert_allclose(got.kfs.t[3:].numpy(), want.kfs.t[3:], atol=1e-4)
    np.testing.assert_allclose(got.lms.xyz[:2].numpy(), want.lms.xyz[:2], atol=1e-5)
    np.testing.assert_allclose(got.lms.xyz[2:].numpy(), want.lms.xyz[2:], atol=1e-4)
    # and both follow the gauge: the new keyframe is T3 o G^-1, the new landmark G(X2)
    Rgi, tgi = Rg.T, -Rg.T @ tg
    np.testing.assert_allclose(got.kfs.R[3].numpy(), R3 @ Rgi, atol=1e-4)
    np.testing.assert_allclose(got.kfs.t[3].numpy(), R3 @ tgi + t3, atol=1e-4)
    np.testing.assert_allclose(got.lms.xyz[2].numpy(), Rg @ X2 + tg, atol=1e-4)


def test_fold_rebases_a_recycled_slot_like_the_reference():
    m0, X, rng = _base_map()
    Rg, tg, R_opt, t_opt = _gauge(m0, rng)
    # slot 1 was culled and recycled while the GBA ran: a new seq, parent 2
    Rr, tr = _rand_pose(rng)
    seq, parent, R, t = m0.kfs.seq.copy(), m0.kfs.parent.copy(), m0.kfs.R.copy(), m0.kfs.t.copy()
    seq[1], parent[1], R[1], t[1] = 7, 2, Rr, tr
    m = m0._replace(kfs=m0.kfs._replace(seq=seq, parent=parent, R=R, t=t))
    want, got = _fold_both(m0, m, R_opt, t_opt, m0.lms.xyz)
    np.testing.assert_allclose(got.kfs.R.numpy(), want.kfs.R, atol=1e-4)
    np.testing.assert_allclose(got.kfs.t.numpy(), want.kfs.t, atol=1e-4)
    Rgi, tgi = Rg.T, -Rg.T @ tg
    np.testing.assert_allclose(got.kfs.R[1].numpy(), Rr @ Rgi, atol=1e-4)
    np.testing.assert_allclose(got.kfs.t[1].numpy(), Rr @ tgi + tr, atol=1e-4)


# --- the whole global BA ---------------------------------------------------

@pytest.mark.parametrize("branch", ["dense", "pcg"])
def test_global_bundle_adjustment_matches_reference(ref_map, branch):
    m_np = _perturbed(ref_map if branch == "dense" else _padded(ref_map, 200))
    K = m_np.kfs.valid.shape[0]
    assert (K > tgba.DENSE_SCHUR_MAX_CAMS) == (branch == "pcg")
    jm, tm, jcfg, tcfg = _both(m_np, max_keyframes=K)
    jstats, tstats = {}, {}
    want = jax.device_get(jgba.global_bundle_adjustment(jm, jcfg, iters=4, stats=jstats))
    got = tgba.global_bundle_adjustment(tm, tcfg, iters=4, stats=tstats)
    assert jstats == tstats
    valid_kf, valid_lm = want.kfs.valid, want.lms.valid
    np.testing.assert_allclose(got.kfs.R.numpy()[valid_kf], want.kfs.R[valid_kf], atol=1e-4)
    np.testing.assert_allclose(got.kfs.t.numpy()[valid_kf], want.kfs.t[valid_kf], atol=1e-4)
    np.testing.assert_allclose(got.lms.xyz.numpy()[valid_lm], want.lms.xyz[valid_lm], atol=1e-3)
    np.testing.assert_array_equal(got.kfs.obs_lm.numpy(), want.kfs.obs_lm)
    # the solve moved the map back towards the engine's optimum
    assert float(np.abs(got.kfs.t.numpy() - m_np.kfs.t).max()) > 1e-3
    moved = np.abs(got.lms.xyz.numpy() - ref_map.lms.xyz)[valid_lm].mean()
    assert moved < 0.5 * np.abs(m_np.lms.xyz - ref_map.lms.xyz)[valid_lm].mean()
