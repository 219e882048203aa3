"""The port's block bundle adjustment (``dialog_tpu_torch/optim/block_ba.py``)
against ``dialog_tpu/optim/block_ba.py``.

The maps are ``tests/test_block_ba.py``'s synthetic corridor (64 keyframes,
40 landmarks each, banded covisibility), carried across by numpy
(``interop.map_from_numpy``), so both packages start from the same bits.

* ``build_block_problems`` bit for bit in every field, ``cam_own`` and the
  drop count included: the default blocks, a culled keyframe whose
  landmarks re-anchor to an observer's block, and more owned keyframes per
  block than ``cams_pb`` (R1: the reference leaves them out without a word;
  the port's fourth result counts them, and so does
  ``stats["block_ba_kf_dropped"]``).
* One block's ``solve_ba`` with its frozen landmarks (``lm_opt``) against the
  reference's einsum path (``use_kernel=False``): within 1e-4 (a landmark
  seen once in the block: within 1e-4 of its depth).
* ``block_bundle_adjustment`` against the reference's within the
  reference's own bounds for 8 devices against 1 (5e-4 in t, 5e-3 in xyz:
  the landmarks whose depth the corridor's near-parallel rays leave
  ill-conditioned are held in pixels instead), and the reference test's
  convergence gates: block-local error falls
  2.5-fold, globally spread error does not grow.
* ``Engine.block_refine``: the same gate, and tracking re-based on the
  refined reference keyframe.
* Two gloo ranks (``gba_rank.launch``, a block job) against one: the blocks
  are dealt out over the ranks and come back by one ``all_reduce`` of
  zero-filled tensors, so the maps are equal bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from dialog_tpu.optim import block_ba as jblock
from dialog_tpu.optim.local_ba import solve_ba as jsolve_ba
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.interop import map_from_numpy, problem_from_numpy
from dialog_tpu_torch.optim import block_ba as tblock
from dialog_tpu_torch.optim.local_ba import solve_ba
from test_block_ba import CFG as JCFG, N_KF, _pose_err, corridor_map

torch.set_num_threads(2)

CFG = EngineConfig(max_features=JCFG.max_features, max_keyframes=JCFG.max_keyframes,
                   max_landmarks=JCFG.max_landmarks, max_obs_per_lm=JCFG.max_obs_per_lm)


def _both(**kw):
    """(reference map, port map on the CPU, ground-truth t) of one corridor."""
    m, t_gt, _ = corridor_map(**kw)
    return m, map_from_numpy(jax.device_get(m), device="cpu"), t_gt


def _cull(m, k):
    """Keyframe ``k`` invalid, its landmarks' reference left pointing at it."""
    return m._replace(kfs=m.kfs._replace(valid=m.kfs.valid.at[k].set(False)))


def _port_err(m, t_gt):
    R = m.kfs.R[:N_KF].numpy()
    t = m.kfs.t[:N_KF].numpy()
    C = -np.einsum("kij,ki->kj", R, t)
    return float(np.linalg.norm(C + t_gt, axis=1).mean())


# (case, culled keyframe, n_blocks, cams_pb, lms_pb)
BUILD_CASES = [("default", None, 8, 24, 512), ("orphans", 10, 8, 24, 512), ("r1_cams_past_cap", None, 2, 24, 512)]


@pytest.mark.parametrize("case,cull,n_blocks,cams_pb,lms_pb", BUILD_CASES, ids=[c[0] for c in BUILD_CASES])
def test_build_block_problems_bit_equal(case, cull, n_blocks, cams_pb, lms_pb):
    jm, _, _ = _both()
    if cull is not None:
        jm = _cull(jm, cull)
    tm = map_from_numpy(jax.device_get(jm), device="cpu")
    jp, jown, jdrop = jax.device_get(jblock.build_block_problems(jm, JCFG, n_blocks, cams_pb, lms_pb))
    tp, town, tdrop, tkf = tblock.build_block_problems(tm, CFG, n_blocks, cams_pb, lms_pb)
    for f in tp._fields:
        want, got = getattr(jp, f), getattr(tp, f)
        if want is None:
            assert got is None, f
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f)
    np.testing.assert_array_equal(town.numpy(), np.asarray(jown))
    assert int(tdrop) == int(jdrop)
    # R1: every live keyframe is owned by one block; the reference keeps cam_own.sum() of them
    left_out = int(np.asarray(jm.kfs.valid).sum()) - int(np.asarray(jown).sum())
    assert int(tkf) == left_out
    assert (left_out > 0) == (case == "r1_cams_past_cap")


def test_r1_stat_counts_the_owned_keyframes_left_out():
    """Divergence on purpose (ROADMAP R1): the same selection as the
    reference, so the same result, and the left-out keyframes counted once
    per round."""
    jm, tm, _ = _both()
    _, jown, _ = jax.device_get(jblock.build_block_problems(jm, JCFG, 2, 24, 512))
    stats = {}
    tblock.block_bundle_adjustment(tm, CFG, n_blocks=2, rounds=1, iters=1, cams_pb=24, lms_pb=512, stats=stats)
    assert stats["block_ba_kf_dropped"] == N_KF - int(np.asarray(jown).sum()) > 0
    assert stats["block_ba_obs_dropped"] >= 0


def test_frozen_landmark_block_solve_matches_reference():
    jm, _, _ = _both(seed=2)
    jp, _, _ = jblock.build_block_problems(jm, JCFG, 8, 24, 512)
    p1 = jax.tree_util.tree_map(lambda x: x[3], jp)
    want = jax.device_get(jsolve_ba(p1, JCFG, iters=6, chi2_th=JCFG.chi2_mono, use_kernel=False))
    tp = problem_from_numpy(jax.device_get(p1), device="cpu")
    assert tp.lm_opt is not None and bool((~tp.lm_opt & (tp.lm_ids < CFG.max_landmarks)).any())
    got = solve_ba(tp, CFG, iters=6, chi2_th=CFG.chi2_mono)
    for g, w, name in zip(got[:2], want[:2], ("R", "t")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, err_msg=name)
    # landmarks seen at least twice in the block within 1e-4; one seen once has its depth set by the
    # damping alone and slides along its ray (both f32 solves lie some 3e-4 from a float64 one there, at
    # depths of 3-20): it is held within 1e-4 of its depth
    live = tp.lm_ids < CFG.max_landmarks
    d = (got[2] - torch.from_numpy(np.asarray(want[2]))).abs().amax(1)
    c0 = torch.clamp(tp.obs_cam[:, 0], 0, tp.R.shape[0] - 1).long()
    depth = (torch.einsum("pij,pj->pi", got[0][c0], got[2]) + got[1][c0])[:, 2].abs()
    twice = live & (tp.obs_ok.sum(1) >= 2)
    assert float(d[twice].max()) < 1e-4
    assert float((d / depth)[live & ~twice].max()) < 1e-4
    assert int((live & ~twice).sum()) < int(twice.sum())
    # the frozen landmarks did not move
    frozen = ~tp.lm_opt
    assert torch.equal(got[2][frozen], tp.xyz[frozen])
    moved = float((got[1] - tp.t).abs().max())
    assert moved > 1e-3, moved


@pytest.fixture(scope="module")
def seed1_runs():
    """The reference's and the port's block BA from corridor seed 1 (the
    reference test's sharding case)."""
    jm, tm, _ = _both(seed=1)
    kw = dict(n_blocks=8, rounds=2, iters=4, cams_pb=24, lms_pb=512)
    want = jax.device_get(jblock.block_bundle_adjustment(jm, JCFG, **kw))
    stats = {}
    got = tblock.block_bundle_adjustment(tm, CFG, stats=stats, **kw)
    return tm, want, got, stats, kw


def _landmark_views(m):
    """Every observation of the corridor's keyframes: (landmark, its
    camera-frame point in float64)."""
    obs = m.kfs.obs_lm[:N_KF].long()
    k, f = torch.nonzero(m.kfs.feat_valid[:N_KF] & (obs >= 0), as_tuple=True)
    lm = obs[k, f]
    Xc = torch.einsum("nij,nj->ni", m.kfs.R[k].double(), m.lms.xyz[lm].double()) + m.kfs.t[k].double()
    return k, lm, Xc


def test_block_ba_matches_reference(seed1_runs):
    """Poses within 5e-4. Landmarks as ``chip_smoke.check_schur_solve``
    holds a stereo window: those whose undamped Hll over all their
    observations (float64, at the port's result) has a condition number at
    most COND_MAX within 5e-3; the others (near the corridor's focus of
    expansion their rays are near parallel, and both packages send some of
    them hundreds of metres down the ray) where the keyframes see them:
    every observation's predicted pixel within fx x 5e-3 / the median
    depth."""
    COND_MAX = 1e4
    _, want, got, stats, _ = seed1_runs
    np.testing.assert_allclose(got.kfs.t[:N_KF].numpy(), np.asarray(want.kfs.t[:N_KF]), atol=5e-4)
    np.testing.assert_allclose(got.kfs.R[:N_KF].numpy(), np.asarray(want.kfs.R[:N_KF]), atol=5e-4)
    assert stats["block_ba_kf_dropped"] == 0
    wm = map_from_numpy(want, device="cpu")
    k, lm, Xc = _landmark_views(got)
    _, _, Xw = _landmark_views(wm)
    x, y, z = Xc.unbind(-1)
    J = torch.zeros((len(k), 2, 3), dtype=torch.float64)
    J[:, 0, 0], J[:, 0, 2], J[:, 1, 1], J[:, 1, 2] = CFG.fx / z, -CFG.fx * x / z**2, CFG.fy / z, -CFG.fy * y / z**2
    J = J @ got.kfs.R[k].double()
    L = got.lms.xyz.shape[0]
    H = torch.zeros((L, 3, 3), dtype=torch.float64).index_add_(0, lm, J.transpose(1, 2) @ J)
    ev = torch.linalg.eigvalsh(H)
    held = got.lms.valid & (ev[:, 0] > 0) & (ev[:, 2] <= COND_MAX * ev[:, 0])
    loose = got.lms.valid & ~held
    d = (got.lms.xyz - wm.lms.xyz).abs().amax(1)
    assert float(d[held].max()) < 5e-3
    assert int(held.sum()) > 0.8 * int((got.lms.valid & (H[:, 0, 0] > 0)).sum())
    uv = lambda X: torch.stack([CFG.fx * X[:, 0] / X[:, 2], CFG.fy * X[:, 1] / X[:, 2]], -1)  # noqa: E731
    px = (uv(Xc) - uv(Xw)).abs().amax(1)
    px_tol = CFG.fx * 5e-3 / float(z.median())
    assert float(px[loose[lm]].max()) < px_tol


def test_fixes_block_local_error():
    _, tm, t_gt = _both(block_local=True, n_blocks=4)
    err0 = _port_err(tm, t_gt)
    m2 = tblock.block_bundle_adjustment(tm, CFG, n_blocks=4, rounds=2, iters=8, cams_pb=32, lms_pb=1024)
    err1 = _port_err(m2, t_gt)
    assert err1 < err0 / 2.5, (err0, err1)


def test_monotone_on_global_noise():
    jm, tm, t_gt = _both()
    err0 = _port_err(tm, t_gt)
    assert abs(err0 - _pose_err(jm, t_gt)) < 1e-6
    m2 = tblock.block_bundle_adjustment(tm, CFG, n_blocks=8, rounds=2, iters=6, cams_pb=24, lms_pb=512)
    err1 = _port_err(m2, t_gt)
    assert err1 < err0 * 1.02, (err0, err1)


def test_engine_block_refine_rebases_tracking():
    from dialog_tpu_torch.system import Engine

    _, tm, t_gt = _both(block_local=True, n_blocks=4)
    eng = Engine(CFG, device="cpu")
    eng.m = tm
    eng.kf_count = N_KF
    eng.ref_kf = N_KF - 1
    eng._vel = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    err0 = _port_err(eng.m, t_gt)
    eng.block_refine(n_blocks=4, rounds=2, iters=8, cams_pb=32, lms_pb=1024)
    err1 = _port_err(eng.m, t_gt)
    assert err1 < err0 / 2.5, (err0, err1)
    np.testing.assert_allclose(eng._last_t, eng.m.kfs.t[eng.ref_kf].numpy(), atol=1e-6)
    np.testing.assert_allclose(eng._last_R, eng.m.kfs.R[eng.ref_kf].numpy(), atol=1e-6)
    assert eng._vel is None and eng._dev_state is None
    assert eng.stats["block_ba_kf_dropped"] == 0
    assert eng._kf_valid_host[:N_KF].all() and not eng._kf_valid_host[N_KF:].any()


def test_two_ranks_match_one(seed1_runs, tmp_path):
    from pathlib import Path

    from dialog_tpu_torch.containers import save_map
    from dialog_tpu_torch.gba_rank import config_to_json, free_address, launch

    tm, _, got, _, kw = seed1_runs
    save_map(tm, str(tmp_path / "map.npz"))
    job = {"kind": "block", "config": config_to_json(CFG), "map": str(tmp_path / "map.npz"),
           "out": str(tmp_path / "out.npz"), **kw}
    spec = {"address": free_address(), "world": 2, "backend": "gloo", "device": "cpu", "jobs": [job]}
    ranks = launch(spec, str(tmp_path / "job.json"), timeout=300, cwd=Path(__file__).resolve().parent.parent)
    for r in range(2):
        out = ranks[r][0]
        assert int(out["world"]) == 2
        np.testing.assert_array_equal(out["R"], got.kfs.R.numpy())
        np.testing.assert_array_equal(out["t"], got.kfs.t.numpy())
        np.testing.assert_array_equal(out["xyz"], got.lms.xyz.numpy())
        assert int(out["block_ba_kf_dropped"]) == 0
