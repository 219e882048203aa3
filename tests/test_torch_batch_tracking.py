"""The batched tracking step of the port against ``dialog_tpu.tracking``.

A map built by the JAX engine on synthetic observations is carried across
with ``interop``; the next B frames go through both packages'
``fused_track_multi`` from the same device-side state.

* Against the reference: the last frame's associations and the batch-summed
  visibility counters equal, ``packed[:, :24]`` (poses and relative poses)
  within 1e-4, the two counts of every frame equal.
* Inside the port: ``fused_track_multi`` equals B chained
  ``fused_track_step_auto`` calls exactly, and the device-selected fallback
  equals the host-branched one exactly, on a frame where the motion-model
  search succeeds and on frames where it fails.
* ``match_reference_kf`` against the reference: equal ids and count.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dialog_tpu import tracking as jt
from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch import interop
from dialog_tpu_torch import tracking as tt
from dialog_tpu_torch.config import EngineConfig as TConfig
from dialog_tpu_torch.containers import FrameArrays

torch.set_num_threads(2)

SMALL = dict(max_features=256, max_keyframes=16, max_landmarks=2048, max_local_lms=512,
             max_local_kfs=6, max_fixed_kfs=4, max_obs_per_lm=6, max_frames_between_kf=6,
             vocab_min_kfs=1000)
JCFG = JConfig(**SMALL)
TCFG = TConfig(**SMALL)
B = 4
TOL = 1e-4


def _t(x):
    x = np.array(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


@pytest.fixture(scope="module")
def state():
    """The JAX engine after 10 synthetic frames, and the next B frames."""
    scene = jsynth.make_scene(seed=4, n_points=400, n_frames=40, cfg=JCFG)
    eng = JEngine(JCFG)
    eng.loop_closing_enabled = False
    poses = []
    for i in range(10):
        rec = eng.track_features(jsynth.observe(scene, i, noise_px=0.4, desc_flips=6)[0], float(i) / 30.0)
        poses.append((rec.R, rec.t))
    assert eng.state == "OK" and eng.kf_count >= 3
    frames = [jsynth.observe(scene, i, noise_px=0.4, desc_flips=6)[0] for i in range(10, 10 + B)]
    batch_j = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)
    batch_t = FrameArrays(*[torch.stack(x) for x in
                            zip(*[interop.frame_from_numpy(jax.device_get(f), device="cpu") for f in frames])])
    (Rp, tp) = poses[-2]
    chain = (eng._last_R, eng._last_t, np.asarray(Rp, np.float32), np.asarray(tp, np.float32))
    args_j = (eng.m, eng._last_lm_ids, batch_j, *[jnp.asarray(x) for x in chain], jnp.asarray(True),
              jnp.int32(eng.ref_kf))
    args_t = (interop.map_from_numpy(jax.device_get(eng.m), device="cpu"), _t(eng._last_lm_ids), batch_t,
              *[_t(x) for x in chain], torch.tensor(True), int(eng.ref_kf))
    return args_j, args_t


@pytest.mark.parametrize("has_vel", [True, False])
def test_fused_track_multi_matches_reference(state, has_vel):
    args_j, args_t = state
    args_j = args_j[:7] + (jnp.asarray(has_vel),) + args_j[8:]
    args_t = args_t[:7] + (torch.tensor(has_vel),) + args_t[8:]
    Rj, tj, Rpj, tpj, lmj, pj, (vj, fj) = jt.fused_track_multi(*args_j, JCFG)
    Rt, tt_, Rpt, tpt, lmt, pt, (vt, ft) = tt.fused_track_multi(*args_t, TCFG)
    pj = np.asarray(pj)
    assert pt.shape == (B, 26) and pt.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(lmj), lmt.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    np.testing.assert_allclose(pj[:, :24], pt.numpy()[:, :24], atol=TOL, rtol=0)
    np.testing.assert_array_equal(pj[:, 24:], pt.numpy()[:, 24:])
    assert (pj[:, 24] > 50).all()
    for a, b in ((Rj, Rt), (tj, tt_), (Rpj, Rpt), (tpj, tpt)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=TOL, rtol=0)
    # the carry: the last two frames' poses
    assert torch.equal(Rt, pt[-1, :9].reshape(3, 3)) and torch.equal(tpt, pt[-2, 9:12])


def test_fused_track_step_auto_matches_reference(state):
    args_j, args_t = state
    one_j = (args_j[0], args_j[1], jax.tree_util.tree_map(lambda x: x[0], args_j[2])) + args_j[3:]
    one_t = (args_t[0], args_t[1], FrameArrays(*[x[0] for x in args_t[2]])) + args_t[3:]
    Rj, tj, lmj, pj, (vj, fj) = jt.fused_track_step_auto(*one_j, JCFG)
    Rt, tt_, lmt, pt, (vt, ft) = tt.fused_track_step_auto(*one_t, TCFG)
    np.testing.assert_array_equal(np.asarray(lmj), lmt.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), atol=TOL, rtol=0)


def test_fused_track_multi_equals_chained_auto_steps(state):
    _, (m, lm_ids, frames, R, t, Rp, tp, hv, ref_kf) = state
    multi = tt.fused_track_multi(m, lm_ids, frames, R, t, Rp, tp, hv, ref_kf, TCFG)
    rows, vis, found = [], 0, 0
    for b in range(B):
        R2, t2, lm_ids, packed, (v, f) = tt.fused_track_step_auto(
            m, lm_ids, FrameArrays(*[x[b] for x in frames]), R, t, Rp, tp, hv, ref_kf, TCFG)
        R, t, Rp, tp, hv = R2, t2, R, t, torch.tensor(True)
        rows.append(packed)
        vis, found = vis + v, found + f
    chained = (R, t, Rp, tp, lm_ids, torch.stack(rows), (vis, found))
    for a, b in zip(multi[:6], chained[:6]):
        assert torch.equal(a, b)
    assert torch.equal(multi[6][0], vis) and torch.equal(multi[6][1], found)
    assert multi[6][0].dtype == torch.int32 and int(multi[6][1].sum()) == int(multi[5][:, 24].sum())


@pytest.mark.parametrize("case", ["motion-model", "wide-search", "reference-keyframe"])
def test_device_select_equals_host_branch(state, case):
    """The same values whether the host reads the motion-model count and
    branches or the device computes the fallback and selects: where the
    first search succeeds, where the doubled radius saves it (the prediction
    a few pixels off), and where only the reference-keyframe match does
    (no association carried over from the last frame)."""
    _, (m, lm_ids, frames, R, t, Rp, tp, hv, ref_kf) = state
    frame = FrameArrays(*[x[0] for x in frames])
    R_pred, t_pred = R, t
    if case == "wide-search":
        t_pred = t + torch.tensor([0.16, 0.0, 0.0])
    if case == "reference-keyframe":
        lm_ids = torch.full_like(lm_ids, -1)
    host = tt.fused_track_step(m, lm_ids, frame, R_pred, t_pred, R, t, ref_kf, TCFG)
    dev = tt.fused_track_step(m, lm_ids, frame, R_pred, t_pred, R, t, ref_kf, TCFG, host_branch=False)
    local = tt.local_landmark_ids(m, ref_kf, TCFG)
    given = tt.fused_track_step(m, lm_ids, frame, R_pred, t_pred, R, t, ref_kf, TCFG, local_ids=local)
    for other in (dev, given):
        for a, b in zip(host[:4], other[:4]):
            assert torch.equal(a, b)
        assert torch.equal(host[4][0], other[4][0]) and torch.equal(host[4][1], other[4][1])
    n_first = int(tt._motion_match(m, lm_ids, frame, R_pred, t_pred, TCFG, TCFG.motion_search_radius)[1])
    assert (n_first >= 20) == (case == "motion-model"), n_first
    if case == "wide-search":
        assert int(tt._motion_match(m, lm_ids, frame, R_pred, t_pred, TCFG, 2 * TCFG.motion_search_radius)[1]) >= 20
    assert int(host[3][24]) > 50


@pytest.mark.parametrize("kf", ["reference", "first"])
def test_match_reference_kf_matches_reference(state, kf):
    (mj, _, frames_j, *_), (mt, _, frames_t, *rest) = state
    slot = int(rest[-1]) if kf == "reference" else 0
    lm_j, n_j = jt.match_reference_kf(mj, jnp.int32(slot), jax.tree_util.tree_map(lambda x: x[1], frames_j), JCFG)
    lm_t, n_t = tt.match_reference_kf(mt, slot, FrameArrays(*[x[1] for x in frames_t]), TCFG)
    np.testing.assert_array_equal(np.asarray(lm_j), lm_t.numpy())
    assert int(n_j) == int(n_t) == int((lm_t >= 0).sum())
    assert int(n_t) >= (15 if kf == "reference" else 0)
