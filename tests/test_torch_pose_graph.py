"""The port's Sim3 pose graph (``dialog_tpu_torch.optim.pose_graph``) against
ground truth and against ``dialog_tpu.optim.pose_graph`` on the same inputs.

Tolerances: the solves run to convergence (25 iterations, as the reference's
tests do) and must agree within 1e-4 in R, t and s and 1e-3 relative in the
cost; both packages take the same accept/reject decision at every step on
these problems. ``build_pose_graph``'s edge lists are integers and equal
exactly; its measurements within 1e-5. ``apply_pose_graph_correction``
within 1e-5 on unit-scale poses and landmarks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dialog_tpu import geometry as jg
from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.containers import empty_map as j_empty_map
from dialog_tpu.optim import pose_graph as jpg
from dialog_tpu_torch import interop
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.optim import pose_graph as tpg
from dialog_tpu_torch.optim.synth_problem import make_pose_graph

torch.set_num_threads(2)


def _j(prob) -> jpg.PoseGraphProblem:
    return jpg.PoseGraphProblem(*[jnp.asarray(x.numpy()) for x in prob])


def _drift_chain():
    """tests/test_sim3_posegraph.py::test_loop_closure_distributes_drift's problem (numpy)."""
    K = 12
    rng = np.random.default_rng(3)
    gt = []
    for k in range(K):
        th = 2 * np.pi * k / K
        R = np.asarray(jg.so3_exp(jnp.asarray([0.0, th, 0.0], jnp.float32)))
        gt.append((R, np.array([np.sin(th), 0.0, 3.0 - np.cos(th)], np.float32)))
    R0 = np.zeros((K, 3, 3), np.float32)
    t0 = np.zeros((K, 3), np.float32)
    R0[0], t0[0] = gt[0]
    for k in range(1, K):
        R_rel = gt[k][0] @ gt[k - 1][0].T
        t_rel = gt[k][1] - R_rel @ gt[k - 1][1]
        dR, dt = jg.se3_exp(jnp.asarray(rng.normal(0, 0.02, 6).astype(np.float32)))
        R_rel = np.asarray(dR) @ R_rel
        t_rel = np.asarray(dR) @ t_rel + np.asarray(dt)
        R0[k] = R_rel @ R0[k - 1]
        t0[k] = R_rel @ t0[k - 1] + t_rel
    e_i = np.r_[np.arange(1, K), K - 1].astype(np.int32)
    e_j = np.r_[np.arange(0, K - 1), 0].astype(np.int32)
    m_R = np.stack([gt[i][0] @ gt[j][0].T for i, j in zip(e_i, e_j)]).astype(np.float32)
    m_t = np.stack([gt[i][1] - (gt[i][0] @ gt[j][0].T) @ gt[j][1] for i, j in zip(e_i, e_j)]).astype(np.float32)
    E = len(e_i)
    prob = tpg.PoseGraphProblem(
        s=torch.ones(K), R=torch.from_numpy(R0), t=torch.from_numpy(t0),
        opt=torch.from_numpy(np.r_[False, np.ones(K - 1, bool)]), e_i=torch.from_numpy(e_i),
        e_j=torch.from_numpy(e_j), m_s=torch.ones(E), m_R=torch.from_numpy(m_R), m_t=torch.from_numpy(m_t),
        e_ok=torch.ones(E, dtype=torch.bool), e_w=torch.from_numpy(np.r_[np.ones(E - 1), 5.0].astype(np.float32)))
    return prob, gt, t0


def _scale_chain():
    """tests/test_sim3_posegraph.py::test_scale_drift_correction's problem."""
    K = 8
    t0 = np.zeros((K, 3), np.float32)
    for k in range(1, K):
        t0[k] = t0[k - 1] + np.array([0.9 ** k, 0, 0], np.float32)
    eye = torch.eye(3)
    return tpg.PoseGraphProblem(
        s=torch.ones(K), R=eye.expand(K, 3, 3).clone(), t=torch.from_numpy(-t0),
        opt=torch.from_numpy(np.r_[False, np.ones(K - 1, bool)]),
        e_i=torch.arange(1, K, dtype=torch.int32), e_j=torch.arange(0, K - 1, dtype=torch.int32),
        m_s=torch.ones(K - 1), m_R=eye.expand(K - 1, 3, 3).clone(),
        m_t=torch.tensor([-1.0, 0.0, 0.0]).expand(K - 1, 3).clone(),
        e_ok=torch.ones(K - 1, dtype=torch.bool), e_w=torch.ones(K - 1))


class TestPoseGraph:
    """Mirrors tests/test_sim3_posegraph.py::TestPoseGraph on the port."""

    def test_loop_closure_distributes_drift(self):
        prob, gt, t0 = _drift_chain()
        K = len(gt)
        pre = max(np.linalg.norm(t0[k] - gt[k][1]) for k in range(K))
        s, R, t, _ = tpg.solve_pose_graph(prob, iters=25)
        s, t = s.numpy(), t.numpy()
        post = max(np.linalg.norm(t[k] / s[k] - gt[k][1]) for k in range(K))
        assert pre > 0.05
        assert post < 0.02, (pre, post)
        assert np.allclose(s, 1.0, atol=0.02)

    def test_scale_drift_correction(self):
        s, R, t, _ = tpg.solve_pose_graph(_scale_chain(), iters=25)
        centers = -np.einsum("kij,kj->ki", np.transpose(R.numpy(), (0, 2, 1)), t.numpy() / s.numpy()[:, None])
        assert np.abs(centers[:, 0] - np.arange(8)).max() < 0.05


def _hold(ref, got, atol=1e-4):
    for a, b in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol)
    assert abs(float(ref[3]) - float(got[3])) <= 1e-3 * max(abs(float(ref[3])), 1e-6) + 1e-7


@pytest.mark.parametrize("case", ["drift_chain", "scale_chain", "ring_24_of_32"])
def test_solve_parity(case):
    prob = {"drift_chain": lambda: _drift_chain()[0], "scale_chain": _scale_chain,
            "ring_24_of_32": lambda: make_pose_graph(seed=2, K=32, n_live=24, device="cpu")}[case]()
    _hold(jpg.solve_pose_graph(_j(prob), iters=25), tpg.solve_pose_graph(prob, iters=25))


def test_seeded_ring_is_corrected():
    """make_pose_graph's ring: the solve removes most of the drift of the
    node centres (the card's check at K = 256 uses the same generator)."""
    prob = make_pose_graph(seed=1, K=48, device="cpu")
    s, R, t, cost = tpg.solve_pose_graph(prob, iters=15)
    gt = make_pose_graph(seed=1, K=48, drift=0.0, scale_drift=1.0, device="cpu")
    c = lambda R, t, s: -np.einsum("kji,kj->ki", R.numpy(), t.numpy() / s.numpy()[:, None])  # noqa: E731
    pre = np.abs(c(prob.R, prob.t, prob.s) - c(gt.R, gt.t, gt.s)).max()
    post = np.abs(c(R, t, s) - c(gt.R, gt.t, gt.s)).max()
    assert pre > 0.3 and post < 0.2 * pre, (pre, post)
    assert torch.isfinite(cost) and float(cost) < float(tpg._system(prob, prob.s, prob.R, prob.t)[0])


def _random_map(seed=5, K=24, L=64):
    """A reference MapState (numpy) with holes among the keyframes, a
    spanning tree, covisibility weights around the essential threshold and
    landmarks referring to live and dead keyframes."""
    cfg = JConfig(max_keyframes=K, max_landmarks=L, max_features=16)
    rng = np.random.default_rng(seed)
    m = j_empty_map(cfg)
    valid = rng.random(K) > 0.25
    parent = np.where(np.arange(K) > 0, rng.integers(-1, np.maximum(np.arange(K), 1)), -1).astype(np.int32)
    phi = rng.normal(0, 0.4, (K, 3)).astype(np.float32)
    R = np.asarray(jg.so3_exp(jnp.asarray(phi)))
    t = rng.normal(0, 2.0, (K, 3)).astype(np.float32)
    w = rng.integers(0, 200, (K, K)).astype(np.int32)
    covis = np.triu(w, 1) + np.triu(w, 1).T
    lms = m.lms._replace(xyz=jnp.asarray(rng.normal(0, 3, (L, 3)).astype(np.float32)),
                         ref_kf=jnp.asarray(rng.integers(-1, K, L).astype(np.int32)),
                         valid=jnp.asarray(rng.random(L) > 0.2))
    kfs = m.kfs._replace(valid=jnp.asarray(valid), parent=jnp.asarray(parent), R=jnp.asarray(R), t=jnp.asarray(t))
    return cfg, m._replace(kfs=kfs, lms=lms, covis=jnp.asarray(covis))


@pytest.mark.parametrize("th", [100, 180])
def test_build_pose_graph_parity(th):
    jcfg, jm = _random_map()
    jcfg = jcfg.replace(essential_covis_th=th)
    tm = interop.map_from_numpy(jm, device="cpu")
    tcfg = EngineConfig(max_keyframes=jcfg.max_keyframes, max_landmarks=jcfg.max_landmarks, max_features=16,
                        essential_covis_th=th)
    # the loop edge: the current relative pose of (20, 3), off by a small similarity
    Ri, ti, Rj, tj = (np.asarray(x) for x in (jm.kfs.R[20], jm.kfs.t[20], jm.kfs.R[3], jm.kfs.t[3]))
    dR = np.asarray(jg.so3_exp(jnp.asarray([0.03, 0.02, -0.04], jnp.float32)))
    loop_s = 1.1
    loop_R = (dR @ Ri @ Rj.T).astype(np.float32)
    loop_t = (loop_s * dR @ (ti - Ri @ Rj.T @ tj) + np.array([0.05, -0.02, 0.1])).astype(np.float32)
    ref = jpg.build_pose_graph(jm, jcfg, jnp.int32(20), jnp.int32(3), jnp.float32(loop_s), jnp.asarray(loop_R),
                               jnp.asarray(loop_t), jnp.int32(3))
    got = tpg.build_pose_graph(tm, tcfg, 20, 3, loop_s, torch.from_numpy(loop_R), torch.from_numpy(loop_t), 3)
    for name in ("opt", "e_i", "e_j", "e_ok"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)), getattr(got, name).numpy(), err_msg=name)
    for name in ("s", "R", "t", "m_s", "m_R", "m_t", "e_w"):
        np.testing.assert_allclose(np.asarray(getattr(ref, name)), getattr(got, name).numpy(), atol=1e-5,
                                   err_msg=name)
    assert int(got.e_ok.sum()) > jcfg.max_keyframes // 2       # the covisibility edges are there
    # the same problem solved by both
    _hold(jpg.solve_pose_graph(ref, iters=25), tpg.solve_pose_graph(got, iters=25))


def test_apply_correction_parity():
    jcfg, jm = _random_map(seed=6)
    tm = interop.map_from_numpy(jm, device="cpu")
    rng = np.random.default_rng(7)
    K = jcfg.max_keyframes
    s = rng.uniform(0.7, 1.4, K).astype(np.float32)
    R = np.asarray(jg.so3_exp(jnp.asarray(rng.normal(0, 0.5, (K, 3)).astype(np.float32))))
    t = rng.normal(0, 1.0, (K, 3)).astype(np.float32)
    ref = jpg.apply_pose_graph_correction(jm, jnp.asarray(s), jnp.asarray(R), jnp.asarray(t), jcfg)
    got = tpg.apply_pose_graph_correction(tm, torch.from_numpy(s), torch.from_numpy(R), torch.from_numpy(t), None)
    for a, b in [(ref.kfs.R, got.kfs.R), (ref.kfs.t, got.kfs.t), (ref.lms.xyz, got.lms.xyz)]:
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5)


def test_pose_graph_from_numpy_round_trip():
    prob = make_pose_graph(seed=3, K=16, n_live=10, device="cpu")
    back = interop.pose_graph_from_numpy({f: getattr(prob, f).numpy() for f in prob._fields}, device="cpu")
    for a, b in zip(prob, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
