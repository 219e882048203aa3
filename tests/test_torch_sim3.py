"""The port's Sim3 RANSAC and refinement (``dialog_tpu_torch.sim3``) against
ground truth and against ``dialog_tpu.sim3`` on the same inputs.

The port takes its minimal sets as an argument; the parity cases feed it the
reference's own draw, ``jax.random.randint(key, (iters, 3), 0, n_valid)``
as ``dialog_tpu/sim3.py:159`` makes it. They compare the refit similarity
after RANSAC and the refined one, never a single hypothesis (an f32 SVD of a
near-degenerate minimal set parts between packages). Tolerances: success and
inlier counts equal; s, R, t within 1e-4 after the refit, within 1e-3 after
the refinement (ten damped Gauss-Newton steps in f32 with accept/reject).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dialog_tpu import geometry as jg
from dialog_tpu import sim3 as js
from dialog_tpu_torch import sim3 as ts

torch.set_num_threads(2)


def _make(seed=0, n=100, outlier_frac=0.2, s_gt=1.4):
    rng = np.random.default_rng(seed)
    X1 = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    R_gt = np.asarray(jg.so3_exp(jnp.asarray(np.array([0.2, -0.3, 0.5], np.float32))))
    t_gt = np.array([0.5, -1.0, 2.0], np.float32)
    X2 = (s_gt * X1 @ R_gt.T + t_gt + rng.normal(0, 0.005, (n, 3))).astype(np.float32)
    n_out = int(n * outlier_frac)
    X2[:n_out] += rng.uniform(1.0, 3.0, (n_out, 3))
    return X1, X2, s_gt, R_gt, t_gt


def _ref_pick(key, valid, iters=128):
    """The reference's hypotheses, drawn as dialog_tpu/sim3.py:159 draws them."""
    n_valid = max(int(np.sum(valid)), 1)
    return torch.from_numpy(np.asarray(jax.random.randint(key, (iters, 3), 0, n_valid)).astype(np.int64))


def _angle_deg(Ra, Rb):
    return np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)))


class TestSim3:
    """Mirrors tests/test_sim3_posegraph.py::TestSim3 on the port, with the draw from a torch generator."""

    def _solve(self, X1, X2, valid, seed, **kw):
        v = torch.from_numpy(valid)
        pick = ts.draw_sim3_sets(v, 128, torch.Generator().manual_seed(seed))
        return ts.solve_sim3_ransac(torch.from_numpy(X1), torch.from_numpy(X2), v, pick, **kw)

    def test_recovers_similarity(self):
        X1, X2, s_gt, R_gt, t_gt = _make()
        res = self._solve(X1, X2, np.ones(len(X1), bool), 0)
        assert bool(res.success)
        assert abs(float(res.s) - s_gt) < 0.02
        assert _angle_deg(res.R.numpy(), R_gt) < 0.5
        assert np.linalg.norm(res.t.numpy() - t_gt) < 0.05
        assert int(res.n_inliers) >= 70

    def test_fixed_scale_mode(self):
        X1, X2, _, _, _ = _make(seed=1, s_gt=1.0, outlier_frac=0.1)
        res = self._solve(X1, X2, np.ones(len(X1), bool), 1, fix_scale=True)
        assert bool(res.success)
        assert float(res.s) == 1.0

    def test_too_few_inliers_fails(self):
        rng = np.random.default_rng(2)
        X1 = rng.uniform(-3, 3, (60, 3)).astype(np.float32)
        X2 = rng.uniform(-3, 3, (60, 3)).astype(np.float32)
        assert not bool(self._solve(X1, X2, np.ones(60, bool), 2).success)

    def test_draw_stays_in_the_valid_range(self):
        valid = torch.zeros(50, dtype=torch.bool)
        valid[[3, 7, 11, 40]] = True
        pick = ts.draw_sim3_sets(valid, 4096, torch.Generator().manual_seed(3))
        assert pick.dtype == torch.int64 and pick.shape == (4096, 3)
        assert int(pick.min()) == 0 and int(pick.max()) == 3
        assert int(ts.draw_sim3_sets(torch.zeros(5, dtype=torch.bool), 8, torch.Generator()).max()) == 0


@pytest.mark.parametrize("seed,fix_scale,masked", [(0, False, False), (1, True, False), (4, False, True)])
def test_ransac_parity_with_reference_draw(seed, fix_scale, masked):
    X1, X2, _, _, _ = _make(seed=seed, s_gt=1.0 if fix_scale else 1.4)
    valid = np.ones(len(X1), bool)
    if masked:
        valid[np.random.default_rng(seed).random(len(X1)) < 0.3] = False
    key = jax.random.PRNGKey(seed)
    ref = js.solve_sim3_ransac(jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(valid), key, fix_scale=fix_scale)
    got = ts.solve_sim3_ransac(torch.from_numpy(X1), torch.from_numpy(X2), torch.from_numpy(valid),
                               _ref_pick(key, valid), fix_scale=fix_scale)
    assert bool(ref.success) == bool(got.success)
    assert int(ref.n_inliers) == int(got.n_inliers)
    np.testing.assert_array_equal(np.asarray(ref.inliers), got.inliers.numpy())
    for a, b in [(ref.s, got.s), (ref.R, got.R), (ref.t, got.t)]:
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4)


def _refine_case(seed=7, n=120):
    rng = np.random.default_rng(seed)
    X1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 9, n)], -1).astype(np.float32)
    s_gt = 1.25
    R_gt = np.asarray(jg.so3_exp(jnp.asarray(np.array([0.1, -0.2, 0.15], np.float32))))
    t_gt = np.array([0.4, -0.2, 0.6], np.float32)
    X2 = (s_gt * X1 @ R_gt.T + t_gt).astype(np.float32)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    uv1 = np.stack([fx * X1[:, 0] / X1[:, 2] + cx, fy * X1[:, 1] / X1[:, 2] + cy], -1) + rng.normal(0, 0.3, (n, 2))
    uv2 = np.stack([fx * X2[:, 0] / X2[:, 2] + cx, fy * X2[:, 1] / X2[:, 2] + cy], -1) + rng.normal(0, 0.3, (n, 2))
    xi = np.r_[rng.normal(0, 0.05, 6), 0.05].astype(np.float32)
    s0, R0, t0 = jg.sim3_retract(jnp.asarray(s_gt, jnp.float32), jnp.asarray(R_gt), jnp.asarray(t_gt), jnp.asarray(xi))
    return (np.float32(s0), np.array(R0), np.array(t0), X1, X2, uv1.astype(np.float32), uv2.astype(np.float32),
            (fx, fy, cx, cy), (s_gt, R_gt, t_gt))


class TestSim3Refine:
    """Mirrors tests/test_sim3_posegraph.py::TestSim3Refine on the port."""

    def test_reproj_refinement_tightens_ransac_estimate(self):
        s0, R0, t0, X1, X2, uv1, uv2, K, (s_gt, R_gt, t_gt) = _refine_case()
        T = torch.from_numpy
        s, R, t, inl, n_inl = ts.refine_sim3_reproj(T(np.asarray(s0)), T(R0), T(t0), T(X1), T(X2), T(uv1), T(uv2),
                                                     torch.ones(len(X1), dtype=torch.bool), *K, iters=12)
        assert abs(float(s) - s_gt) < 0.01
        assert _angle_deg(R.numpy(), R_gt) < 0.3
        assert np.linalg.norm(t.numpy() - t_gt) < 0.03
        assert int(n_inl) > 100


@pytest.mark.parametrize("fix_scale,iters", [(False, 10), (False, 3), (True, 10)])
def test_refine_parity(fix_scale, iters):
    s0, R0, t0, X1, X2, uv1, uv2, K, _ = _refine_case(seed=8)
    valid = np.random.default_rng(8).random(len(X1)) > 0.1
    args_j = [jnp.asarray(a) for a in (s0, R0, t0, X1, X2, uv1, uv2, valid)]
    args_t = [torch.from_numpy(np.asarray(a)) for a in (s0, R0, t0, X1, X2, uv1, uv2, valid)]
    ref = js.refine_sim3_reproj(*args_j, *K, iters=iters, fix_scale=fix_scale)
    got = ts.refine_sim3_reproj(*args_t, *K, iters=iters, fix_scale=fix_scale)
    for a, b in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-3)
    np.testing.assert_array_equal(np.asarray(ref[3]), got[3].numpy())
    assert int(ref[4]) == int(got[4])
    if fix_scale:
        assert float(got[0]) == float(s0)
