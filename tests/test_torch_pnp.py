"""``dialog_tpu_torch.pnp`` against ``dialog_tpu.pnp`` on the same inputs.

Poses are compared, never eigenvectors: ``eigh`` returns eigenvectors of
either sign, and the 12x12 ``M^T M`` of a minimal set has a near-null space
that two f32 eigensolvers resolve differently.

* Noise-free minimal sets (6 points in general position). The DLT of both
  packages agrees within 2e-3 in R and t on every set (measured: 3e-4 at
  most). EPnP's 12x12 ``M^T M`` is singular on exact data, and where f32
  leaves more than one eigenvalue near zero the two eigensolvers pick
  different vectors of that space: 39 of 48 sets agree within 2e-3, the
  worst is 6e-2 apart. What holds on every set is that the two poses are
  no further apart than 2.5 x the larger of their own errors against the
  true pose; the test holds that, a median below 2e-3 and three quarters of
  the sets within 2e-3.
* Noisy sets (1 px): the N=1 EPnP of six points is ill-conditioned in both
  packages (median error against the truth 0.17, the DLT 0.4), and their
  poses part by up to 0.4 on single sets (median 4e-4); the test holds the
  median difference below 2e-3, the same 2.5 x bound, and both medians to
  the truth within each other's 1.5x.
* ``solve_pnp_ransac`` with the reference's own draws (``pick``): the same
  best hypothesis or one with an equal inlier count, pose within 2e-3 where
  the hypothesis is the same.
* The reference's EPnP-not-worse-than-DLT case on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dialog_tpu import pnp as jp
from dialog_tpu_torch import pnp as tp
from tests.test_pnp import CX, CY, FX, FY, make_case

torch.set_num_threads(2)

TOL = 2e-3


def _minimal_sets(n_sets, noise_px, seed):
    """(X [S, 6, 3], xn [S, 6, 2], R [S, 3, 3], t [S, 3]) from the reference tests' cases."""
    rng = np.random.default_rng(seed)
    Xs, xns, Rs, ts = [], [], [], []
    for s in range(n_sets):
        X, uv, valid, R, t = make_case(seed * 1000 + s, n=40, noise_px=noise_px, outlier_frac=0.0)
        idx = rng.choice(np.nonzero(valid)[0], 6, replace=False)
        Xs.append(X[idx])
        xns.append((uv[idx] - [CX, CY]) / [FX, FY])
        Rs.append(R)
        ts.append(t)
    return (np.stack(Xs).astype(np.float32), np.stack(xns).astype(np.float32), np.stack(Rs), np.stack(ts))


def _both(solver, X, xn):
    ref = getattr(jp, solver)(jnp.asarray(X), jnp.asarray(xn))
    port = getattr(tp, solver)(torch.from_numpy(X), torch.from_numpy(xn))
    return [np.asarray(x) for x in ref], [x.numpy() for x in port]


def _pose_diff(a, b):
    return np.maximum(np.abs(a[0] - b[0]).max((-1, -2)), np.abs(a[1] - b[1]).max(-1))


@pytest.mark.parametrize("solver", ["_epnp_pose", "_dlt_pose"])
def test_minimal_solvers_agree_on_noise_free_sets(solver):
    X, xn, R, t = _minimal_sets(48, 0.0, seed=1)
    ref, port = _both(solver, X, xn)
    diff = _pose_diff(ref, port)
    own = np.maximum(_pose_diff(ref, (R, t)), _pose_diff(port, (R, t)))
    if solver == "_dlt_pose":
        assert diff.max() < TOL, diff
    assert np.median(diff) < TOL and (diff < TOL).mean() >= 0.75, np.sort(diff)
    assert (diff <= 2.5 * own + 1e-4).all(), (diff, own)
    assert np.median(own) < 1e-3
    det = np.linalg.det(port[0])
    np.testing.assert_allclose(det, 1.0, atol=1e-4)
    np.testing.assert_allclose(port[0] @ np.swapaxes(port[0], -1, -2), np.broadcast_to(np.eye(3), port[0].shape),
                               atol=1e-4)


@pytest.mark.parametrize("solver", ["_epnp_pose", "_dlt_pose"])
def test_minimal_solvers_on_noisy_sets(solver):
    X, xn, R, t = _minimal_sets(48, 1.0, seed=2)
    ref, port = _both(solver, X, xn)
    diff = _pose_diff(ref, port)
    err_ref, err_port = _pose_diff(ref, (R, t)), _pose_diff(port, (R, t))
    assert np.median(diff) < TOL, np.sort(diff)
    assert (diff <= 2.5 * np.maximum(err_ref, err_port) + 1e-4).all()
    assert np.median(err_port) < 1.5 * np.median(err_ref) + 1e-3
    assert np.isfinite(port[0]).all() and np.isfinite(port[1]).all()


def test_procrustes_recovers_a_rigid_motion():
    X, _, _, R, t = make_case(7, n=30, noise_px=0.0, outlier_frac=0.0)
    Xc = X @ R.T + t
    Rp, tp_ = tp._procrustes_rigid(torch.from_numpy(X)[None], torch.from_numpy(Xc.astype(np.float32))[None])
    np.testing.assert_allclose(Rp[0].numpy(), R, atol=1e-5)
    np.testing.assert_allclose(tp_[0].numpy(), t, atol=1e-4)
    Rj, tj = jp._procrustes_rigid(jnp.asarray(X)[None], jnp.asarray(Xc.astype(np.float32))[None])
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tp_.numpy(), np.asarray(tj), atol=1e-4)


def _reference_pick(key, valid, iters):
    """The minimal sets the reference draws inside ``solve_pnp_ransac``."""
    n_valid = max(int(valid.sum()), 1)
    return np.asarray(jax.random.randint(key, (iters, 6), 0, n_valid))


@pytest.mark.parametrize("solver", ["epnp", "dlt"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ransac_with_the_reference_draws(solver, seed):
    X, uv, valid, R_gt, t_gt = make_case(seed, noise_px=0.5, outlier_frac=0.3)
    key = jax.random.PRNGKey(seed)
    ref = jp.solve_pnp_ransac(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), FX, FY, CX, CY, key, iters=64,
                              solver=solver)
    pick = torch.from_numpy(_reference_pick(key, valid, 64).copy())
    port = tp.solve_pnp_ransac(torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(valid), FX, FY, CX, CY,
                               pick, solver=solver)
    assert bool(port.success) == bool(ref.success)
    # f32 moves a point across the chi2 gate now and then: the counts agree within 2
    assert abs(int(port.n_inliers) - int(ref.n_inliers)) <= 2
    assert int(port.inliers.sum()) == int(port.n_inliers)
    same = (port.inliers.numpy() != np.asarray(ref.inliers)).sum() <= 2
    if same:
        assert np.abs(port.R.numpy() - np.asarray(ref.R)).max() < TOL
        assert np.abs(port.t.numpy() - np.asarray(ref.t)).max() < 5 * TOL
    dR = port.R.numpy() @ R_gt.T
    assert np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))) < 5.0


def test_ransac_without_valid_points_fails_cleanly():
    X, uv, valid, _, _ = make_case(0)
    none = np.zeros_like(valid)
    gen = torch.Generator().manual_seed(0)
    pick = tp.draw_pnp_sets(torch.from_numpy(none), 16, gen)
    assert pick.shape == (16, 6) and int(pick.max()) == 0
    res = tp.solve_pnp_ransac(torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(none), FX, FY, CX, CY, pick)
    assert not bool(res.success) and int(res.n_inliers) <= 0
    pick = tp.draw_pnp_sets(torch.from_numpy(valid), 16, gen)
    assert int(pick.max()) < int(valid.sum()) and pick.dtype == torch.int64


def _run_solver(solver, n_trials=30, iters=128):
    ok, rot_err, t_err = 0, [], []
    gen = torch.Generator().manual_seed(0)
    for s in range(n_trials):
        X, uv, valid, R_gt, t_gt = make_case(s)
        v = torch.from_numpy(valid)
        res = tp.solve_pnp_ransac(torch.from_numpy(X), torch.from_numpy(uv), v, FX, FY, CX, CY,
                                  tp.draw_pnp_sets(v, iters, gen), solver=solver)
        if bool(res.success):
            dR = res.R.numpy() @ R_gt.T
            ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
            if ang < 5.0:
                ok += 1
                rot_err.append(ang)
                t_err.append(np.linalg.norm(res.t.numpy() - t_gt))
    return ok, (np.median(rot_err) if rot_err else np.inf), (np.median(t_err) if t_err else np.inf)


def test_epnp_not_worse_than_dlt():
    """The reference's equal-iteration A/B on noisy 30%-outlier cases
    (``tests/test_pnp.py``), on the port with its own draws."""
    ok_e, rot_e, te_e = _run_solver("epnp")
    ok_d, rot_d, te_d = _run_solver("dlt")
    assert ok_e >= ok_d, (ok_e, ok_d)
    assert rot_e <= rot_d * 1.5 + 0.1, (rot_e, rot_d)
    assert te_e <= te_d * 1.5 + 0.01, (te_e, te_d)
