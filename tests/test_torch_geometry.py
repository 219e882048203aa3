"""Parity of the port's geometry with ``dialog_tpu.geometry`` on seeded inputs.

Tolerance: f32 formulas evaluated in a different op order, 1e-5 absolute on
rotations/points of unit scale (1e-3 on pixel coordinates). SVD-based
alignment compares the resulting (s, R, t), never U and V, whose signs
differ between backends.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dialog_tpu import geometry as jg
from dialog_tpu_torch import geometry as tg

torch.set_num_threads(2)
ATOL = 1e-5
FX, FY, CX, CY = 500.0, 505.0, 320.0, 240.0


def _rng(seed):
    return np.random.default_rng(seed)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b, atol=atol, rtol=0)


def _poses(seed, n=16, scale=1.0):
    xi = (_rng(seed).normal(size=(n, 6)) * scale).astype(np.float32)
    return xi


@pytest.mark.parametrize("scale", [1e-6, 0.3, 2.5])
def test_so3_exp_log(scale):
    phi = (_rng(1).normal(size=(32, 3)) * scale).astype(np.float32)
    Rj = jg.so3_exp(jnp.asarray(phi))
    Rt = tg.so3_exp(torch.from_numpy(phi))
    _close(Rj, Rt)
    _close(jg.so3_log(Rj), tg.so3_log(Rt), atol=1e-4)
    _close(jg.hat(jnp.asarray(phi)), tg.hat(torch.from_numpy(phi)))
    _close(jg.vee(Rj), tg.vee(Rt))


def test_so3_log_near_pi():
    axis = _rng(2).normal(size=(8, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    phi = (axis * (np.pi - 1e-4)).astype(np.float32)
    Rj = jg.so3_exp(jnp.asarray(phi))
    got = tg.so3_log(torch.from_numpy(np.array(Rj)))
    _close(jg.so3_log(Rj), got, atol=1e-3)


def test_se3_exp_log_compose_retract():
    xi = _poses(3, scale=0.5)
    Rj, tj = jg.se3_exp(jnp.asarray(xi))
    Rt, tt = tg.se3_exp(torch.from_numpy(xi))
    _close(Rj, Rt)
    _close(tj, tt)
    _close(jg.se3_log(Rj, tj), tg.se3_log(Rt, tt), atol=1e-4)
    for a, b in zip(jg.se3_inv(Rj, tj), tg.se3_inv(Rt, tt)):
        _close(a, b)
    for a, b in zip(jg.se3_compose(Rj, tj, Rj[::-1], tj[::-1]), tg.se3_compose(Rt, tt, Rt.flip(0), tt.flip(0))):
        _close(a, b)
    d = _poses(4, scale=0.05)
    for a, b in zip(jg.se3_retract(Rj, tj, jnp.asarray(d)), tg.se3_retract(Rt, tt, torch.from_numpy(d))):
        _close(a, b)
    noisy = np.asarray(Rj) + _rng(5).normal(size=(16, 3, 3)).astype(np.float32) * 1e-3
    _close(jg.orthogonalize(jnp.asarray(noisy)), tg.orthogonalize(torch.from_numpy(noisy)))


def _scene(seed, n=64):
    rng = _rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1).astype(np.float32)
    R, t = jg.se3_exp(jnp.asarray((rng.normal(size=6) * 0.1).astype(np.float32)))
    return X, np.array(R), np.array(t)


def test_project_and_jacobians():
    X, R, t = _scene(6)
    uvj, zj = jg.project(jnp.asarray(R), jnp.asarray(t), jnp.asarray(X), FX, FY, CX, CY)
    uvt, zt = tg.project(torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(X), FX, FY, CX, CY)
    _close(uvj, uvt, atol=1e-3)
    _close(zj, zt)
    ref = jg.project_jacobians(jnp.asarray(R), jnp.asarray(t), jnp.asarray(X), FX, FY, CX, CY)
    got = tg.project_jacobians(torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(X), FX, FY, CX, CY)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5, atol=1e-3)


def test_backproject_and_undistort():
    rng = _rng(7)
    uv = rng.uniform(0, 640, (50, 2)).astype(np.float32)
    z = rng.uniform(1, 5, 50).astype(np.float32)
    _close(jg.backproject(jnp.asarray(uv), jnp.asarray(z), FX, FY, CX, CY),
           tg.backproject(torch.from_numpy(uv), torch.from_numpy(z), FX, FY, CX, CY), atol=1e-4)
    k = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)
    _close(jg.undistort_points(jnp.asarray(uv), FX, FY, CX, CY, *k),
           tg.undistort_points(torch.from_numpy(uv), FX, FY, CX, CY, *k), atol=1e-3)


def test_triangulate_linear():
    X, R, t = _scene(8)
    Xc2 = X @ R.T + t
    x1 = X[:, :2] / X[:, 2:]
    x2 = (Xc2[:, :2] / Xc2[:, 2:]).astype(np.float32)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    a = jg.triangulate_linear(jnp.asarray(eye), jnp.asarray(zero), jnp.asarray(R), jnp.asarray(t),
                              jnp.asarray(x1), jnp.asarray(x2))
    b = tg.triangulate_linear(torch.from_numpy(eye), torch.from_numpy(zero), torch.from_numpy(R),
                              torch.from_numpy(t), torch.from_numpy(x1), torch.from_numpy(x2))
    # the 3x3 normal equations of the DLT amplify f32 op-order differences
    # (condition ~1e4 at this baseline): 2e-3 on points ~8 m away
    _close(a, b, atol=2e-3)
    np.testing.assert_allclose(b.numpy(), X, atol=2e-3)


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_alignment(with_scale):
    rng = _rng(9)
    src = rng.normal(size=(40, 3)).astype(np.float32)
    R, _ = jg.se3_exp(jnp.asarray(rng.normal(size=6).astype(np.float32)))
    dst = (1.7 * src @ np.array(R).T + np.array([0.3, -1.0, 2.0])).astype(np.float32)
    dst += rng.normal(size=dst.shape).astype(np.float32) * 1e-3
    w = rng.uniform(0.5, 1.5, 40).astype(np.float32)
    sj, Rj, tj = jg.umeyama_alignment(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), with_scale)
    st, Rt, tt = tg.umeyama_alignment(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w), with_scale)
    assert abs(float(sj) - float(st)) < 1e-4
    _close(Rj, Rt, atol=1e-4)
    _close(tj, tt, atol=1e-4)


# --- Sim3 and quaternions -----------------------------------------------------
# Tolerance: 1e-5 on unit-scale rotations, translations and scales; 1e-4 on
# log maps (atan2 and a 3x3 solve in f32); finite differences in float64
# against forward-mode derivatives at 1e-6.


def _sim3_xi(seed, n=24, rot=0.8, sig=0.4):
    rng = _rng(seed)
    xi = np.concatenate([rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * rot, rng.normal(size=(n, 1)) * sig], -1)
    return xi.astype(np.float32)


# the branches of _sim3_W: general, sigma near 0, theta near 0, both
BRANCHES = {"general": (0.8, 0.4), "small_sigma": (0.8, 1e-7), "small_theta": (1e-6, 0.4), "both_small": (1e-6, 1e-7)}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_sim3_exp_log_W(branch):
    rot, sig = BRANCHES[branch]
    xi = _sim3_xi(11, rot=rot, sig=sig)
    Wj = jg._sim3_W(jnp.asarray(xi[:, 3:6]), jnp.asarray(xi[:, 6]))
    Wt = tg._sim3_W(torch.from_numpy(xi[:, 3:6]), torch.from_numpy(xi[:, 6]))
    _close(Wj, Wt)
    sj, Rj, tj = jg.sim3_exp(jnp.asarray(xi))
    st, Rt, tt = tg.sim3_exp(torch.from_numpy(xi))
    for a, b in [(sj, st), (Rj, Rt), (tj, tt)]:
        _close(a, b)
    _close(jg.sim3_log(sj, Rj, tj), tg.sim3_log(st, Rt, tt), atol=1e-4)
    # round trip
    _close(xi, tg.sim3_log(st, Rt, tt), atol=1e-4)


def test_sim3_apply_inv_compose_retract():
    xa, xb = _sim3_xi(12), _sim3_xi(13)
    A = [jg.sim3_exp(jnp.asarray(xa)), tg.sim3_exp(torch.from_numpy(xa))]
    B = [jg.sim3_exp(jnp.asarray(xb)), tg.sim3_exp(torch.from_numpy(xb))]
    X = _rng(14).normal(size=(24, 3)).astype(np.float32)
    _close(jg.sim3_apply(*A[0], jnp.asarray(X)), tg.sim3_apply(*A[1], torch.from_numpy(X)))
    for a, b in zip(jg.sim3_inv(*A[0]), tg.sim3_inv(*A[1])):
        _close(a, b, atol=1e-4)
    for a, b in zip(jg.sim3_compose(*A[0], *B[0]), tg.sim3_compose(*A[1], *B[1])):
        _close(a, b, atol=1e-4)
    d = _sim3_xi(15, rot=0.05, sig=0.05) * 0.1
    for a, b in zip(jg.sim3_retract(*A[0], jnp.asarray(d)), tg.sim3_retract(*A[1], torch.from_numpy(d))):
        _close(a, b, atol=1e-4)


def test_sim3_retract_jacobian_at_zero():
    """Forward-mode derivatives of sim3_retract at zero (torch.func.jacfwd, on
    a batch of one so no intermediate is 0-d, and the port's own
    optim.lm.jacobian_at_zero) against central finite differences in float64."""
    from torch.func import jacfwd

    from dialog_tpu_torch.optim.lm import jacobian_at_zero

    s, R, t = tg.sim3_exp(torch.from_numpy(_sim3_xi(16, n=1)).double())

    def flat(xi):
        s2, R2, t2 = tg.sim3_retract(s, R, t, xi)
        return torch.cat([s2[..., None], R2.reshape(R2.shape[:-2] + (9,)), t2], -1)

    J = jacfwd(flat)(torch.zeros(1, 7, dtype=torch.float64))[0, :, 0, :]          # [13, 7]
    eps = 1e-6
    fd = torch.stack([(flat(torch.eye(7, dtype=torch.float64)[k:k + 1] * eps)
                       - flat(-torch.eye(7, dtype=torch.float64)[k:k + 1] * eps))[0] / (2 * eps) for k in range(7)], -1)
    np.testing.assert_allclose(J.numpy(), fd.numpy(), atol=1e-6)
    (_, J2), = jacobian_at_zero(lambda x: (flat(x[:, None, :])[:, 0],), 7, (), R)
    np.testing.assert_allclose(J2.numpy(), fd.numpy(), atol=1e-6)


def test_quaternions():
    rng = _rng(17)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q2 = rng.normal(size=(32, 4)).astype(np.float32)
    _close(jg.quat_normalize(jnp.asarray(q)), tg.quat_normalize(torch.from_numpy(q)))
    _close(jg.quat_mul(jnp.asarray(q), jnp.asarray(q2)), tg.quat_mul(torch.from_numpy(q), torch.from_numpy(q2)),
           atol=1e-4)
    _close(jg.quat_to_mat(jnp.asarray(q)), tg.quat_to_mat(torch.from_numpy(q)))
    # every Shepperd branch: rotations by up to pi about random axes, and the coordinate axes at pi
    phi = _sim3_xi(18, n=64, rot=1.5)[:, 3:6]
    Rs = np.concatenate([np.array(jg.so3_exp(jnp.asarray(phi))),
                         np.stack([np.diag(d) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])]).astype(np.float32)])
    qj = jg.mat_to_quat(jnp.asarray(Rs))
    qt = tg.mat_to_quat(torch.from_numpy(Rs))
    _close(qj, qt)
    _close(Rs, tg.quat_to_mat(qt), atol=1e-5)
