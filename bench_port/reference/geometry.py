"""Projection, its Jacobians and SE(3) updates, in plain PyTorch at a chosen precision.

Poses are world->camera (R, t); a pose update is the left-multiplicative
twist xi = (rho, phi): T <- exp(xi) o T. Observations are (u, v), or (u, v, uR)
with uR = u - bf / z where the observation carries a right-x (uR >= 0).
"""

from __future__ import annotations

import torch

from .precision import mm


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _eye(like, n=3):
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(like.shape[:-2] + (n, n))


def so3_exp(phi, mode):
    theta2 = torch.sum(phi * phi, -1)
    theta = torch.sqrt(theta2 + 1e-16)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(phi)
    return _eye(W) + a[..., None, None] * W + b[..., None, None] * mm(W, W, mode)


def _left_jacobian(phi, mode):
    theta2 = torch.sum(phi * phi, -1)
    theta = torch.sqrt(theta2 + 1e-16)
    small = theta2 < 1e-8
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta))
    W = hat(phi)
    return _eye(W) + a[..., None, None] * W + b[..., None, None] * mm(W, W, mode)


def se3_retract(R, t, xi, mode):
    dR = so3_exp(xi[..., 3:], mode)
    dt = mm(_left_jacobian(xi[..., 3:], mode), xi[..., :3, None], mode)[..., 0]
    return mm(dR, R, mode), mm(dR, t[..., None], mode)[..., 0] + dt


def orthogonalize(R, mode):
    eye = _eye(R)
    for _ in range(2):
        R = mm(R, 1.5 * eye - 0.5 * mm(R.transpose(-1, -2), R, mode), mode)
    return R


def transform(R, t, X, mode):
    return mm(R, X[..., None], mode)[..., 0] + t


def reprojection(R, t, X, obs, cam, mode, u_right=None):
    """(r [..., D], z, J_pose [..., D, 6], J_point [..., D, 3]) with D = 2, or
    3 given ``u_right`` (its row zero where u_right < 0)."""
    fx, fy, cx, cy, bf = cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam.get("bf", 0.0)
    Xc = transform(R, t, X, mode)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    inv_z2 = inv_z * inv_z
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    zero = torch.zeros_like(x)
    rows = [torch.stack([fx * inv_z, zero, -fx * x * inv_z2], -1), torch.stack([zero, fy * inv_z, -fy * y * inv_z2], -1)]
    pred = [u, v]
    if u_right is not None:
        rows.append(torch.stack([fx * inv_z, zero, -fx * x * inv_z2 + bf * inv_z2], -1))
        pred.append(u - bf * inv_z)
        obs = torch.cat([obs, u_right[..., None]], -1)
    J_proj = torch.stack(rows, -2)
    J_pose = mm(J_proj, torch.cat([_eye(J_proj.new_zeros(Xc.shape + (3,))), -hat(Xc)], -1), mode)
    J_point = mm(J_proj, R, mode)
    r = torch.stack(pred, -1) - obs
    if u_right is not None:
        mono = (torch.arange(3, device=r.device) == 2) & (u_right < 0.0)[..., None]
        r = torch.where(mono, 0.0, r)
        J_pose = torch.where(mono[..., None], 0.0, J_pose)
        J_point = torch.where(mono[..., None], 0.0, J_point)
    return r, z, J_pose, J_point


def huber(chi2, delta2):
    """(IRLS weight, robust cost) of the Huber loss on chi2."""
    safe = torch.clamp(chi2, min=1e-12)
    w = torch.where(chi2 <= delta2, torch.ones_like(chi2), torch.sqrt(delta2 / safe))
    rho = torch.where(chi2 <= delta2, chi2, 2.0 * torch.sqrt(delta2 * safe) - delta2)
    return w, rho
