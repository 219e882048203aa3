"""Plain reference of motion-only bundle adjustment (the tracking step's pose).

Rounds of damped Gauss-Newton (Levenberg-Marquardt: accept when the robust
cost falls, damping x0.5 on accept and x4 on reject, from 1e-3) on unary
reprojection edges with Huber weights, each observation weighted by its
octave's information, and between rounds the chi2 re-classification of
inliers. With stereo rows, an observation that carries a right-x has three
residual rows (g2o's EdgeStereoSE3ProjectXYZOnlyPose).
"""

from __future__ import annotations

import torch

from . import geometry as geo
from .precision import dtype, einsum


def _system(R, t, X, uv, u_right, w_obs, base, cam, delta2, mode):
    r, z, J, _ = geo.reprojection(R, t, X, uv, cam, mode, u_right)
    ok = base & (z > 1e-3)
    chi2 = torch.sum(r * r, -1) * w_obs
    hw, rho = geo.huber(chi2, delta2)
    w = torch.where(ok, w_obs * hw, 0.0)
    cost = torch.sum(torch.where(ok, rho, 0.0))
    return cost, einsum("nki,n,nkj->ij", J, w, J, mode=mode), einsum("nki,n,nk->i", J, w, r, mode=mode)


def _lm(R, t, X, uv, u_right, w_obs, base, cam, chi2_th, iters, mode):
    dt = dtype(mode)
    eye = torch.eye(6, dtype=dt, device=R.device)
    cost, H, g = _system(R, t, X, uv, u_right, w_obs, base, cam, chi2_th, mode)
    lam = torch.tensor(1e-3, dtype=dt, device=R.device)
    for _ in range(iters):
        Hd = H + lam * eye * torch.clamp(torch.diagonal(H), min=1e-9)
        dx = -torch.linalg.solve_ex(Hd, g[:, None], check_errors=False)[0][:, 0]
        R2, t2 = geo.se3_retract(R, t, dx, mode)
        c2, H2, g2 = _system(R2, t2, X, uv, u_right, w_obs, base, cam, chi2_th, mode)
        accept = (c2 < cost) & torch.isfinite(R2).all() & torch.isfinite(t2).all()
        R, t = torch.where(accept, R2, R), torch.where(accept, t2, t)
        H, g = torch.where(accept, H2, H), torch.where(accept, g2, g)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        cost = torch.where(accept, c2, cost)
    return R, t


def pose_optimization(R0, t0, X, uv, inv_sigma2, valid, cam, chi2_th, rounds, iters, u_right=None, mode="f64"):
    """Returns (R, t, inlier, base) from the same inputs as the program's step; ``base`` is the
    inlier set the last round optimized over."""
    dt = dtype(mode)
    R0, t0, X, uv, w_obs = (a.to(dt) for a in (R0, t0, X, uv, inv_sigma2))
    u_right = None if u_right is None else u_right.to(dt)
    R, t, inlier = geo.orthogonalize(R0, mode), t0, valid
    base = inlier
    for _ in range(rounds):
        R = geo.orthogonalize(R, mode)
        base = inlier
        R, t = _lm(R, t, X, uv, u_right, w_obs, base, cam, chi2_th, iters, mode)
        r, z, _, _ = geo.reprojection(R, t, X, uv, cam, mode, u_right)
        inlier = valid & (z > 1e-3) & (torch.sum(r * r, -1) * w_obs <= chi2_th)
    return R, t, inlier, base


def settled(R, t, X, uv, inv_sigma2, base, cam, chi2_th, u_right=None, iters: int = 10) -> float:
    """How far (px, ``pose_px``) ten more float64 iterations on ``base`` move the pose (R, t):
    near 0 where the step's own budget converged."""
    X64, uv64, w64 = X.double(), uv.double(), inv_sigma2.double()
    ur = None if u_right is None else u_right.double()
    R2, t2 = _lm(R.double(), t.double(), X64, uv64, ur, w64, base, cam, chi2_th, iters, "f64")
    return pose_px(R, t, R2, t2, X, base, cam)


def pose_px(R_a, t_a, R_b, t_b, X, valid, cam) -> float:
    """Largest pixel distance between two poses' projections of the valid points (float64)."""
    if not bool(valid.any()):
        return 0.0
    X = X[valid].to(torch.float64)

    def proj(R, t):
        Xc = X @ R.to(torch.float64).T + t.to(torch.float64)
        return torch.stack([cam["fx"] * Xc[:, 0] / Xc[:, 2], cam["fy"] * Xc[:, 1] / Xc[:, 2]], -1)

    return float(torch.linalg.norm(proj(R_a, t_a) - proj(R_b, t_b), dim=-1).max())
