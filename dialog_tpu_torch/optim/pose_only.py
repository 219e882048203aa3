"""Motion-only bundle adjustment (port of ``dialog_tpu/optim/pose_only.py``).

Rounds of LM iterations on unary SE3-projection edges with Huber weights and
chi2 inlier re-classification between rounds (reference:
``Optimizer::PoseOptimization``). Observations are weighted by the detection
octave's information (1/sigma^2). Monocular (u, v) edges only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import geometry as geo
from .lm import huber_weight, lm_loop


class PoseOptResult(NamedTuple):
    R: torch.Tensor          # f32[3, 3]
    t: torch.Tensor          # f32[3]
    inlier: torch.Tensor     # bool[N] final chi2 classification
    n_inliers: torch.Tensor  # i32
    cost: torch.Tensor       # f32 final robust cost


def _residual_rows(R, t, X, uv, fx, fy, cx, cy):
    uv_hat, z, J, _ = geo.project_jacobians(R, t, X, fx, fy, cx, cy)
    return uv_hat - uv, J, z


def _system(R, t, X, uv, w_obs, valid, fx, fy, cx, cy, delta2):
    r, J, z = _residual_rows(R, t, X, uv, fx, fy, cx, cy)
    ok = valid & (z > 1e-3)
    chi2 = torch.sum(r * r, -1) * w_obs
    w = torch.where(ok, w_obs * huber_weight(chi2, delta2), 0.0)
    rho = torch.where(
        chi2 <= delta2, chi2, 2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2
    )
    cost = torch.sum(torch.where(ok, rho, 0.0))
    H = torch.einsum("nki,n,nkj->ij", J, w, J)
    g = torch.einsum("nki,n,nk->i", J, w, r)
    return cost, H, g


def pose_optimization(R0, t0, X, uv, inv_sigma2, valid, fx, fy, cx, cy,
                      chi2_th: float = 5.991, rounds: int = 4, iters: int = 10) -> PoseOptResult:
    """Optimize T_cw against fixed 3D points; returns pose + inlier set."""
    R, t, inlier = geo.orthogonalize(R0), t0, valid
    cost = torch.zeros((), dtype=torch.float32, device=R0.device)
    for _ in range(rounds):
        R = geo.orthogonalize(R)
        base = inlier

        def cas(x, base=base):
            return _system(x[0], x[1], X, uv, inv_sigma2, base, fx, fy, cx, cy, chi2_th)

        def retract(x, dx):
            return geo.se3_retract(x[0], x[1], dx)

        (R, t), cost = lm_loop(cas, retract, (R, t), iters)
        r, _, z = _residual_rows(R, t, X, uv, fx, fy, cx, cy)
        chi2 = torch.sum(r * r, -1) * inv_sigma2
        inlier = valid & (z > 1e-3) & (chi2 <= chi2_th)
    return PoseOptResult(
        R=R, t=t, inlier=inlier,
        n_inliers=torch.sum(inlier.to(torch.int32)), cost=cost,
    )
