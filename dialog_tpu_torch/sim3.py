"""Batched Sim3 estimation with RANSAC, and its image-space refinement
(port of ``dialog_tpu/sim3.py``).

Horn/Umeyama's closed-form similarity from 3 correspondences inside RANSAC:
every hypothesis is solved (one batched 3x3 SVD) and scored (one [iters, N]
residual matrix) at once, the best one refit on its inliers by a weighted
Umeyama, then refined by damped Gauss-Newton on bidirectional reprojection
edges (``refine_sim3_reproj``). ``fix_scale`` is the stereo/RGB-D mode,
where the scale is known to be 1.

The minimal sets are an argument (``pick``, indices into the valid
correspondences, ``draw_sim3_sets``), so the caller's generator owns the
randomness. An SVD's singular vectors come back with either sign and
degenerate (collinear) sets are resolved differently by different f32
solvers: what two implementations share is the refit and refined
similarity, never a single hypothesis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as geo
from . import ops
from .optim.lm import huber_weight, jacobian_at_zero


class Sim3Result(NamedTuple):
    success: torch.Tensor    # bool
    s: torch.Tensor          # f32 scalar
    R: torch.Tensor          # f32[3, 3]
    t: torch.Tensor          # f32[3]
    inliers: torch.Tensor    # bool[N]
    n_inliers: torch.Tensor  # i32


def _det_sign_fix(U, Vt):
    """diag(1, 1, sign(det U det Vt)) as its diagonal [..., 3]: the
    reflection fix of Umeyama's rotation."""
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    return torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)


def _umeyama_batch(src, dst, with_scale: bool):
    """Batched Umeyama over [..., M, 3] point sets -> (s, R, t)."""
    mu_s = src.mean(dim=-2, keepdim=True)
    mu_d = dst.mean(dim=-2, keepdim=True)
    sc = src - mu_s
    dc = dst - mu_d
    cov = torch.einsum("...mi,...mj->...ij", dc, sc) / src.shape[-2]
    U, S, Vt = torch.linalg.svd(cov)
    Dv = _det_sign_fix(U, Vt)
    R = U @ (Dv[..., :, None] * Vt)
    var_s = torch.sum(sc * sc, dim=-1).mean(dim=-1)
    if with_scale:
        s = torch.sum(S * Dv, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones_like(var_s)
    t = mu_d[..., 0, :] - s[..., None] * geo._mv(R, mu_s[..., 0, :])
    return s, R, t


def draw_sim3_sets(valid: torch.Tensor, iters: int, generator: torch.Generator) -> torch.Tensor:
    """Random minimal sets i64[iters, 3]: indices into the valid
    correspondences, uniform over [0, max(n_valid, 1)). Drawn on the
    generator's device as uniform floats scaled by the valid count there, so
    the draw reads nothing back to the host."""
    n = torch.clamp(valid.sum(), min=1).to(generator.device)
    u = torch.rand((iters, 3), generator=generator, device=generator.device)
    pick = torch.minimum((u * n).to(torch.int64), n - 1)
    return pick.to(valid.device)


def _reproj_residuals(xi, s, R, t, X1, X2, uv1, uv2, valid, fx, fy, cx, cy):
    """Residuals of the similarity exp(xi) o (s, R, t): pi(S21 X1) - uv2 and
    pi(S21^-1 X2) - uv1 ([..., N, 2] each, over xi's leading axes), and the
    edges in front of both cameras."""
    s2, R2, t2 = geo.sim3_retract(s, R, t, xi)
    Xf = geo.sim3_apply(s2[..., None], R2[..., None, :, :], t2[..., None, :], X1)
    si, Ri, ti = geo.sim3_inv(s2, R2, t2)
    Xb = geo.sim3_apply(si[..., None], Ri[..., None, :, :], ti[..., None, :], X2)

    def pix(X, uv):
        z = X[..., 2]
        z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        return torch.stack([fx * X[..., 0] / z + cx - uv[:, 0], fy * X[..., 1] / z + cy - uv[:, 1]], -1)

    ok = valid & (Xf[..., 2] > 1e-3) & (Xb[..., 2] > 1e-3)
    return pix(Xf, uv2), pix(Xb, uv1), ok


def refine_sim3_reproj(s0, R0, t0, X1, X2, uv1, uv2, valid, fx: float, fy: float, cx: float, cy: float,
                       iters: int = 10, fix_scale: bool = False, chi2_th: float = 9.21):
    """Image-space Sim3 refinement with bidirectional reprojection edges
    (reference: ``Optimizer::OptimizeSim3``, Huber-weighted). X1, X2 f32[N, 3]
    camera-frame points at the two ends, uv1, uv2 f32[N, 2] their observed
    pixels. 7-dof damped Gauss-Newton; the [N, 2, 7] Jacobians are forward-mode
    derivatives of the residuals at zero perturbation
    (``optim.lm.jacobian_at_zero``). A step is kept where the robust cost falls; the loop runs
    ``iters`` times with no host read. Returns (s, R, t, inliers bool[N],
    n_inliers i32)."""
    dev = X1.device
    zero7 = torch.zeros(7, dtype=X1.dtype, device=dev)
    mask7 = torch.ones(7, dtype=X1.dtype, device=dev)
    if fix_scale:
        mask7[6] = 0.0
    eye7 = torch.eye(7, dtype=X1.dtype, device=dev)
    data = (X1, X2, uv1, uv2, valid, fx, fy, cx, cy)

    def cost(s, R, t):
        rf, rb, ok = _reproj_residuals(zero7, s, R, t, *data)
        return torch.sum(ok * (torch.clamp(torch.sum(rf * rf, -1), max=chi2_th)
                               + torch.clamp(torch.sum(rb * rb, -1), max=chi2_th)))

    s, R, t = s0, R0, t0
    lam = ops.scalar(1e-4, torch.float32, dev)
    for _ in range(iters):
        ok = _reproj_residuals(zero7, s, R, t, *data)[2]
        (rf, Jf), (rb, Jb) = jacobian_at_zero(lambda x: _reproj_residuals(x, s, R, t, *data)[:2], 7, (), X1)
        wf = huber_weight(torch.sum(rf * rf, -1), chi2_th) * ok
        wb = huber_weight(torch.sum(rb * rb, -1), chi2_th) * ok
        H = torch.einsum("nki,n,nkj->ij", Jf, wf, Jf) + torch.einsum("nki,n,nkj->ij", Jb, wb, Jb)
        g = torch.einsum("nki,n,nk->i", Jf, wf, rf) + torch.einsum("nki,n,nk->i", Jb, wb, rb)
        H = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-9)) + 1e-9 * eye7
        dx = -torch.linalg.solve_ex(H, g[:, None], check_errors=False)[0][:, 0] * mask7
        s2, R2, t2 = geo.sim3_retract(s, R, t, dx)
        R2 = geo.orthogonalize(R2)
        better = cost(s2, R2, t2) < cost(s, R, t)
        s, R, t = torch.where(better, s2, s), torch.where(better, R2, R), torch.where(better, t2, t)
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-9, 1e4)
    rf, rb, ok = _reproj_residuals(zero7, s, R, t, *data)
    inl = ok & (torch.sum(rf * rf, -1) < chi2_th) & (torch.sum(rb * rb, -1) < chi2_th)
    return s, R, t, inl, inl.sum(dtype=torch.int32)


def solve_sim3_ransac(X1: torch.Tensor, X2: torch.Tensor, valid: torch.Tensor, pick: torch.Tensor,
                      fix_scale: bool = False, rel_th: float = 0.03, min_inliers: int = 20) -> Sim3Result:
    """Estimate S12: X2 ~ s R X1 + t from f32[N, 3] correspondences, robust
    to outliers. ``pick`` i64[iters, 3] holds each hypothesis' minimal set as
    indices into the valid correspondences (``draw_sim3_sets``). Inlier
    test: residual under ``rel_th`` of the point's distance from the valid
    set's centroid (plus 1), a scale-free gate. The best hypothesis is the
    first with the most inliers (a non-finite one, or one with its scale
    outside (1e-3, 1e3), counts -1); its inliers are refit by a weighted
    Umeyama."""
    N = X1.shape[0]
    vidx = ops.nonzero_fixed(valid, N, 0)
    n_valid = valid.sum(dtype=torch.int32)
    sel = vidx[pick.to(device=X1.device, dtype=torch.int64)]
    s_all, R_all, t_all = _umeyama_batch(X1[sel], X2[sel], not fix_scale)

    pred = s_all[:, None, None] * torch.einsum("hij,nj->hni", R_all, X1) + t_all[:, None, :]
    err = torch.linalg.norm(pred - X2[None], dim=-1)                       # [iters, N]
    centroid = torch.sum(torch.where(valid[:, None], X2, 0.0), dim=0) / torch.clamp(n_valid, min=1)
    depth = torch.linalg.norm(X2 - centroid, dim=-1) + 1.0
    inl = valid[None, :] & (err < rel_th * depth[None, :])
    counts = inl.sum(dim=1, dtype=torch.int32)
    finite = (torch.isfinite(R_all).all(dim=-1).all(dim=-1) & torch.isfinite(t_all).all(dim=-1)
              & torch.isfinite(s_all) & (s_all > 1e-3) & (s_all < 1e3))
    counts = torch.where(finite, counts, -1)
    best = torch.argmax(counts)

    # refit on the best hypothesis' inliers (weighted full Umeyama)
    w = inl[best].to(X1.dtype)
    nw = torch.clamp(w.sum(), min=3.0)
    mu1 = torch.sum(X1 * w[:, None], 0) / nw
    mu2 = torch.sum(X2 * w[:, None], 0) / nw
    dc = (X2 - mu2) * w[:, None]
    cov = dc.T @ (X1 - mu1) / nw
    U, S, Vt = torch.linalg.svd(cov)
    Dv = _det_sign_fix(U, Vt)
    R = U @ (Dv[:, None] * Vt)
    if fix_scale:
        s = torch.ones((), dtype=X1.dtype, device=X1.device)
    else:
        var1 = torch.sum(torch.sum((X1 - mu1) ** 2, -1) * w) / nw
        s = torch.sum(S * Dv) / torch.clamp(var1, min=1e-12)
    t = mu2 - s * (R @ mu1)
    err = torch.linalg.norm(s * X1 @ R.T + t - X2, dim=-1)
    inliers = valid & (err < rel_th * depth)
    n_inl = inliers.sum(dtype=torch.int32)
    return Sim3Result(success=n_inl >= min_inliers, s=s, R=R, t=t, inliers=inliers, n_inliers=n_inl)
