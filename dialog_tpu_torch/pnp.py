"""Batched EPnP RANSAC for relocalization (port of ``dialog_tpu/pnp.py``).

Every hypothesis is solved and scored at once: the 12x12 eigensystems of
all minimal sets are one batched ``torch.linalg.eigh``, and the inlier census
is one [iters, N] reprojection matrix.

The minimal solver is EPnP (4 control points from the PCA frame, barycentric
coordinates, the M^T M eigenvector of the smallest eigenvalue, the
distance-ratio beta of the N=1 case) followed by a Procrustes rigid fit from
world to camera-frame points. A 6-point DLT is the ``solver="dlt"``
alternative. Eigenvectors come back with either sign, and the near-null
space of M^T M is resolved differently by different f32 eigensolvers; the
sign is settled by cheirality, and what is comparable between two
implementations is the pose, not the eigenvector.

The minimal sets are an argument (``pick``, indices into the valid points,
``draw_pnp_sets``), so the caller's generator owns the randomness.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import ops


class PnPResult(NamedTuple):
    success: torch.Tensor    # bool
    R: torch.Tensor          # f32[3, 3]
    t: torch.Tensor          # f32[3]
    inliers: torch.Tensor    # bool[N]
    n_inliers: torch.Tensor  # i32


def _sign_or_one(x: torch.Tensor) -> torch.Tensor:
    s = torch.sign(x)
    return torch.where(s == 0, torch.ones_like(s), s)


def _procrustes_rigid(Xw: torch.Tensor, Xc: torch.Tensor):
    """Batched rigid fit: R, t minimizing ||R Xw + t - Xc|| (no scale).
    Xw, Xc: [..., n, 3]."""
    mu_w = Xw.mean(dim=-2)
    mu_c = Xc.mean(dim=-2)
    H = torch.einsum("...ni,...nj->...ij", Xw - mu_w[..., None, :], Xc - mu_c[..., None, :])
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(torch.einsum("...ji,...kj->...ik", Vt, U)))
    D = torch.cat([torch.ones(d.shape + (2,), dtype=d.dtype, device=d.device), d[..., None]], dim=-1)
    # R = V diag(1, 1, d) U^T
    R = torch.einsum("...ji,...j,...jk->...ik", Vt, D, U.transpose(-1, -2))
    t = mu_c - torch.einsum("...ij,...j->...i", R, mu_w)
    return R, t


_TRIU_I = (0, 0, 0, 1, 1, 2)
_TRIU_J = (1, 2, 3, 2, 3, 3)


def _epnp_pose(X: torch.Tensor, xn: torch.Tensor):
    """EPnP: X [..., n, 3] world points, xn [..., n, 2] normalized coords.
    Returns (R [..., 3, 3], t [..., 3])."""
    n = X.shape[-2]
    # control points: centroid + PCA frame
    c0 = X.mean(dim=-2)
    Xc0 = X - c0[..., None, :]
    cov = torch.einsum("...ni,...nj->...ij", Xc0, Xc0) / n
    wv, Wv = torch.linalg.eigh(cov)                              # ascending
    d = torch.sqrt(torch.clamp(wv, min=1e-8))
    A = Wv * d[..., None, :]                                     # columns: scaled principal directions
    cw = torch.cat([c0[..., None, :], c0[..., None, :] + A.transpose(-1, -2)], dim=-2)   # [..., 4, 3]
    # barycentric coordinates
    a123 = torch.einsum("...ij,...nj->...ni", torch.linalg.inv(A), Xc0)
    alpha = torch.cat([1.0 - a123.sum(dim=-1, keepdim=True), a123], dim=-1)              # [..., n, 4]
    # M and its normal equations
    u = xn[..., 0]
    v = xn[..., 1]
    zeros = torch.zeros_like(alpha)
    rx = torch.stack([alpha, zeros, -alpha * u[..., None]], dim=-1)                      # [..., n, 4, 3]
    ry = torch.stack([zeros, alpha, -alpha * v[..., None]], dim=-1)
    M = torch.cat([rx.reshape(rx.shape[:-2] + (12,)), ry.reshape(ry.shape[:-2] + (12,))], dim=-2)   # [..., 2n, 12]
    MtM = torch.einsum("...ni,...nj->...ij", M, M)
    _, V = torch.linalg.eigh(MtM)
    vker = V[..., :, 0]                                          # smallest eigenvalue
    cc = vker.reshape(vker.shape[:-1] + (4, 3))
    # beta (N=1 case): match the distances between control points
    ii, jj = list(_TRIU_I), list(_TRIU_J)
    dv = torch.linalg.norm(cc[..., ii, :] - cc[..., jj, :], dim=-1)                      # [..., 6]
    dw = torch.linalg.norm(cw[..., ii, :] - cw[..., jj, :], dim=-1)
    beta = (dv * dw).sum(dim=-1) / torch.clamp((dv * dv).sum(dim=-1), min=1e-12)
    Xcam = torch.einsum("...nj,...jk->...nk", alpha, cc * beta[..., None, None])
    # cheirality: the reconstructed camera-frame depths must be positive
    Xcam = Xcam * _sign_or_one(Xcam[..., 2].sum(dim=-1))[..., None, None]
    return _procrustes_rigid(X, Xcam)


def _dlt_pose(X: torch.Tensor, xn: torch.Tensor):
    """6-point DLT: X [..., 6, 3] world, xn [..., 6, 2] normalized coords.
    Returns (R [..., 3, 3], t [..., 3]) with R projected onto SO(3)."""
    x, y = xn[..., 0], xn[..., 1]
    Xh = torch.cat([X, torch.ones_like(x)[..., None]], dim=-1)                           # [..., 6, 4]
    r1 = torch.cat([Xh, torch.zeros_like(Xh), -x[..., None] * Xh], dim=-1)               # [..., 6, 12]
    r2 = torch.cat([torch.zeros_like(Xh), Xh, -y[..., None] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                                                      # [..., 12, 12]
    _, _, Vt = torch.linalg.svd(A)
    p = Vt[..., -1, :]
    P = p.reshape(p.shape[:-1] + (3, 4))
    M = P[..., :3]
    # sign: the points must lie in front of the camera
    Xc = torch.einsum("...ij,...nj->...ni", M, X) + P[..., None, :, 3]
    P = P * _sign_or_one(Xc[..., 2].sum(dim=-1))[..., None, None]
    M = P[..., :3]
    scale = torch.pow(torch.abs(torch.linalg.det(M)) + 1e-12, 1.0 / 3.0)[..., None, None]
    M = M / scale
    t = P[..., 3] / scale[..., 0]
    # Procrustes: the closest rotation
    U, _, Vt2 = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(U @ Vt2))
    D = torch.cat([torch.ones(d.shape + (2,), dtype=d.dtype, device=d.device), d[..., None]], dim=-1)
    R = U @ (D[..., :, None] * Vt2)
    return R, t


def draw_pnp_sets(valid: torch.Tensor, iters: int, generator: torch.Generator) -> torch.Tensor:
    """Random minimal sets i64[iters, 6]: indices into the valid points,
    drawn on the generator's device (reads the valid count to the host)."""
    n_valid = max(int(valid.sum()), 1)
    pick = torch.randint(0, n_valid, (iters, 6), generator=generator, device=generator.device)
    return pick.to(valid.device)


def solve_pnp_ransac(X: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor, fx: float, fy: float, cx: float,
                     cy: float, pick: torch.Tensor, chi2_th: float = 5.991, min_inliers: int = 15,
                     solver: str = "epnp") -> PnPResult:
    """All-hypotheses-at-once PnP RANSAC. X f32[N, 3] world points, uv
    f32[N, 2] observed pixels, valid bool[N]; ``pick`` i64[iters, 6] holds
    each hypothesis' minimal set as indices into the valid points
    (``draw_pnp_sets``). The best hypothesis is the first with the most
    inliers; a hypothesis with a non-finite pose counts -1."""
    N = X.shape[0]
    dev = X.device
    vidx = ops.nonzero_fixed(valid, N, 0)
    sel = vidx[pick.to(device=dev, dtype=torch.int64)]                                   # [iters, 6]
    c = torch.tensor([cx, cy], dtype=torch.float32, device=dev)
    f = torch.tensor([fx, fy], dtype=torch.float32, device=dev)
    xn = (uv - c) / f
    minimal = _epnp_pose if solver == "epnp" else _dlt_pose
    R_all, t_all = minimal(X[sel], xn[sel])

    # score every hypothesis against every point
    Xc = torch.einsum("hij,nj->hni", R_all, X) + t_all[:, None, :]
    z = Xc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    u = fx * Xc[..., 0] / zs + cx
    v = fy * Xc[..., 1] / zs + cy
    chi2 = (u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2
    inl = valid[None, :] & (z > 1e-3) & (chi2 < chi2_th)
    counts = inl.sum(dim=1, dtype=torch.int32)
    finite = torch.isfinite(R_all).all(dim=-1).all(dim=-1) & torch.isfinite(t_all).all(dim=-1)
    counts = torch.where(finite, counts, -1)
    best = torch.argmax(counts)
    return PnPResult(success=counts[best] >= min_inliers, R=R_all[best], t=t_all[best], inliers=inl[best],
                     n_inliers=counts[best])
