"""Two-view monocular initialization: batched H/F RANSAC (port of ``dialog_tpu/init2view.py``).

Every hypothesis of both models is solved and scored at once; model
selection RH = SH/(SH+SF) > 0.40 and the reconstruction census over the 4
essential and 8 Faugeras homography motions follow the reference.

The minimal sets are an input: ``picks = (pick_f [iters, 8], pick_h
[iters, 4])`` indexes the valid correspondences. The engine draws them from
its ``torch.Generator``; tests pass the reference's ``jax.random`` draws,
which torch cannot reproduce.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as geo
from . import ops

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_GAMMA = 5.991


class TwoViewResult(NamedTuple):
    success: torch.Tensor   # bool scalar
    R: torch.Tensor         # f32[3, 3]  cam1 -> cam2
    t: torch.Tensor         # f32[3]     unit norm
    points: torch.Tensor    # f32[N, 3]  triangulated in cam1 frame
    good: torch.Tensor      # bool[N]
    used_h: torch.Tensor    # bool scalar
    n_good: torch.Tensor    # i32 scalar


def _hartley_normalize(pts):
    """Similarity-normalize points [..., n, 2] to zero mean / unit mean abs-dev."""
    n = pts.shape[-2] + 1e-9
    mean = torch.sum(pts, dim=-2, keepdim=True) / n
    d = torch.sum(torch.abs(pts - mean), dim=-2, keepdim=True) / n
    s = 1.0 / (d + 1e-9)
    return (pts - mean) * s, mean[..., 0, :], s[..., 0, :]


def _denorm_T(mean, s):
    sx, sy = s[..., 0], s[..., 1]
    mx, my = mean[..., 0], mean[..., 1]
    z = torch.zeros_like(sx)
    o = torch.ones_like(sx)
    return torch.stack(
        [
            torch.stack([sx, z, -sx * mx], dim=-1),
            torch.stack([z, sy, -sy * my], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )


def _solve_f(p1, p2):
    """Normalized 8-point: p1, p2 [..., 8, 2] -> F [..., 3, 3] (rank 2)."""
    n1, mu1, s1 = _hartley_normalize(p1)
    n2, mu2, s2 = _hartley_normalize(p2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    A = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], dim=-1
    )
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    Fn = Vt[..., -1, :].reshape(Vt.shape[:-2] + (3, 3))
    U, S, Vt2 = torch.linalg.svd(Fn)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    Fn = U @ (S[..., None] * Vt2)
    return _denorm_T(mu2, s2).transpose(-1, -2) @ Fn @ _denorm_T(mu1, s1)


def _solve_h(p1, p2):
    """Normalized DLT from 4 correspondences -> H [..., 3, 3] (x2 ~ H x1)."""
    n1, mu1, s1 = _hartley_normalize(p1)
    n2, mu2, s2 = _hartley_normalize(p2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    Hn = Vt[..., -1, :].reshape(Vt.shape[:-2] + (3, 3))
    return torch.linalg.solve(_denorm_T(mu2, s2), Hn @ _denorm_T(mu1, s1))


def _homog(p):
    return torch.cat([p, torch.ones(p.shape[:-1] + (1,), dtype=p.dtype, device=p.device)], -1)


def _apply_h(H, p):
    """H [..., 3, 3] applied to pixel points p [N, 2] -> [..., N, 2]."""
    q = torch.einsum("...ij,nj->...ni", H, _homog(p))
    return q[..., :2] / (q[..., 2:3] + 1e-12)


def _score_h(H, p1, p2, valid, sigma2):
    """Symmetric transfer score (reference: CheckHomography), batched over H."""
    Hinv = torch.linalg.inv(H)
    e12 = torch.sum((p1 - _apply_h(Hinv, p2)) ** 2, -1) / sigma2
    e21 = torch.sum((p2 - _apply_h(H, p1)) ** 2, -1) / sigma2
    in12 = (e12 < CHI2_H) & valid
    in21 = (e21 < CHI2_H) & valid
    score = torch.sum(torch.where(in12, CHI2_H - e12, 0.0), -1) + torch.sum(
        torch.where(in21, CHI2_H - e21, 0.0), -1
    )
    return score, in12 & in21


def _score_f(F, p1, p2, valid, sigma2):
    """Epipolar point-line score both directions (reference: CheckFundamental)."""
    ph1, ph2 = _homog(p1), _homog(p2)
    l2 = torch.einsum("...ij,nj->...ni", F, ph1)
    l1 = torch.einsum("...ji,nj->...ni", F, ph2)
    d2 = torch.einsum("...ni,ni->...n", l2, ph2) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    d1 = torch.einsum("...ni,ni->...n", l1, ph1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    c1, c2 = d1 / sigma2, d2 / sigma2
    in1 = (c1 < CHI2_F) & valid
    in2 = (c2 < CHI2_F) & valid
    score = torch.sum(torch.where(in1, SCORE_GAMMA - c1, 0.0), -1) + torch.sum(
        torch.where(in2, SCORE_GAMMA - c2, 0.0), -1
    )
    return score, in1 & in2


def _decompose_E(E):
    """E -> 4 candidate (R [4,3,3], t [4,3]) with |t| = 1."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / (torch.linalg.norm(t) + 1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_H(Hn):
    """Faugeras 1988 SVD decomposition of a calibrated homography: 8 motions."""
    U, d, Vt = torch.linalg.svd(Hn)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    x1 = torch.stack([aux1, aux1, -aux1, -aux1])
    x3 = torch.stack([aux3, -aux3, aux3, -aux3])
    prod = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    # case d' = +d2
    st = prod / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    stheta = torch.stack([st, -st, -st, st])
    # case d' = -d2
    sp = prod / torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    sphi = torch.stack([sp, -sp, -sp, sp])

    Rs, ts = [], []
    for i in range(4):
        Rp = torch.stack([
            torch.stack([ct, zero, -stheta[i]]),
            torch.stack([zero, one, zero]),
            torch.stack([stheta[i], zero, ct]),
        ])
        tp = (d1 - d3) * torch.stack([x1[i], zero, -x3[i]])
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ tp)
    for i in range(4):
        Rp = torch.stack([
            torch.stack([cp, zero, sphi[i]]),
            torch.stack([zero, -one, zero]),
            torch.stack([sphi[i], zero, -cp]),
        ])
        tp = (d1 + d3) * torch.stack([x1[i], zero, x3[i]])
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ tp)
    R = torch.stack(Rs)
    t = torch.stack(ts)
    return R, t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-12)


def _check_rt(R, t, x1n, x2n, valid, fx, reproj_th2):
    """Triangulation census for candidate motions R [..., 3, 3], t [..., 3].

    Returns (n_good [...], good [..., N], points [..., N, 3] in cam1 frame).
    """
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    zero = torch.zeros((3,), dtype=R.dtype, device=R.device)
    Rb, tb = R[..., None, :, :], t[..., None, :]
    X = geo.triangulate_linear(eye, zero, Rb, tb, x1n, x2n)
    z1 = X[..., 2]
    Xc2 = geo.se3_apply(Rb, tb, X)
    z2 = Xc2[..., 2]
    o2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    r1 = X
    r2 = X - o2[..., None, :]
    cosp = torch.sum(r1 * r2, -1) / (
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1) + 1e-12
    )
    e1 = torch.sum((X[..., :2] / (z1[..., None] + 1e-12) - x1n) ** 2, -1) * fx * fx
    e2 = torch.sum((Xc2[..., :2] / (z2[..., None] + 1e-12) - x2n) ** 2, -1) * fx * fx
    finite = torch.all(torch.isfinite(X), -1)
    good = (
        valid & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998)
        & (e1 < reproj_th2) & (e2 < reproj_th2)
    )
    return torch.sum(good.to(torch.int32), -1), good, X


def draw_minimal_sets(valid: torch.Tensor, iters: int, generator: torch.Generator):
    """Random minimal-set indices (pick_f [iters, 8], pick_h [iters, 4]) into
    the valid correspondences, drawn on the generator's device."""
    n_valid = max(int(valid.sum()), 1)
    dev = generator.device
    pick_f = torch.randint(0, n_valid, (iters, 8), generator=generator, device=dev)
    pick_h = torch.randint(0, n_valid, (iters, 4), generator=generator, device=dev)
    return pick_f.to(valid.device), pick_h.to(valid.device)


def initialize_two_view(uv1, uv2, valid, fx, fy, cx, cy, picks=None, iters: int = 256,
                        sigma: float = 1.0, min_good: int = 50,
                        generator: torch.Generator | None = None) -> TwoViewResult:
    """Relative pose T_21 (X_2 = R X_1 + t, |t| = 1) from matched pixel coords.

    uv1/uv2: f32[N, 2] matched pairs; valid: bool[N]; picks: (pick_f, pick_h)
    minimal-set indices into the valid pairs, drawn from ``generator`` with
    ``draw_minimal_sets`` when not given.
    """
    N = uv1.shape[0]
    dev = uv1.device
    sigma2 = sigma * sigma
    vidx = ops.nonzero_fixed(valid, N, 0)
    if picks is None:
        picks = draw_minimal_sets(valid, iters, generator)
    pick_f, pick_h = (p.to(device=dev, dtype=torch.int64) for p in picks)

    F_all = _solve_f(uv1[vidx[pick_f]], uv2[vidx[pick_f]])
    H_all = _solve_h(uv1[vidx[pick_h]], uv2[vidx[pick_h]])
    score_f, _ = _score_f(F_all, uv1, uv2, valid, sigma2)
    score_h, _ = _score_h(H_all, uv1, uv2, valid, sigma2)

    bf = torch.argmax(score_f)
    bh = torch.argmax(score_h)
    SF, SH = score_f[bf], score_h[bh]
    F = F_all[bf]
    H = H_all[bh]
    _, inl_f = _score_f(F, uv1, uv2, valid, sigma2)
    _, inl_h = _score_h(H, uv1, uv2, valid, sigma2)

    RH = SH / (SH + SF + 1e-9)
    use_h = RH > 0.40

    K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=torch.float32, device=dev)
    Kinv = torch.linalg.inv(K)
    R_e, t_e = _decompose_E(K.T @ F @ K)
    R_h, t_h = _decompose_H(Kinv @ H @ K)
    R_cand = torch.cat([R_e, R_h])
    t_cand = torch.cat([t_e, t_h])
    from_h = torch.cat([torch.zeros(4, dtype=torch.bool, device=dev), torch.ones(8, dtype=torch.bool, device=dev)])
    cand_ok = torch.where(use_h, from_h, ~from_h)

    c = torch.tensor([cx, cy], dtype=torch.float32, device=dev)
    f = torch.tensor([fx, fy], dtype=torch.float32, device=dev)
    x1n = (uv1 - c) / f
    x2n = (uv2 - c) / f
    model_inl = torch.where(use_h, inl_h, inl_f)
    counts, goods, points = _check_rt(R_cand, t_cand, x1n, x2n, model_inl, fx, 4.0 * sigma2)
    counts = torch.where(cand_ok, counts, -1)
    best = torch.argmax(counts)
    best_n = counts[best]
    second_n = torch.max(torch.where(torch.arange(12, device=dev) == best, -1, counts))

    n_inl = torch.sum(model_inl.to(torch.int32))
    success = (
        (best_n >= min_good)
        & (best_n.to(torch.float32) > 0.75 * n_inl.to(torch.float32))
        & (second_n.to(torch.float32) < 0.90 * best_n.to(torch.float32))
    )
    return TwoViewResult(
        success=success, R=R_cand[best], t=t_cand[best], points=points[best],
        good=goods[best], used_h=use_h, n_good=best_n,
    )
