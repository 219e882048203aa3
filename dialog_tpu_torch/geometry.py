"""Lie-group geometry and the pinhole camera model (port of ``dialog_tpu/geometry.py``).

The subset the tracking paths and loop closing use. Conventions are the
reference's:

* poses are world->camera ``(R, t)``: ``X_c = R @ X_w + t``;
* SE3 tangent vectors are ``xi = (rho, phi)``, translation first;
* Sim3 tangent vectors are ``(rho, phi, sigma)`` (7,), scale last, ``s = exp(sigma)``;
* quaternions are ``(w, x, y, z)``;
* every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _mv(M, v):
    """Batched matrix-vector product (..., n, m) x (..., m) -> (..., n)."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def hat(w):
    """Skew-symmetric matrix of w (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(phi):
    """Rodrigues formula with a small-angle Taylor branch."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(phi)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R):
    """Log map (..., 3, 3) -> (..., 3); safe at theta=0 and near pi."""
    skew = vee(R - R.transpose(-1, -2))
    s2 = torch.sum(skew * skew, dim=-1)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)

    small = s2 < 1e-10
    s2_safe = torch.where(small, torch.ones_like(s2), s2)
    sin_t = 0.5 * torch.sqrt(s2_safe)
    theta_g = torch.atan2(sin_t, cos_t)
    scale = torch.where(small, 0.5 + s2 / 48.0, theta_g / (2.0 * sin_t))
    w_generic = skew * scale[..., None]

    B = R + _eye_like(R)
    col_norms2 = torch.sum(B * B, dim=-2)
    col = torch.argmax(col_norms2, dim=-1)
    idx = col[..., None, None].expand(B.shape[:-1] + (1,))
    axis = torch.gather(B, -1, idx)[..., 0]
    axis = axis * torch.rsqrt(torch.sum(axis * axis, dim=-1, keepdim=True) + _EPS)
    sign = torch.where(torch.sum(skew * axis, dim=-1) < 0.0, -1.0, 1.0)
    theta_pi = torch.atan2(0.5 * torch.sqrt(s2 + 1e-12), cos_t)
    w_pi = axis * (sign * theta_pi)[..., None]
    near_pi = cos_t < -0.999995
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(phi):
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta)
    )
    W = hat(phi)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def _so3_left_jacobian_inv(phi):
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    half = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / (torch.sin(half) + _EPS)) / (theta2 + _EPS),
    )
    W = hat(phi)
    return _eye_like(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)


# ---------------------------------------------------------------------------
# SE(3) -- poses as (R, t)
# ---------------------------------------------------------------------------


def se3_exp(xi):
    """xi = (rho, phi) (..., 6) -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return so3_exp(phi), _mv(_so3_left_jacobian(phi), rho)


def se3_log(R, t):
    phi = so3_log(R)
    rho = _mv(_so3_left_jacobian_inv(phi), t)
    return torch.cat([rho, phi], dim=-1)


def se3_inv(R, t):
    Rinv = R.transpose(-1, -2)
    return Rinv, -_mv(Rinv, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): first apply b, then a."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def se3_apply(R, t, X):
    """Transform points X (..., 3)."""
    return _mv(R, X) + t


def se3_retract(R, t, xi):
    """Left-multiplicative update: T <- exp(xi) o T."""
    dR, dt = se3_exp(xi)
    return se3_compose(dR, dt, R, t)


def orthogonalize(R):
    """Project a near-rotation back onto SO(3) (two Newton iterations)."""
    eye = _eye_like(R)
    for _ in range(2):
        R = R @ (1.5 * eye - 0.5 * (R.transpose(-1, -2) @ R))
    return R


# ---------------------------------------------------------------------------
# Sim(3) -- (s, R, t); tangent vectors (rho, phi, sigma), s = exp(sigma)
# ---------------------------------------------------------------------------


def sim3_apply(s, R, t, X):
    return s[..., None] * _mv(R, X) + t


def sim3_inv(s, R, t):
    Rinv = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return s_inv, Rinv, -s_inv[..., None] * _mv(Rinv, t)


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    return sa * sb, Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta


def _sim3_W(phi, sigma):
    """The Sim3 'W' matrix coupling (rho, phi, sigma) -> translation,
    W = A*I + B*hat(phi) + C*hat(phi)^2 (Strasdat's coefficients), with the
    small-sigma and small-theta limits. Every branch divides by a safe
    denominator, so forward-mode derivatives through ``torch.where`` stay
    finite at sigma = 0 and phi = 0."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    s = torch.exp(sigma)
    sig2 = sigma * sigma
    one = torch.ones_like(sigma)

    small_sig = torch.abs(sigma) < 1e-5
    small_th = theta2 < 1e-8

    A = torch.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0, (s - 1.0) / torch.where(small_sig, one, sigma))

    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    denom = sig2 + theta2
    denom = torch.where(denom < 1e-12, one, denom)

    # general case (sigma != 0, theta != 0)
    a_gc = s * sin_t
    b_gc = s * cos_t
    B_gen = (a_gc * sigma + (1.0 - b_gc) * theta) / (theta * denom)
    C_gen = (A - ((b_gc - 1.0) * sigma + a_gc * theta) / denom) / theta2

    # sigma -> 0: B -> (1 - cos)/theta^2, C -> (theta - sin)/theta^3
    B_s0 = (1.0 - cos_t) / torch.where(small_th, one, theta2)
    C_s0 = (theta - sin_t) / torch.where(small_th, one, theta2 * theta)
    B_s0 = torch.where(small_th, 0.5 - theta2 / 24.0, B_s0)
    C_s0 = torch.where(small_th, 1.0 / 6.0 - theta2 / 120.0, C_s0)

    # theta -> 0 (sigma != 0): B -> (sigma s - s + 1)/sigma^2, C -> (s sigma^2/2 - s sigma + s - 1)/sigma^3
    safe_sig = torch.where(small_sig, one, sigma)
    B_t0 = ((sigma - 1.0) * s + 1.0) / (safe_sig * safe_sig)
    C_t0 = ((0.5 * sig2 - sigma + 1.0) * s - 1.0) / (safe_sig * safe_sig * safe_sig)
    B_t0 = torch.where(small_sig, 0.5 + sigma / 3.0, B_t0)
    C_t0 = torch.where(small_sig, 1.0 / 6.0 + sigma / 8.0, C_t0)

    B = torch.where(small_sig, B_s0, torch.where(small_th, B_t0, B_gen))
    C = torch.where(small_sig, C_s0, torch.where(small_th, C_t0, C_gen))

    W = hat(phi)
    return A[..., None, None] * _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def sim3_exp(xi):
    """xi = (rho, phi, sigma) (..., 7) -> (s, R, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return torch.exp(sigma), so3_exp(phi), _mv(_sim3_W(phi, sigma), rho)


def sim3_log(s, R, t):
    """(s, R, t) -> (..., 7). rho solves W rho = t; ``solve_ex`` leaves out
    ``torch.linalg.solve``'s status check, a host read on the card (W is
    invertible for any rotation angle below 2 pi)."""
    sigma = torch.log(s)
    phi = so3_log(R)
    rho = torch.linalg.solve_ex(_sim3_W(phi, sigma), t.unsqueeze(-1), check_errors=False)[0].squeeze(-1)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_retract(s, R, t, xi):
    """Left-multiplicative update: S <- exp(xi) o S."""
    ds, dR, dt = sim3_exp(xi)
    return sim3_compose(ds, dR, dt, s, R, t)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_normalize(q):
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_to_mat(q):
    w, x, y, z = quat_normalize(q).unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def mat_to_quat(R):
    """Branchless Shepperd's method: the candidate of the largest of 4 q_i^2."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def half_root(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 0.5

    sw, sx, sy, sz = half_root(qw2), half_root(qx2), half_root(qy2), half_root(qz2)
    cand_w = torch.stack([2 * sw, (m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw), (m10 - m01) / (2 * sw)], -1) * 0.5
    cand_x = torch.stack([(m21 - m12) / (2 * sx), 2 * sx, (m01 + m10) / (2 * sx), (m02 + m20) / (2 * sx)], -1) * 0.5
    cand_y = torch.stack([(m02 - m20) / (2 * sy), (m01 + m10) / (2 * sy), 2 * sy, (m12 + m21) / (2 * sy)], -1) * 0.5
    cand_z = torch.stack([(m10 - m01) / (2 * sz), (m02 + m20) / (2 * sz), (m12 + m21) / (2 * sz), 2 * sz], -1) * 0.5
    idx = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)       # canonical sign: w >= 0
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# Camera model
# ---------------------------------------------------------------------------


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(R, t, X, fx, fy, cx, cy):
    """Project world points through T_cw: returns (uv (..., 2), depth z (...))."""
    Xc = se3_apply(R, t, X)
    z = Xc[..., 2]
    zs = _safe_z(z)
    u = fx * Xc[..., 0] / zs + cx
    v = fy * Xc[..., 1] / zs + cy
    return torch.stack([u, v], dim=-1), z


def project_jacobians(R, t, X, fx, fy, cx, cy):
    """(uv, z, J_pose (..., 2, 6), J_point (..., 2, 3)) of the reprojection model.

    J_pose is wrt the left-multiplicative twist xi = (rho, phi)."""
    Xc = se3_apply(R, t, X)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    inv_z = 1.0 / _safe_z(z)
    inv_z2 = inv_z * inv_z
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    uv = torch.stack([u, v], dim=-1)
    zero = torch.zeros_like(x)
    J_proj = torch.stack(
        [
            torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1),
            torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(Xc.shape + (3,))
    J_xc_pose = torch.cat([eye, -hat(Xc)], dim=-1)
    return uv, z, J_proj @ J_xc_pose, J_proj @ R


def stereo_project_jacobians(R, t, X, fx, fy, cx, cy, bf):
    """(uvr (..., 3), z, J_pose (..., 3, 6), J_point (..., 3, 3)) of the stereo
    model, observation (u, v, uR) with uR = u - bf/z (g2o's
    EdgeStereoSE3ProjectXYZOnlyPose)."""
    Xc = se3_apply(R, t, X)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    inv_z = 1.0 / _safe_z(z)
    inv_z2 = inv_z * inv_z
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    uvr = torch.stack([u, v, u - bf * inv_z], dim=-1)
    zero = torch.zeros_like(x)
    J_proj = torch.stack(
        [
            torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1),
            torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1),
            torch.stack([fx * inv_z, zero, -fx * x * inv_z2 + bf * inv_z2], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(Xc.shape + (3,))
    J_xc_pose = torch.cat([eye, -hat(Xc)], dim=-1)
    return uvr, z, J_proj @ J_xc_pose, J_proj @ R


def stereo_project(R, t, X, fx, fy, cx, cy, bf):
    """Stereo projection: ((u, v, uR), z) with uR = u - bf/z."""
    uv, z = project(R, t, X, fx, fy, cx, cy)
    zs = _safe_z(z)
    uR = uv[..., 0] - zs.new_tensor(bf) / zs
    return torch.cat([uv, uR[..., None]], dim=-1), z


def reprojection_terms(R, t, X, uv, fx, fy, cx, cy, u_right=None, bf: float = 0.0):
    """Residuals of the observed pixels ``uv`` against the projection of X,
    with their Jacobians: (r (..., D), z, J_pose (..., D, 6), J_point (..., D, 3)).
    D = 2; or 3 given ``u_right``, the stereo row uR_hat - uR, zero where
    ``u_right < 0`` (a monocular observation)."""
    if u_right is None:
        uv_hat, z, J_pose, J_point = project_jacobians(R, t, X, fx, fy, cx, cy)
        return uv_hat - uv, z, J_pose, J_point
    uvr_hat, z, J_pose, J_point = stereo_project_jacobians(R, t, X, fx, fy, cx, cy, bf)
    r = uvr_hat - torch.cat([uv, u_right[..., None]], dim=-1)
    mono = (torch.arange(3, device=r.device) == 2) & (u_right < 0.0)[..., None]
    return (torch.where(mono, 0.0, r), z, torch.where(mono[..., None], 0.0, J_pose),
            torch.where(mono[..., None], 0.0, J_point))


def backproject(uv, z, fx, fy, cx, cy):
    """Pixel + depth -> camera-frame 3D point."""
    x = (uv[..., 0] - cx) / fx * z
    y = (uv[..., 1] - cy) / fy * z
    return torch.stack([x, y, z], dim=-1)


def distort_radtan(xn, k1, k2, p1, p2, k3=0.0):
    """Radial-tangential distortion of normalized coords (..., 2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(uv, fx, fy, cx, cy, k1, k2, p1, p2, k3=0.0, iters=8):
    """Fixed-point undistortion of pixel coords (as cv::undistortPoints)."""
    xd = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    xn = xd
    for _ in range(iters):
        xn = xd - (distort_radtan(xn, k1, k2, p1, p2, k3) - xn)
    return torch.stack([xn[..., 0] * fx + cx, xn[..., 1] * fy + cy], dim=-1)


# ---------------------------------------------------------------------------
# Triangulation and alignment
# ---------------------------------------------------------------------------


def triangulate_linear(R1, t1, R2, t2, uv1n, uv2n):
    """Two-view DLT triangulation of normalized coords via 3x3 normal equations."""

    def rows(R, t, uvn):
        u, v = uvn[..., 0], uvn[..., 1]
        r1, r2, r3 = R[..., 0, :], R[..., 1, :], R[..., 2, :]
        t1_, t2_, t3_ = t[..., 0], t[..., 1], t[..., 2]
        a1 = u[..., None] * r3 - r1
        b1 = -(u * t3_ - t1_)
        a2 = v[..., None] * r3 - r2
        b2 = -(v * t3_ - t2_)
        return torch.stack([a1, a2], dim=-2), torch.stack([b1, b2], dim=-1)

    A1, b1 = rows(R1, t1, uv1n)
    A2, b2 = rows(R2, t2, uv2n)
    shape = torch.broadcast_shapes(A1.shape, A2.shape)
    A = torch.cat([A1.expand(shape), A2.expand(shape)], dim=-2)
    bshape = torch.broadcast_shapes(b1.shape, b2.shape)
    b = torch.cat([b1.expand(bshape), b2.expand(bshape)], dim=-1)
    AtA = A.transpose(-1, -2) @ A
    Atb = _mv(A.transpose(-1, -2), b)
    AtA = AtA + 1e-9 * torch.eye(3, dtype=A.dtype, device=A.device)
    return torch.linalg.solve(AtA, Atb.unsqueeze(-1)).squeeze(-1)


def umeyama_alignment(src, dst, weights=None, with_scale=True):
    """Weighted Umeyama: (s, R, t) minimizing ||dst - (s R src + t)||^2."""
    if weights is None:
        weights = torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
    w = weights / (torch.sum(weights) + _EPS)
    mu_s = torch.sum(w[:, None] * src, dim=0)
    mu_d = torch.sum(w[:, None] * dst, dim=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = (dc * w[:, None]).T @ sc
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
    R = U @ torch.diag(diag) @ Vt
    var_s = torch.sum(w * torch.sum(sc * sc, dim=-1))
    if with_scale:
        s = torch.sum(S * diag) / (var_s + _EPS)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - s * _mv(R, mu_s)
    return s, R, t
