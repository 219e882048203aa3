"""Kernel C: fused BA Jacobian accumulation + Schur reduction (CUDA: ``csrc/schur.cu``).

Port of ``schur_reduce`` in ``dialog_tpu/kernels/schur.py``. One call per LM iteration
computes, from the camera poses, the landmarks and their bucketed
observations [P, O]:

  residuals -> analytic Jacobians -> Huber weights -> damped 3x3 Cholesky
  inverse of Hll -> g_l and Y = Jc^T W Jl per observation; on the camera
  side Hcc [C,6,6], g_c [C,6], g_red = sum Y Hll^-1 g_l [C,6] and
  S_pair = sum_p Y_p Hll_p^-1 Y_p^T [C,6,C,6].

``schur_reduce_plain`` is the same reduction in plain PyTorch (the
reference's einsum path, ``_reduce_jnp``); it also takes the frozen-landmark
mask ``lm_opt``, which the CUDA kernel does not. Monocular rows only: the
CUDA path raises on stereo right-x observations.
"""

from __future__ import annotations

import ctypes

import torch

from . import common

MAX_OBS = 16   # observations per landmark the CUDA kernel holds in shared memory


def observation_terms(R, t, xyz, obs_cam, obs_uv, valid, fx, fy, cx, cy, cam_opt=None):
    """Per-observation residuals r [P,O,2], pose Jacobians J_c [P,O,2,6],
    point Jacobians J_l [P,O,2,3] and the mask ``valid & (depth > 1e-3)``.
    Given ``cam_opt``, J_c is zero for the frozen cameras."""
    from ..geometry import project_jacobians

    C = R.shape[0]
    safe = torch.clamp(obs_cam, 0, C - 1).long()
    X = xyz[:, None, :].expand(obs_uv.shape[:2] + (3,))
    uv_hat, z, J_c, J_l = project_jacobians(R[safe], t[safe], X, fx, fy, cx, cy)
    if cam_opt is not None:
        J_c = torch.where(cam_opt[safe][..., None, None], J_c, 0.0)
    return uv_hat - obs_uv, J_c, J_l, valid & (z > 1e-3)


def schur_reduce_plain(R, t, cam_opt, xyz, obs_cam, obs_uv, obs_w, lam, fx, fy, cx, cy,
                       delta2: float = 5.991, lm_opt=None):
    """Plain PyTorch version of the fused reduction; returns
    (Hll_inv [P,3,3], g_l [P,3], Y [P,O,6,3], Hcc [C,6,6], g_c [C,6],
    g_red [C,6], S_pair [C,6,C,6])."""
    from ..optim.lm import chol3x3, huber_weight, tri_inv3x3_lower

    C = R.shape[0]
    valid = (obs_w > 0.0) & (obs_cam >= 0) & (obs_cam < C)
    r, J_c, J_l, ok = observation_terms(R, t, xyz, obs_cam, obs_uv, valid, fx, fy, cx, cy, cam_opt)
    chi2 = torch.sum(r * r, -1) * obs_w
    w = torch.where(ok, obs_w * huber_weight(chi2, delta2), 0.0)
    if lm_opt is not None:
        J_l = torch.where(lm_opt[:, None, None, None], J_l, 0.0)

    Hll = torch.einsum("poki,po,pokj->pij", J_l, w, J_l)
    g_l = torch.einsum("poki,po,pok->pi", J_l, w, r)
    dll = torch.diagonal(Hll, dim1=-2, dim2=-1)
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    Hll_d = Hll + (lam * torch.clamp(dll, min=1e-9) + 1e-9)[..., None] * eye3
    Ld_inv = tri_inv3x3_lower(chol3x3(Hll_d))
    Hll_inv = torch.einsum("pki,pkj->pij", Ld_inv, Ld_inv)

    Hcc_blk = torch.einsum("poki,po,pokj->poij", J_c, w, J_c)
    g_c_blk = torch.einsum("poki,po,pok->poi", J_c, w, r)
    Y = torch.einsum("poki,po,pokj->poij", J_c, w, J_l)
    YHinv = torch.einsum("poij,pjk->poik", Y, Hll_inv)
    gt_blk = torch.einsum("poij,pj->poi", YHinv, g_l)
    YL = torch.einsum("poij,pjk->poik", Y, Ld_inv.transpose(-1, -2))

    # camera-side sums as one-hot contractions (column C collects invalid obs)
    cam_c = torch.clamp(obs_cam, 0, C).long()
    E = torch.nn.functional.one_hot(cam_c, C + 1).to(r.dtype) * ok[..., None]
    Hcc = torch.einsum("poc,poij->cij", E, Hcc_blk)[:C]
    g_c = torch.einsum("poc,poi->ci", E, g_c_blk)[:C]
    g_red = torch.einsum("poc,poi->ci", E, gt_blk)[:C]
    Z = torch.einsum("poc,poik->pcik", E, YL)
    Zr = Z.permute(1, 2, 0, 3).reshape((C + 1) * 6, -1)
    S_pair = (Zr @ Zr.T).reshape(C + 1, 6, C + 1, 6)[:C, :, :C, :]
    return Hll_inv, g_l, Y, Hcc, g_c, g_red, S_pair


def schur_reduce(R, t, cam_opt, xyz, obs_cam, obs_uv, obs_w, lam, fx, fy, cx, cy,
                 delta2: float = 5.991, lm_opt=None, obs_ur=None):
    """One fused BA reduction pass (see module doc). ``lam`` is a 0-d f32
    tensor on the problem's device, so the LM loop never syncs the host."""
    if common.route(xyz) == "cpu":
        if obs_ur is not None:
            raise NotImplementedError("the port's Schur reduction has mono rows only")
        return schur_reduce_plain(R, t, cam_opt, xyz, obs_cam, obs_uv, obs_w, lam,
                                  fx, fy, cx, cy, delta2, lm_opt)
    if lm_opt is not None:
        raise ValueError("the CUDA Schur kernel has no frozen-landmark (lm_opt) path")
    if obs_ur is not None:
        raise NotImplementedError("the CUDA Schur kernel has mono rows only (no uR row yet)")
    from .build import load

    lib = load("schur")
    C = R.shape[0]
    P, O = obs_cam.shape
    dev = xyz.device
    if O > MAX_OBS:
        raise ValueError(f"schur_reduce: at most {MAX_OBS} observations per landmark, got {O}")
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev).reshape(())
    for name, x, dt, shape in [
        ("R", R, torch.float32, (C, 3, 3)), ("t", t, torch.float32, (C, 3)),
        ("cam_opt", cam_opt, torch.bool, (C,)), ("xyz", xyz, torch.float32, (P, 3)),
        ("obs_cam", obs_cam, torch.int32, (P, O)), ("obs_uv", obs_uv, torch.float32, (P, O, 2)),
        ("obs_w", obs_w, torch.float32, (P, O)), ("lam", lam, torch.float32, ()),
    ]:
        common.require(x, name, dt, shape, dev)
    hll_inv = torch.empty((P, 3, 3), dtype=torch.float32, device=dev)
    g_l = torch.empty((P, 3), dtype=torch.float32, device=dev)
    Y = torch.empty((P, O, 6, 3), dtype=torch.float32, device=dev)
    n_out = 36 * C * C + 48 * C
    n_blocks = lib.schur_num_blocks(P)
    part = torch.empty((max(n_blocks, 1) * n_out,), dtype=torch.float32, device=dev)
    cam_out = torch.empty((n_out,), dtype=torch.float32, device=dev)
    fn = lib.schur_reduce_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_float] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 6)
    err = fn(common.ptr(R), common.ptr(t), common.ptr(cam_opt), common.ptr(xyz),
             common.ptr(obs_cam), common.ptr(obs_uv), common.ptr(obs_w), common.ptr(lam),
             float(fx), float(fy), float(cx), float(cy), float(delta2), C, P, O,
             common.ptr(hll_inv), common.ptr(g_l), common.ptr(Y), common.ptr(part),
             common.ptr(cam_out), common.stream_ptr(dev))
    common.launches["schur_reduce"] += 1
    common.check(err, "schur_reduce")
    S_pair = cam_out[: 36 * C * C].reshape(C, 6, C, 6)
    Hcc = cam_out[36 * C * C : 36 * C * C + 36 * C].reshape(C, 6, 6)
    g_c = cam_out[36 * C * C + 36 * C : 36 * C * C + 42 * C].reshape(C, 6)
    g_red = cam_out[36 * C * C + 42 * C :].reshape(C, 6)
    return hll_inv, g_l, Y, Hcc, g_c, g_red, S_pair
