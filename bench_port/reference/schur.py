"""Plain reference of the bundle-adjustment reduction (what kernel C answers), and its measures.

From camera poses, landmarks and their bucketed observations [P, O]:
residuals, analytic Jacobians (pose: left twist; zero for frozen cameras),
Huber weights (bound ``delta2``, or ``delta2_stereo`` for an observation
with a right-x), per landmark the damped Hll_d = Hll + (lam * diag(Hll) +
1e-9) I and its inverse, g_l, Y = Jc^T W Jl per observation; per camera Hcc,
g_c, g_red = sum Y Hll_d^-1 g_l and S_pair = sum_p Y_p Hll_d^-1 Y_p^T over
camera pairs. The reduced camera system is S = Hcc - S_pair. Also the size of
g_l's terms, ``gl_terms``, for the measures.

S is a difference of two large terms: on a stereo window whose landmarks lie
close to a camera, float32 rounding reads large against |S| itself and
small against the terms (``measures``).
"""

from __future__ import annotations

import torch

from . import geometry as geo
from .precision import dtype, einsum, mm


def reduce(inputs: dict, cam: dict, mode: str = "f64") -> dict:
    """The reduction of one call's inputs (``inputs``: the kernel's arguments by name)."""
    dt = dtype(mode)
    R, t, xyz = (inputs[k].to(dt) for k in ("R", "t", "xyz"))
    obs_cam, obs_uv, obs_w = inputs["obs_cam"].long(), inputs["obs_uv"].to(dt), inputs["obs_w"].to(dt)
    cam_opt, lam = inputs["cam_opt"], inputs["lam"].to(dt)
    obs_ur = inputs.get("obs_ur")
    stereo = obs_ur is not None and cam.get("bf", 0.0) > 0
    C = R.shape[0]
    P, O = obs_cam.shape
    valid = (obs_w > 0.0) & (obs_cam >= 0) & (obs_cam < C)
    safe = torch.clamp(obs_cam, 0, C - 1)
    X = xyz[:, None, :].expand(P, O, 3)
    r, z, Jc, Jl = geo.reprojection(R[safe], t[safe], X, obs_uv, cam, mode, obs_ur.to(dt) if stereo else None)
    Jc = torch.where(cam_opt[safe][..., None, None], Jc, 0.0)
    ok = valid & (z > 1e-3)
    chi2 = torch.sum(r * r, -1) * obs_w
    d2 = inputs["delta2"]
    if stereo:
        d2 = torch.where(obs_ur >= 0.0, inputs["delta2_stereo"], inputs["delta2"]).to(dt)
    hw, _ = geo.huber(chi2, d2)
    w = torch.where(ok, obs_w * hw, 0.0)

    Hll = einsum("poki,po,pokj->pij", Jl, w, Jl, mode=mode)
    g_l = einsum("poki,po,pok->pi", Jl, w, r, mode=mode)
    obs_t = obs_uv if not stereo else torch.cat([obs_uv, obs_ur.to(dt)[..., None]], -1)   # r = prediction - obs
    gl_terms = torch.einsum("poki,po,pok->pi", Jl.abs(), w, obs_t.abs() + (obs_t + r).abs())
    dll = torch.diagonal(Hll, dim1=-2, dim2=-1)
    Hll_d = Hll + (lam * torch.clamp(dll, min=1e-9) + 1e-9)[..., None] * torch.eye(3, dtype=dt, device=R.device)
    Hll_inv = torch.linalg.inv(Hll_d)
    Hcc_blk = einsum("poki,po,pokj->poij", Jc, w, Jc, mode=mode)
    g_c_blk = einsum("poki,po,pok->poi", Jc, w, r, mode=mode)
    Y = einsum("poki,po,pokj->poij", Jc, w, Jl, mode=mode)
    YH = mm(Y, Hll_inv[:, None], mode)                       # [P, O, 6, 3]
    gt_blk = mm(YH, g_l[:, None, :, None], mode)[..., 0]     # [P, O, 6]

    cam_c = torch.where(ok, obs_cam, C).clamp(0, C)
    Hcc = torch.zeros((C + 1, 6, 6), dtype=dt, device=R.device).index_add_(0, cam_c.reshape(-1), Hcc_blk.reshape(-1, 6, 6))[:C]
    g_c = torch.zeros((C + 1, 6), dtype=dt, device=R.device).index_add_(0, cam_c.reshape(-1), g_c_blk.reshape(-1, 6))[:C]
    g_red = torch.zeros((C + 1, 6), dtype=dt, device=R.device).index_add_(0, cam_c.reshape(-1), gt_blk.reshape(-1, 6))[:C]
    # S_pair = sum_p (Y_p H_p^-1/2)(Y_p H_p^-1/2)^T with H^-1/2 from a Cholesky factor: Z [(C+1)*6, P*3]
    Linv = torch.linalg.inv(torch.linalg.cholesky(Hll_d))                    # H^-1 = Linv^T Linv
    Zo = mm(Y, Linv.transpose(-1, -2)[:, None], mode)                      # [P, O, 6, 3]
    Z = torch.zeros((C + 1, P, 6, 3), dtype=dt, device=R.device)
    pidx = torch.arange(P, device=R.device)[:, None].expand(P, O)
    Z.index_put_((cam_c.reshape(-1), pidx.reshape(-1)), Zo.reshape(-1, 6, 3), accumulate=True)
    Z = Z.permute(0, 2, 1, 3)
    Zr = Z.reshape((C + 1) * 6, P * 3)
    S_pair = mm(Zr, Zr.T, mode).reshape(C + 1, 6, C + 1, 6)[:C, :, :C, :]
    return dict(Hll_inv=Hll_inv, g_l=g_l, Y=Y, Hcc=Hcc, g_c=g_c, g_red=g_red, S_pair=S_pair, Hll_d=Hll_d, ok=ok, gl_terms=gl_terms)


def _system(out: dict, opt: torch.Tensor, lam: float):
    """(S [6C, 6C], rhs [6C]) of one LM step, as the solver assembles it, in float64:
    S = blockdiag(Hcc + (lam diag(Hcc) + 1e-9) I) - S_pair over the optimized cameras, identity elsewhere."""
    Hcc, S_pair = out["Hcc"].double(), out["S_pair"].double()
    C = Hcc.shape[0]
    dcc = torch.diagonal(Hcc, dim1=-2, dim2=-1)
    Hcc = Hcc + (lam * torch.clamp(dcc, min=1e-9) + 1e-9)[..., None] * torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    S = -S_pair.clone()
    ar = torch.arange(C, device=Hcc.device)
    S[ar, :, ar, :] += Hcc
    S = S.reshape(6 * C, 6 * C)
    o6 = opt.repeat_interleave(6)
    S = torch.where(o6[:, None] & o6[None, :], S, 0.0) + torch.diag(torch.where(o6, 0.0, 1.0).double())
    rhs = torch.where(o6, -(out["g_c"].double() - out["g_red"].double()).reshape(-1), 0.0)
    return S, rhs


def measures(prog: dict, ref: dict, cam_opt: torch.Tensor, lam: float) -> dict:
    """The compared measures of ``prog``'s reduction against ``ref``'s (float64). Each is read
    against the terms its quantity is a difference of, since float32 rounding is of their size:

    * ``s_terms``: |dS|_F / (|Hcc|_F + |S_pair|_F): the reduced camera system S = Hcc - S_pair
      (against |S| itself, float32 rounding reads as large as the worst-conditioned landmark makes it);
    * ``step_backward``: the normwise backward error, in the reference's system, of the camera step
      solved from ``prog``'s system: |S_ref dc - rhs_ref| / (|S_ref|_F |dc| + |rhs_ref|);
    * ``lm_terms``: the landmark side that the back-substitution dl = Hll^-1 (-g_l - Y^T dc) reads,
      the largest of |dY|_F / |Y|_F; |dg_l| / |g_l's terms| (each observation's |Jl|^T w (|obs| +
      |prediction|): a residual is a difference of the two); and the median landmark's
      |L^T Hll^-1 L - I|_F with Hll_d = L L^T the reference's (the error of ``prog``'s inverse in the
      landmark's own metric: float32 cannot invert the few landmarks conditioned 1e6 and worse, so the
      median, and a fault that moves most landmarks shows).
    """
    d = lambda k: prog[k].double() - ref[k].double()  # noqa: E731
    n = lambda x: float(torch.linalg.norm(x.double().reshape(-1)))  # noqa: E731
    dS = -d("S_pair")
    C = dS.shape[0]
    ar = torch.arange(C, device=dS.device)
    dS[ar, :, ar, :] += d("Hcc")
    out = {"s_terms": n(dS) / max(n(ref["Hcc"]) + n(ref["S_pair"]), 1e-300)}
    S_r, rhs_r = _system(ref, cam_opt, lam)
    S_p, rhs_p = _system(prog, cam_opt, lam)
    dc = torch.linalg.solve(S_p, rhs_p)
    out["step_backward"] = n(S_r @ dc - rhs_r) / max(n(S_r) * n(dc) + n(rhs_r), 1e-300)
    live = ref["ok"].any(dim=1)
    inv_err = 0.0
    if bool(live.any()):
        L = torch.linalg.cholesky(ref["Hll_d"].double()[live])
        M = L.transpose(-1, -2) @ prog["Hll_inv"].double()[live] @ L
        inv_err = float(torch.linalg.matrix_norm(M - torch.eye(3, dtype=M.dtype, device=M.device)).median())
    out["lm_terms"] = max(n(d("Y")) / max(n(ref["Y"]), 1e-300), n(d("g_l")) / max(n(ref["gl_terms"]), 1e-300),
                          inv_err)
    return out
