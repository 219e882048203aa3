"""Windowed bundle adjustment with a blocked Schur complement (port of
``dialog_tpu/optim/local_ba.py``).

The window is the covisibility neighborhood of a center keyframe; other
keyframes observing the window's landmarks contribute residuals with frozen
poses. Observations are bucketed per landmark into fixed-width lists
[P, O]; each LM iteration runs one fused reduction (kernel C on the card,
its plain version on the CPU), solves the dense reduced camera system and
back-substitutes the landmarks. With ``cfg.bf > 0`` the problem carries each
observation's stereo right-x, and observations that have one get the 3-row
(u, v, uR) residual with the Huber bound ``cfg.chi2_stereo`` (reference:
g2o's EdgeStereoSE3ProjectXYZ in LocalBundleAdjustment).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import geometry as geo
from .. import ops
from ..config import EngineConfig
from ..containers import INVALID_ID, MapState
from ..distributed import all_sum
from ..instrument import span
from ..kernels import schur as schur_kernel
from .lm import all_finite, huber_weight


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem extracted from a MapState."""

    cam_slots: torch.Tensor   # i32[C]  keyframe slot per camera (K = invalid)
    cam_opt: torch.Tensor     # bool[C] optimized (True) vs frozen (False)
    R: torch.Tensor           # f32[C, 3, 3]
    t: torch.Tensor           # f32[C, 3]
    lm_ids: torch.Tensor      # i32[P]  landmark slot per local landmark (L = pad)
    xyz: torch.Tensor         # f32[P, 3]
    obs_cam: torch.Tensor     # i32[P, O] camera index per observation (C = pad)
    obs_uv: torch.Tensor      # f32[P, O, 2]
    obs_w: torch.Tensor       # f32[P, O] information (inv sigma2)
    obs_ok: torch.Tensor      # bool[P, O]
    obs_feat: torch.Tensor    # i32[P, O] feature index (for outlier write-back)
    obs_ur: torch.Tensor | None = None   # f32[P, O] stereo right-x, < 0 = mono (None: mono problem)
    lm_opt: torch.Tensor | None = None   # landmark freeze mask (None = all optimized)


def dedupe_row_landmarks(li: torch.Tensor, P: int) -> torch.Tensor:
    """Keep only the FIRST feature per (camera row, landmark) in li [C, F]."""
    C, F = li.shape
    dev = li.device
    feat_ids = torch.arange(F, dtype=torch.int32, device=dev)[None, :].expand(C, F)
    cam_rows = torch.arange(C, dtype=torch.int64, device=dev)[:, None].expand(C, F)
    flat = (cam_rows * (P + 1) + li.long()).reshape(-1)
    first = ops.scatter_min(
        torch.full((C * (P + 1),), F, dtype=torch.int32, device=dev), flat, feat_ids.reshape(-1)
    )
    first_feat = first[flat].reshape(C, F)
    return torch.where((li >= P) | (feat_ids == first_feat), li, P)


def bucket_observations(li: torch.Tensor, P: int, O: int):
    """Pack per-camera landmark bindings li [C, F] into per-landmark lists.

    A feature's slot in its landmark's list = how many EARLIER cameras
    observe that landmark. Returns (obs_cam i32[P, O] (C = pad),
    obs_feat i32[P, O], obs_ok bool[P, O], n_over).
    """
    C, F = li.shape
    dev = li.device
    flat_idx = (torch.arange(C, dtype=torch.int64, device=dev)[:, None] * (P + 1) + li.long()).reshape(-1)
    pres = ops.scatter_add(
        torch.zeros((C * (P + 1),), dtype=torch.int32, device=dev), flat_idx, 1
    ).reshape(C, P + 1)
    rank_tab = torch.cumsum(pres, dim=0) - pres
    rank = rank_tab.reshape(-1)[flat_idx].reshape(C, F)
    keep = (li < P) & (rank < O)
    n_over = torch.sum((li < P) & (rank >= O))
    tgt_l = torch.where(keep, li, P).reshape(-1)
    tgt_o = torch.where(keep, rank, 0).reshape(-1)
    cam_of = torch.arange(C, dtype=torch.int32, device=dev)[:, None].expand(C, F).reshape(-1)
    feat_of = torch.arange(F, dtype=torch.int32, device=dev)[None, :].expand(C, F).reshape(-1)
    obs_cam = ops.scatter_set2(torch.full((P, O), C, dtype=torch.int32, device=dev), tgt_l, tgt_o, cam_of)
    obs_feat = ops.scatter_set2(torch.zeros((P, O), dtype=torch.int32, device=dev), tgt_l, tgt_o, feat_of)
    obs_ok = ops.scatter_set2(torch.zeros((P, O), dtype=torch.bool, device=dev), tgt_l, tgt_o, keep.reshape(-1))
    return obs_cam, obs_feat, obs_ok, n_over


def build_problem(m: MapState, center_kf, cfg: EngineConfig) -> BAProblem:
    """Gather the covisibility window + fixed observers + their observations."""
    K, F = m.kfs.obs_lm.shape
    L = m.lms.xyz.shape[0]
    W, Wf = cfg.max_local_kfs, cfg.max_fixed_kfs
    C = W + Wf
    P, O = cfg.max_local_lms, cfg.max_obs_per_lm
    dev = m.kfs.obs_lm.device

    w_row = torch.where(m.kfs.valid, m.covis[center_kf], 0).clone()
    w_row[center_kf] = 2**30
    top_w, win_slots = ops.top_k(w_row, W)
    win_ok = top_w > 0

    win_rows = m.kfs.obs_lm[win_slots]
    row_ok = win_ok[:, None] & m.kfs.feat_valid[win_slots]
    obs_ids = torch.where(row_ok & (win_rows >= 0), win_rows, L)
    mark = ops.scatter_add(torch.zeros((L,), dtype=torch.int32, device=dev), obs_ids, 1)
    lm_sel = (mark > 0) & m.lms.valid
    lm_ids = ops.nonzero_fixed(lm_sel, P, L).to(torch.int32)
    inv = ops.scatter_set(
        torch.full((L + 1,), P, dtype=torch.int32, device=dev), lm_ids,
        torch.arange(P, dtype=torch.int32, device=dev),
    )

    sel_mask_obs = lm_sel[torch.clamp(m.kfs.obs_lm, 0, L - 1).long()] & (m.kfs.obs_lm >= 0)
    kf_touches = torch.sum((sel_mask_obs & m.kfs.feat_valid).to(torch.int32), dim=1)
    in_window = ops.scatter_set(
        torch.zeros((K,), dtype=torch.bool, device=dev), torch.where(win_ok, win_slots, K), True
    )
    fixed_score = torch.where(m.kfs.valid & ~in_window, kf_touches, 0)
    top_f, fix_slots = ops.top_k(fixed_score, Wf)
    fix_ok = top_f > 0

    cam_slots = torch.cat([win_slots, fix_slots]).to(torch.int32)
    cam_valid = torch.cat([win_ok, fix_ok])
    cam_opt = torch.cat([win_ok, torch.zeros((Wf,), dtype=torch.bool, device=dev)]) & (cam_slots >= 2)
    cam_slots = torch.where(cam_valid, cam_slots, K)
    safe_slots = torch.clamp(cam_slots, 0, K - 1).long()

    rows = m.kfs.obs_lm[safe_slots]
    rows_ok = cam_valid[:, None] & m.kfs.feat_valid[safe_slots] & (rows >= 0)
    li = torch.where(rows_ok, inv[torch.clamp(rows, 0, L - 1).long()], P)
    li = dedupe_row_landmarks(li, P)
    obs_cam, obs_feat, obs_ok, _ = bucket_observations(li, P, O)

    safe_cam = torch.clamp(obs_cam, 0, C - 1).long()
    obs_uv = m.kfs.uv[safe_slots][safe_cam, obs_feat.long()]
    obs_oct = m.kfs.octave[safe_slots][safe_cam, obs_feat.long()]
    base = torch.tensor(cfg.scale_factor, dtype=torch.float32, device=dev)
    obs_w = torch.where(obs_ok, torch.pow(base, -2.0 * obs_oct.to(torch.float32)), 0.0)
    obs_ur = None
    if cfg.bf > 0:   # mono configs never gather the right-x
        obs_ur = torch.where(obs_ok, m.kfs.u_right[safe_slots][safe_cam, obs_feat.long()], -1.0)

    return BAProblem(
        cam_slots=cam_slots, cam_opt=cam_opt,
        R=m.kfs.R[safe_slots], t=m.kfs.t[safe_slots],
        lm_ids=lm_ids, xyz=m.lms.xyz[torch.clamp(lm_ids, 0, L - 1).long()],
        obs_cam=obs_cam, obs_uv=obs_uv, obs_w=obs_w, obs_ok=obs_ok, obs_feat=obs_feat, obs_ur=obs_ur,
    )


def _use_stereo(prob: BAProblem, cfg: EngineConfig) -> bool:
    """Does this problem carry stereo rows?"""
    return prob.obs_ur is not None and cfg.bf > 0


def _residuals(prob: BAProblem, R, t, xyz, fx, fy, cx, cy, bf: float = 0.0):
    """All-observation residuals/Jacobians [P, O, D, ...] (D = 2 mono, 3 with
    ``bf > 0`` and ``prob.obs_ur``) and the valid mask."""
    return schur_kernel.observation_terms(R, t, xyz, prob.obs_cam, prob.obs_uv, prob.obs_ok, fx, fy, cx, cy,
                                          obs_ur=prob.obs_ur, bf=bf)


def _delta2_of(prob: BAProblem, cfg: EngineConfig, chi2_th: float):
    """Per-observation Huber delta^2: ``cfg.chi2_stereo`` for 3-row edges
    (reference: sqrt(5.991) mono, sqrt(7.815) stereo)."""
    bf = cfg.bf if _use_stereo(prob, cfg) else 0.0
    return schur_kernel.observation_delta2(prob.obs_ur, bf, chi2_th, cfg.chi2_stereo)


def _robust_weights(r, w_info, ok, delta2):
    chi2 = torch.sum(r * r, -1) * w_info
    w = torch.where(ok, w_info * huber_weight(chi2, delta2), 0.0)
    rho = torch.where(
        chi2 <= delta2, chi2, 2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2
    )
    return w, torch.sum(torch.where(ok, rho, 0.0)), chi2


def global_cost(cost, R, t, xyz, group):
    """(the cost summed over the ranks of ``group``, whether R, t and every
    rank's landmarks are finite): one ``all_reduce`` of two numbers. Without
    a group, the cost and ``all_finite(R, t, xyz)``."""
    if group is None:
        return cost, all_finite(R, t, xyz)
    v = all_sum(torch.stack([cost, torch.sum(~torch.isfinite(xyz)).to(cost.dtype)]), group)
    return v[0], (v[1] == 0) & all_finite(R, t)


def solve_ba(prob: BAProblem, cfg: EngineConfig, iters: int = 10, chi2_th: float = 5.991,
             lam0: float = 1e-4, group=None):
    """Damped Schur-complement LM over the extracted problem.

    Returns (R [C,3,3], t [C,3], xyz [P,3], final robust cost). The
    reduction is ``kernels.schur.schur_reduce``: kernel C for CUDA tensors,
    its plain version (which also covers ``lm_opt``) for CPU tensors; it
    carries the stereo (uR) row when the problem has one. The kernel's index
    of observations by camera is built once here, not at every iteration.

    With a process group ``group`` the problem is this rank's slice of the
    landmarks (``global_ba.shard_problem``): each rank reduces its own
    landmarks (kernel C on the card), one ``all_reduce`` per iteration sums
    the camera-side outputs (``Hcc``, ``g_c``, ``g_red``, ``S_pair``) and one
    the new cost, and every rank solves the same camera system. (The
    reference pins its einsum path on a mesh; ROADMAP, queue 3.)
    """
    fx, fy, cx, cy = cfg.fx, cfg.fy, cfg.cx, cfg.cy
    use_stereo = _use_stereo(prob, cfg)
    bf = cfg.bf if use_stereo else 0.0
    delta2 = _delta2_of(prob, cfg, chi2_th)
    C = prob.cam_slots.shape[0]
    dev, dt = prob.xyz.device, prob.xyz.dtype
    cam_opt6 = prob.cam_opt.repeat_interleave(6)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    ar = torch.arange(C, device=dev)
    safe_cam = torch.clamp(prob.obs_cam, 0, C - 1).long()
    cam_index = schur_kernel.camera_index(prob.obs_cam, prob.obs_w, C) if prob.xyz.is_cuda else None

    def cost_of(R, t, xyz):
        r, _, _, ok = _residuals(prob, R, t, xyz, fx, fy, cx, cy, bf)
        _, cost, _ = _robust_weights(r, prob.obs_w, ok, delta2)
        # cheirality penalty: an observation pushed behind its camera would
        # otherwise drop out of the masked cost and look like an improvement
        n_behind = torch.sum((prob.obs_ok & ~ok).to(torch.float32))
        return global_cost(cost + 1e3 * n_behind, R, t, xyz, group)

    def step(R, t, xyz, lam):
        Hll_inv, g_l, Y, Hcc, g_c, g_red, S_pair = schur_kernel.schur_reduce(
            R, t, prob.cam_opt, xyz, prob.obs_cam, prob.obs_uv, prob.obs_w, lam,
            fx, fy, cx, cy, delta2=chi2_th, lm_opt=prob.lm_opt,
            obs_ur=prob.obs_ur if use_stereo else None, bf=bf, delta2_stereo=cfg.chi2_stereo,
            cam_index=cam_index,
        )
        if group is not None:
            cams = all_sum(torch.cat([Hcc.reshape(-1), g_c.reshape(-1), g_red.reshape(-1), S_pair.reshape(-1)]),
                           group)
            Hcc, g_c, g_red, S_pair = torch.split(cams, [36 * C, 6 * C, 6 * C, 36 * C * C])
            Hcc, S_pair = Hcc.reshape(C, 6, 6), S_pair.reshape(C, 6, C, 6)
            g_c, g_red = g_c.reshape(C, 6), g_red.reshape(C, 6)
        dcc = torch.diagonal(Hcc, dim1=-2, dim2=-1)
        Hcc_d = Hcc + (lam * torch.clamp(dcc, min=1e-9) + 1e-9)[..., None] * eye6
        S = torch.zeros((C, 6, C, 6), dtype=dt, device=dev)
        S[ar, :, ar, :] = Hcc_d
        S = (S - S_pair).reshape(6 * C, 6 * C)
        rhs = -(g_c - g_red).reshape(-1)
        S = torch.where(cam_opt6[:, None] & cam_opt6[None, :], S, 0.0)
        S = S + torch.diag(torch.where(cam_opt6, 0.0, 1.0))
        rhs = torch.where(cam_opt6, rhs, 0.0)
        dc = torch.linalg.solve(S, rhs).reshape(C, 6)
        cross = torch.einsum("poij,poi->pj", Y, dc[safe_cam])
        dl = torch.einsum("pij,pj->pi", Hll_inv, -g_l - cross)
        R_new, t_new = geo.se3_retract(R, t, dc)
        return R_new, t_new, xyz + dl

    R = geo.orthogonalize(prob.R)
    t, xyz = prob.t, prob.xyz
    cost = cost_of(R, t, xyz)[0]
    lam = torch.tensor(lam0, dtype=dt, device=dev)
    for _ in range(iters):
        R_new, t_new, xyz_new = step(R, t, xyz, lam)
        new_cost, finite = cost_of(R_new, t_new, xyz_new)
        accept = (new_cost < cost) & finite
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        xyz = torch.where(accept, xyz_new, xyz)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return geo.orthogonalize(R), t, xyz, cost


def write_back(m: MapState, prob: BAProblem, R, t, xyz, cfg: EngineConfig,
               chi2_th: float = 5.991) -> MapState:
    """Write optimized poses/points into the map and strip outlier observations."""
    K = m.kfs.valid.shape[0]
    L = m.lms.xyz.shape[0]
    C = prob.cam_slots.shape[0]
    tgt = torch.where(prob.cam_opt, prob.cam_slots, K)
    kfs = m.kfs._replace(R=ops.scatter_set(m.kfs.R, tgt, R), t=ops.scatter_set(m.kfs.t, tgt, t))
    lm_tgt = torch.where(prob.lm_ids < L, prob.lm_ids, L)
    lms = m.lms._replace(xyz=ops.scatter_set(m.lms.xyz, lm_tgt, xyz))

    # outliers at the optimized state; stereo edges classify against chi2_stereo
    bf = cfg.bf if _use_stereo(prob, cfg) else 0.0
    r, _, _, ok = _residuals(prob, R, t, xyz, cfg.fx, cfg.fy, cfg.cx, cfg.cy, bf)
    chi2 = torch.sum(r * r, -1) * prob.obs_w
    bad = ok & (chi2 > _delta2_of(prob, cfg, chi2_th))
    cam_slot_of_obs = prob.cam_slots[torch.clamp(prob.obs_cam, 0, C - 1).long()]
    k_idx = torch.where(bad, cam_slot_of_obs, K)
    obs_lm = ops.scatter_set2(kfs.obs_lm, k_idx, prob.obs_feat, INVALID_ID)
    return m._replace(kfs=kfs._replace(obs_lm=obs_lm), lms=lms)


def local_bundle_adjustment(m: MapState, center_kf, cfg: EngineConfig, iters: int = 10) -> MapState:
    """Full local BA pass: extract window -> solve -> write back."""
    with span("slam::local_ba"):
        prob = build_problem(m, center_kf, cfg)
        R, t, xyz, _ = solve_ba(prob, cfg, iters=iters, chi2_th=cfg.chi2_mono)
        return write_back(m, prob, R, t, xyz, cfg, chi2_th=cfg.chi2_mono)
