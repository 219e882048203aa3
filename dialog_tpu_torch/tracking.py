"""Per-frame tracking: the data path of the Track() state machine.

Port of ``dialog_tpu/tracking.py``: motion-model projection search, the
reference-keyframe fallback, pose optimization, the local-map search, a
second pose optimization and outlier filtering, all in ``fused_track_step``.
Projection searches go through ``matching.match_projected`` (kernel B).
"""

from __future__ import annotations

import torch

from . import geometry as geo
from . import matching, ops
from .config import EngineConfig
from .containers import INVALID_ID, FrameArrays, MapState
from .optim.pose_only import pose_optimization


def predict_scale(dist, dmax, cfg: EngineConfig):
    """Predicted detection octave from camera distance (MapPoint::PredictScale)."""
    ratio = torch.clamp(dmax / torch.clamp(dist, min=1e-6), min=1e-6)
    log_s = torch.log(torch.tensor(cfg.scale_factor, dtype=torch.float32, device=ratio.device))
    lvl = torch.ceil(torch.log(ratio) / log_s - 1e-4)
    return torch.clamp(lvl, 0, cfg.n_levels - 1).to(torch.int32)


def _project_landmarks(m: MapState, ids, R, t, cfg: EngineConfig, frustum: bool = False):
    """Gather landmark data for ids (L = invalid sentinel) and project.

    With ``frustum=True`` the full isInFrustum gate applies (viewing angle
    within 60 deg of the mean normal, distance inside [0.8 dmin, 1.2 dmax]).
    Returns (xyz, desc, uv, octave, vis) sized like ids.
    """
    L = m.lms.xyz.shape[0]
    safe = torch.clamp(ids, 0, L - 1).long()
    ok = (ids >= 0) & (ids < L) & m.lms.valid[safe]
    xyz = m.lms.xyz[safe]
    desc = m.lms.desc[safe]
    dmax = m.lms.dmax[safe]
    uv, z = geo.project(R, t, xyz, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    inb = (uv[:, 0] >= 0) & (uv[:, 0] < cfg.width) & (uv[:, 1] >= 0) & (uv[:, 1] < cfg.height)
    cam_center = -R.T @ t
    ray = xyz - cam_center
    dist = torch.linalg.norm(ray, dim=-1)
    octv = predict_scale(dist, dmax, cfg)
    vis = ok & (z > 1e-3) & inb
    if frustum:
        normal = m.lms.normal[safe]
        dmin = m.lms.dmin[safe]
        cos_view = torch.sum(ray * normal, dim=-1) / torch.clamp(dist, min=1e-9)
        vis = vis & (cos_view > cfg.view_cos_th) & (dist >= 0.8 * dmin) & (dist <= 1.2 * dmax)
    return xyz, desc, uv, octv, vis


def _invert_matches(match_ft, src, F: int, L: int):
    """Per-feature landmark id from per-landmark matches (drops out-of-range)."""
    lm_of_feat = torch.full((F,), INVALID_ID, dtype=torch.int32, device=match_ft.device)
    tgt = torch.where(match_ft >= 0, match_ft, F)
    lm_of_feat = ops.scatter_set(lm_of_feat, tgt, torch.where(match_ft >= 0, src, L).to(torch.int32))
    return torch.where(lm_of_feat >= L, INVALID_ID, lm_of_feat)


def _motion_match(m, last_lm_ids, frame: FrameArrays, R_pred, t_pred, cfg, radius):
    """Project the last frame's landmarks into the predicted pose and match."""
    F = frame.uv.shape[0]
    L = m.lms.xyz.shape[0]
    ids = torch.where(last_lm_ids >= 0, last_lm_ids, L)
    _, desc, uv_pred, octv, vis = _project_landmarks(m, ids, R_pred, t_pred, cfg)
    match_ft, _ = matching.match_projected(
        desc, uv_pred, vis, octv,
        frame.desc, frame.uv, frame.valid, frame.octave,
        radius=radius, scale_factor=cfg.scale_factor, max_dist=cfg.th_high, ratio=0.9,
    )
    lm_of_feat = _invert_matches(match_ft, ids, F, L)
    return lm_of_feat, torch.sum((lm_of_feat >= 0).to(torch.int32))


def _ref_kf_match(m, ref_kf, frame: FrameArrays, cfg):
    """Descriptor-only match against a keyframe's landmarks (TrackReferenceKeyFrame)."""
    F = frame.uv.shape[0]
    L = m.lms.xyz.shape[0]
    kf_desc = m.kfs.desc[ref_kf]
    kf_obs = m.kfs.obs_lm[ref_kf]
    kf_ok = (
        m.kfs.feat_valid[ref_kf]
        & (kf_obs >= 0)
        & m.lms.valid[torch.clamp(kf_obs, 0, L - 1).long()]
    )
    dist = matching.hamming_distance_matrix(kf_desc, frame.desc)
    match_ft, _ = matching.match_mutual(dist, kf_ok, frame.valid, max_dist=cfg.th_low, ratio=0.75)
    ok = matching.rotation_consistency_mask(m.kfs.angle[ref_kf], frame.angle, match_ft, match_ft >= 0)
    lm_of_feat = torch.full((F,), INVALID_ID, dtype=torch.int32, device=ok.device)
    lm_of_feat = ops.scatter_set(
        lm_of_feat, torch.where(ok, match_ft, F), torch.where(ok, kf_obs, L).to(torch.int32)
    )
    lm_of_feat = torch.where(lm_of_feat >= L, INVALID_ID, lm_of_feat)
    return lm_of_feat, torch.sum((lm_of_feat >= 0).to(torch.int32))


def local_landmark_ids(m: MapState, ref_kf, cfg: EngineConfig):
    """Landmarks seen by the reference KF's covisibility neighborhood
    (Tracking::UpdateLocalMap). Returns i32[max_local_lms], L = fill."""
    L = m.lms.xyz.shape[0]
    neigh = (m.covis[ref_kf] > 0) & m.kfs.valid
    neigh = neigh.clone()
    neigh[ref_kf] = True
    obs = m.kfs.obs_lm
    sel = neigh[:, None] & m.kfs.feat_valid & (obs >= 0)
    mark = ops.scatter_add(
        torch.zeros((L,), dtype=torch.int32, device=obs.device), torch.where(sel, obs, L), 1
    )
    mark = (mark > 0) & m.lms.valid
    return ops.nonzero_fixed(mark, cfg.max_local_lms, L).to(torch.int32)


def track_local_map_match(m, local_ids, frame: FrameArrays, lm_of_feat, R, t,
                          cfg: EngineConfig, radius: float = 6.0):
    """Project the local map and match unassociated features (SearchLocalPoints).

    Existing associations win. Returns (lm_of_feat i32[F], n_matches,
    in_frustum bool[max_local_lms]).
    """
    F = frame.uv.shape[0]
    L = m.lms.xyz.shape[0]
    already = torch.zeros((L + 1,), dtype=torch.bool, device=lm_of_feat.device)
    already = ops.scatter_set(already, torch.where(lm_of_feat >= 0, lm_of_feat, L), True)[:L]
    _, desc, uv_pred, octv, in_frustum = _project_landmarks(m, local_ids, R, t, cfg, frustum=True)
    safe = torch.clamp(local_ids, 0, L - 1)
    vis = in_frustum & ~already[safe.long()]
    feat_free = frame.valid & (lm_of_feat < 0)
    match_ft, _ = matching.match_projected(
        desc, uv_pred, vis, octv,
        frame.desc, frame.uv, feat_free, frame.octave,
        radius=radius, scale_factor=cfg.scale_factor,
        max_dist=cfg.th_high, ratio=0.8, octave_band=2,
    )
    new_lm = _invert_matches(match_ft, safe, F, L)
    merged = torch.where(lm_of_feat >= 0, lm_of_feat, new_lm)
    in_frustum = in_frustum | already[safe.long()]
    return merged, torch.sum((merged >= 0).to(torch.int32)), in_frustum


def gather_track_problem(m: MapState, frame: FrameArrays, lm_of_feat, cfg: EngineConfig):
    """(X, uv, inv_sigma2, valid) arrays for pose optimization."""
    L = m.lms.xyz.shape[0]
    safe = torch.clamp(lm_of_feat, 0, L - 1).long()
    valid = (lm_of_feat >= 0) & frame.valid & m.lms.valid[safe]
    X = m.lms.xyz[safe]
    base = torch.tensor(cfg.scale_factor, dtype=torch.float32, device=X.device)
    inv_sigma2 = torch.pow(base, -2.0 * frame.octave.to(torch.float32))
    return X, frame.uv, inv_sigma2, valid


def filter_outlier_assoc(R, t, m, frame, lm_of_feat, cfg: EngineConfig, chi2_th: float = 5.991):
    """Drop associations failing the chi2 gate at the final pose."""
    X, uv, inv_s2, valid = gather_track_problem(m, frame, lm_of_feat, cfg)
    uv_hat, z = geo.project(R, t, X, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    chi2 = torch.sum((uv_hat - uv) ** 2, -1) * inv_s2
    ok = valid & (z > 1e-3) & (chi2 <= chi2_th)
    return torch.where(ok, lm_of_feat, INVALID_ID), torch.sum(ok.to(torch.int32))


def apply_track_counts(m: MapState, counts) -> MapState:
    """Fold visibility/found increments into the landmark store."""
    vis_inc, found_inc = counts
    lms = m.lms._replace(n_visible=m.lms.n_visible + vis_inc, n_found=m.lms.n_found + found_inc)
    return m._replace(lms=lms)


def fused_track_step(m: MapState, last_lm_ids, frame: FrameArrays, R_pred, t_pred,
                     R_last, t_last, ref_kf, cfg: EngineConfig):
    """The whole per-frame tracking pipeline.

    Returns (R, t, lm_ids, packed f32[26], (vis_inc, found_inc)) with the
    reference's packed layout: R (9), t (3), R_rel to ref KF (9), t_rel (3),
    n_tracked, n_motion_matched.
    """
    chi2 = cfg.chi2_mono
    lm_ids, n_mm = _motion_match(m, last_lm_ids, frame, R_pred, t_pred, cfg, cfg.motion_search_radius)
    R0, t0 = R_pred, t_pred
    # host branch on the match count (the reference's lax.cond): one sync
    if int(n_mm) < 20:
        lm_b, n_b = _motion_match(m, last_lm_ids, frame, R_pred, t_pred, cfg,
                                  2.0 * cfg.motion_search_radius)
        lm_c, n_c = _ref_kf_match(m, ref_kf, frame, cfg)
        use_b = n_b >= 20
        lm_ids = torch.where(use_b, lm_b, lm_c)
        n_mm = torch.where(use_b, n_b, n_c)
        R0 = torch.where(use_b, R_pred, R_last)
        t0 = torch.where(use_b, t_pred, t_last)

    X, uv, inv_s2, valid = gather_track_problem(m, frame, lm_ids, cfg)
    res = pose_optimization(R0, t0, X, uv, inv_s2, valid, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                            chi2_th=chi2, rounds=cfg.pose_opt_rounds, iters=cfg.pose_opt_iters)
    lm_ids = torch.where(res.inlier, lm_ids, INVALID_ID)

    local_ids = local_landmark_ids(m, ref_kf, cfg)
    lm_ids, _, in_frustum = track_local_map_match(m, local_ids, frame, lm_ids, res.R, res.t, cfg)
    X, uv, inv_s2, valid = gather_track_problem(m, frame, lm_ids, cfg)
    res2 = pose_optimization(res.R, res.t, X, uv, inv_s2, valid, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                             chi2_th=chi2, rounds=2, iters=cfg.pose_opt_iters)
    lm_ids, n_tracked = filter_outlier_assoc(res2.R, res2.t, m, frame, lm_ids, cfg, chi2_th=chi2)

    L = m.lms.xyz.shape[0]
    zeros = torch.zeros((L,), dtype=torch.int32, device=lm_ids.device)
    vis_inc = ops.scatter_add(zeros, torch.where(in_frustum, local_ids, L), 1)
    found_inc = ops.scatter_add(zeros, torch.where(lm_ids >= 0, lm_ids, L), 1)
    vis_inc = torch.maximum(vis_inc, found_inc)
    R_ref, t_ref = m.kfs.R[ref_kf], m.kfs.t[ref_kf]
    R_rel = res2.R @ R_ref.T
    t_rel = res2.t - R_rel @ t_ref
    packed = torch.cat([
        res2.R.reshape(9), res2.t, R_rel.reshape(9), t_rel,
        torch.stack([n_tracked.to(torch.float32), n_mm.to(torch.float32)]),
    ])
    return res2.R, res2.t, lm_ids, packed, (vis_inc, found_inc)
