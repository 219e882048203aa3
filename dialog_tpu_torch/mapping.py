"""Keyframe insertion and map growth (port of ``dialog_tpu/mapping.py``).

Keyframe processing, landmarks spawned from a stereo/RGB-D keyframe's depth,
epipolar triangulation of new points against the covisible neighbors,
landmark fusion, descriptor/geometry refresh and culling. Each step maps a ``MapState`` to a new one. Scatters with possibly
repeated indices go through ``ops.scatter_set``, which resolves duplicates
the way the reference's CPU scatter does (last write wins), so the result
does not depend on CUDA's write order.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as geo
from . import matching, ops
from .config import EngineConfig
from .containers import INVALID_ID, FrameArrays, MapState, recount_lm_obs, update_covis_for_kf
from .instrument import span


def _set_row(x: torch.Tensor, slot, value) -> torch.Tensor:
    out = x.clone()
    out[slot] = value
    return out


def insert_keyframe(m: MapState, frame: FrameArrays, R, t, lm_ids, frame_id, timestamp,
                    slot, parent, cfg: EngineConfig) -> MapState:
    """Write a frame into keyframe ``slot``; refresh covisibility + obs counts."""
    kfs = m.kfs
    lm_ids = torch.where(frame.valid, lm_ids, INVALID_ID)
    kfs = kfs._replace(
        R=_set_row(kfs.R, slot, R),
        t=_set_row(kfs.t, slot, t),
        uv=_set_row(kfs.uv, slot, frame.uv),
        desc=_set_row(kfs.desc, slot, frame.desc),
        octave=_set_row(kfs.octave, slot, frame.octave),
        angle=_set_row(kfs.angle, slot, frame.angle),
        u_right=_set_row(kfs.u_right, slot, frame.u_right),
        depth=_set_row(kfs.depth, slot, frame.depth),
        feat_valid=_set_row(kfs.feat_valid, slot, frame.valid),
        obs_lm=_set_row(kfs.obs_lm, slot, lm_ids),
        valid=_set_row(kfs.valid, slot, True),
        frame_id=_set_row(kfs.frame_id, slot, frame_id),
        timestamp=_set_row(kfs.timestamp, slot, timestamp),
        parent=_set_row(kfs.parent, slot, parent),
        seq=_set_row(kfs.seq, slot, torch.max(kfs.seq) + 1),
        cull_parent=_set_row(kfs.cull_parent, slot, INVALID_ID),
        cull_seq=_set_row(kfs.cull_seq, slot, INVALID_ID),
    )
    num_kfs = torch.maximum(m.num_kfs, torch.as_tensor(slot, device=m.num_kfs.device).to(torch.int32) + 1)
    m = m._replace(kfs=kfs, num_kfs=num_kfs)
    L = m.lms.xyz.shape[0]
    n_obs = ops.scatter_add(m.lms.n_obs, torch.where(lm_ids >= 0, lm_ids, L), 1)
    m = m._replace(lms=m.lms._replace(n_obs=n_obs))
    return update_covis_for_kf(m, slot)


def alloc_landmarks(m: MapState, X, desc, octave, mask, ref_kf, cam_center, cfg: EngineConfig):
    """Pack masked candidates into free landmark slots.

    Returns (m, slot_of i32[N]) with slot_of[i] = L where not allocated.
    """
    lms = m.lms
    L = lms.xyz.shape[0]
    N = X.shape[0]
    n_free = torch.sum(~lms.valid)
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    can = mask & (rank < n_free)
    free_slots = ops.nonzero_fixed(~lms.valid, N, L - 1)
    slot_of = torch.where(can, free_slots[torch.clamp(rank, 0, N - 1)], L)

    cam_dist = torch.linalg.norm(X - cam_center, dim=-1)
    base = torch.tensor(cfg.scale_factor, dtype=torch.float32, device=X.device)
    scale = torch.pow(base, octave.to(torch.float32))
    lev_factor = cfg.scale_factor ** (cfg.n_levels - 1)
    normal = (X - cam_center) / (cam_dist[..., None] + 1e-12)
    seq = m.kfs.seq[ref_kf]

    lms = lms._replace(
        xyz=ops.scatter_set(lms.xyz, slot_of, X),
        desc=ops.scatter_set(lms.desc, slot_of, desc),
        normal=ops.scatter_set(lms.normal, slot_of, normal),
        dmin=ops.scatter_set(lms.dmin, slot_of, cam_dist * scale / lev_factor),
        dmax=ops.scatter_set(lms.dmax, slot_of, cam_dist * scale),
        ref_kf=ops.scatter_set(lms.ref_kf, slot_of, torch.as_tensor(ref_kf, device=X.device)),
        first_seq=ops.scatter_set(lms.first_seq, slot_of, seq),
        n_obs=ops.scatter_set(lms.n_obs, slot_of, 0),
        n_visible=ops.scatter_set(lms.n_visible, slot_of, 1),
        n_found=ops.scatter_set(lms.n_found, slot_of, 1),
        valid=ops.scatter_set(lms.valid, slot_of, True),
    )
    n_alloc = torch.sum(can.to(torch.int32))
    n_dropped = torch.sum(mask.to(torch.int32)) - n_alloc
    m = m._replace(lms=lms, num_lms=m.num_lms + n_alloc, lm_dropped=m.lm_dropped + n_dropped)
    return m, slot_of.to(torch.int32)


def spawn_depth_landmarks(m: MapState, slot, cfg: EngineConfig) -> MapState:
    """Create landmarks from a keyframe's depth channel (stereo/RGB-D):
    every valid feature without a landmark whose depth is below
    ``th_depth x baseline`` (reference: Tracking::CreateNewKeyFrame's close
    points, and the whole of StereoInitialization for the first keyframe)."""
    with span("slam::depth_spawn"):
        kfs = m.kfs
        L = m.lms.xyz.shape[0]
        dev = kfs.uv.device
        depth = kfs.depth[slot]
        # the close-point bound in f32, as the reference computes it
        close = cfg.th_depth * torch.clamp(torch.tensor(cfg.baseline, dtype=torch.float32, device=dev), min=1e-6)
        cand = kfs.feat_valid[slot] & (kfs.obs_lm[slot] < 0) & (depth > 0.0) & (depth < close)
        R, t = kfs.R[slot], kfs.t[slot]
        c = torch.tensor([cfg.cx, cfg.cy], dtype=torch.float32, device=dev)
        f = torch.tensor([cfg.fx, cfg.fy], dtype=torch.float32, device=dev)
        xn = (kfs.uv[slot] - c) / f
        Xc = torch.cat([xn * depth[:, None], depth[:, None]], dim=-1)
        Rinv, tinv = geo.se3_inv(R, t)
        Xw = geo.se3_apply(Rinv, tinv, Xc)
        m, slot_of = alloc_landmarks(m, Xw, kfs.desc[slot], kfs.octave[slot], cand, slot, -R.T @ t, cfg)
        obs_lm = _set_row(m.kfs.obs_lm, slot, torch.where(slot_of < L, slot_of, m.kfs.obs_lm[slot]))
        lms = m.lms._replace(n_obs=ops.scatter_add(m.lms.n_obs, slot_of, 1))
        return m._replace(kfs=m.kfs._replace(obs_lm=obs_lm), lms=lms)


def _fundamental_from_poses(R1, t1, R2, t2, Kmat):
    """F mapping image-1 points to epipolar lines in image 2."""
    R21 = R2 @ R1.T
    t21 = t2 - R21 @ t1
    E = geo.hat(t21) @ R21
    Kinv = torch.linalg.inv(Kmat)
    return Kinv.T @ E @ Kinv


def _tri_candidates(Ra, ta, uv_a, desc_a, oct_a, free_a, Rb, tb, uv_b, desc_b, oct_b, free_b,
                    cfg: EngineConfig):
    """Epipolar-gated match + triangulation checks for one keyframe pair.

    As the reference does, the parallax gate is taken at the triangulated
    point, after the linear solve: a pair whose rays barely part solves to a
    point a few centimetres in front of the cameras, where the parallax is
    wide and the reprojection error small, and passes (ROADMAP R11).
    Returns (X [F,3], good [F], jb [F]).
    """
    F = uv_a.shape[0]
    fx, fy, cx, cy = cfg.fx, cfg.fy, cfg.cx, cfg.cy
    dev = uv_a.device
    Kmat = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=torch.float32, device=dev)

    dist = matching.hamming_distance_matrix(desc_a, desc_b)
    Fm = _fundamental_from_poses(Ra, ta, Rb, tb, Kmat)
    ones = torch.ones((F, 1), dtype=torch.float32, device=dev)
    ua = torch.cat([uv_a, ones], dim=-1)
    ub = torch.cat([uv_b, ones], dim=-1)
    lines_b = ua @ Fm.T
    d_epi = ((ub @ lines_b.T) ** 2 / (lines_b[:, 0] ** 2 + lines_b[:, 1] ** 2 + 1e-12)).T
    base = torch.tensor(cfg.scale_factor, dtype=torch.float32, device=dev)
    sigma2_b = torch.pow(base, 2.0 * oct_b.to(torch.float32))
    epi_ok = d_epi < 3.84 * sigma2_b[None, :]
    dist = torch.where(epi_ok, dist, matching.MAX_DIST)
    mb, _ = matching.match_mutual(
        dist, free_a, free_b, max_dist=cfg.tri_match_max_dist, ratio=cfg.tri_match_ratio
    )
    has = mb >= 0
    jb = torch.clamp(mb, 0, F - 1).long()

    c = torch.tensor([cx, cy], dtype=torch.float32, device=dev)
    f = torch.tensor([fx, fy], dtype=torch.float32, device=dev)
    xa = (uv_a - c) / f
    xb = (uv_b[jb] - c) / f
    X = geo.triangulate_linear(Ra, ta, Rb, tb, xa, xb)

    za = geo.se3_apply(Ra, ta, X)[:, 2]
    zb = geo.se3_apply(Rb, tb, X)[:, 2]
    uv_ra, _ = geo.project(Ra, ta, X, fx, fy, cx, cy)
    uv_rb, _ = geo.project(Rb, tb, X, fx, fy, cx, cy)
    e_a = torch.sum((uv_ra - uv_a) ** 2, -1)
    e_b = torch.sum((uv_rb - uv_b[jb]) ** 2, -1)
    sigma2_a = torch.pow(base, 2.0 * oct_a.to(torch.float32))
    ca = -Ra.T @ ta
    cb = -Rb.T @ tb
    r1 = X - ca
    r2 = X - cb
    cosp = torch.sum(r1 * r2, -1) / (torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1) + 1e-12)
    good = (
        has & (za > 1e-3) & (zb > 1e-3)
        & (e_a < 5.991 * sigma2_a) & (e_b < 5.991 * sigma2_b[jb])
        & (cosp < 0.99995) & torch.all(torch.isfinite(X), -1)
    )
    return X, good, jb


def triangulate_fanout(m: MapState, slot_a, neighbors, cfg: EngineConfig) -> MapState:
    """Triangulate the new keyframe against its neighbors (== slot_a: skip).

    A feature triangulated against several neighbors keeps its FIRST
    candidate, as in the reference's serial CreateNewMapPoints.
    """
    with span("slam::triangulate"):
        kfs = m.kfs
        F = kfs.uv.shape[1]
        K = kfs.valid.shape[0]
        L = m.lms.xyz.shape[0]
        Nn = neighbors.shape[0]
        Ra, ta = kfs.R[slot_a], kfs.t[slot_a]
        uv_a, desc_a, oct_a = kfs.uv[slot_a], kfs.desc[slot_a], kfs.octave[slot_a]
        free_a = kfs.feat_valid[slot_a] & (kfs.obs_lm[slot_a] < 0)

        Xs, goods, jbs = [], [], []
        for i in range(Nn):
            nb = neighbors[i]
            free_b = kfs.feat_valid[nb] & (kfs.obs_lm[nb] < 0)
            X, good, jb = _tri_candidates(
                Ra, ta, uv_a, desc_a, oct_a, free_a,
                kfs.R[nb], kfs.t[nb], kfs.uv[nb], kfs.desc[nb], kfs.octave[nb], free_b, cfg,
            )
            Xs.append(X)
            goods.append(good & (nb != slot_a))
            jbs.append(jb)
        Xs, goods, jbs = torch.stack(Xs), torch.stack(goods), torch.stack(jbs)

        gi = goods.to(torch.int32)
        keep = goods & ((torch.cumsum(gi, 0) - gi) == 0)

        flatX = Xs.reshape(Nn * F, 3)
        desc_rep = desc_a[None].expand(Nn, F, 8).reshape(Nn * F, 8)
        oct_rep = oct_a[None].expand(Nn, F).reshape(Nn * F)
        m, slot_of = alloc_landmarks(m, flatX, desc_rep, oct_rep, keep.reshape(-1), slot_a, -Ra.T @ ta, cfg)
        can2 = (slot_of < L).reshape(Nn, F)
        slot2 = slot_of.reshape(Nn, F)

        a_slot = torch.min(torch.where(can2, slot2, L), dim=0).values
        obs_lm = m.kfs.obs_lm.clone()
        obs_lm[slot_a] = torch.where(a_slot < L, a_slot, m.kfs.obs_lm[slot_a])
        k_idx = torch.where(can2, neighbors[:, None].expand(Nn, F), K)
        obs_lm = ops.scatter_set2(obs_lm, k_idx, jbs, torch.where(can2, slot2, 0).reshape(-1))
        lms = m.lms._replace(n_obs=ops.scatter_add(m.lms.n_obs, slot_of, 2))
        m = m._replace(kfs=m.kfs._replace(obs_lm=obs_lm), lms=lms)
        return update_covis_for_kf(m, slot_a)


def triangulate_between(m: MapState, slot_a, slot_b, cfg: EngineConfig) -> MapState:
    """New landmarks from the unmatched features of two keyframes
    (LocalMapping::CreateNewMapPoints for one pair): ``triangulate_fanout``
    with the one neighbour ``slot_b``."""
    nb = torch.as_tensor(slot_b, device=m.kfs.valid.device).reshape(1)
    return triangulate_fanout(m, slot_a, nb, cfg)


def fuse_landmarks_into_kf(m: MapState, src_kf, dst_kf, cfg: EngineConfig, recount: bool = True) -> MapState:
    """Project src's landmarks into dst; add observations / merge duplicates
    (LocalMapping::SearchInNeighbors + ORBmatcher::Fuse)."""
    from . import tracking as _tracking

    kfs, lms = m.kfs, m.lms
    K, F = kfs.obs_lm.shape
    L = lms.xyz.shape[0]

    ids = kfs.obs_lm[src_kf]
    has = kfs.feat_valid[src_kf] & (ids >= 0)
    ids_s = torch.where(has, ids, L)
    p = _tracking.project_landmarks(m, ids_s, kfs.R[dst_kf], kfs.t[dst_kf], cfg, 3.0, frustum=True)
    match_ft, _ = matching.mutual_match_fused(
        p.desc, kfs.desc[dst_kf], p.vis, kfs.feat_valid[dst_kf], uv_a=p.uv, uv_b=kfs.uv[dst_kf],
        radius2=p.radius2, oct_a=p.octave, oct_b=kfs.octave[dst_kf], octave_band=1, max_dist=cfg.th_low, ratio=1.0,
    )
    ok = match_ft >= 0
    ft = torch.clamp(match_ft, 0, F - 1).long()
    cur = kfs.obs_lm[dst_kf][ft]
    lm_here = torch.clamp(ids_s, 0, L - 1)

    # case 1: free feature -> new observation
    free = ok & (cur < 0)
    obs_lm = kfs.obs_lm.clone()
    obs_lm[dst_kf] = ops.scatter_set(obs_lm[dst_kf], torch.where(free, ft, F), torch.where(free, lm_here, 0))

    # case 2: bound to another landmark -> merge (keep the better-observed)
    dup = ok & (cur >= 0) & (cur != lm_here)
    cur_c = torch.clamp(cur, 0, L - 1)
    keep_cur = lms.n_obs[cur_c.long()] >= lms.n_obs[lm_here.long()]
    winner = torch.where(keep_cur, cur_c, lm_here)
    loser = torch.where(keep_cur, lm_here, cur_c)
    rep = torch.arange(L, dtype=torch.int32, device=obs_lm.device)
    rep = ops.scatter_set(rep, torch.where(dup, loser, L), torch.where(dup, winner, 0))
    rep = rep[rep.long()]
    all_obs = torch.where(obs_lm >= 0, rep[torch.clamp(obs_lm, 0, L - 1).long()], obs_lm)
    dead = ops.scatter_set(torch.zeros((L,), dtype=torch.bool, device=obs_lm.device),
                           torch.where(dup, loser, L), True)
    lms = lms._replace(valid=lms.valid & ~dead)
    m = m._replace(kfs=kfs._replace(obs_lm=all_obs), lms=lms)
    if recount:
        m = recount_lm_obs(m)
    return m


def refresh_landmark_descriptors(m: MapState, slot, cfg: EngineConfig) -> MapState:
    """Point each landmark's descriptor at its newest keyframe observation."""
    L = m.lms.xyz.shape[0]
    obs = m.kfs.obs_lm[slot]
    ok = m.kfs.feat_valid[slot] & (obs >= 0)
    desc = ops.scatter_set(m.lms.desc, torch.where(ok, obs, L), m.kfs.desc[slot])
    return m._replace(lms=m.lms._replace(desc=desc))


def refresh_landmark_geometry(m: MapState, slot, cfg: EngineConfig) -> MapState:
    """Blend the viewing normal toward the newest ray; re-anchor the distance band."""
    lms = m.lms
    L = lms.xyz.shape[0]
    obs = m.kfs.obs_lm[slot]
    ok = m.kfs.feat_valid[slot] & (obs >= 0)
    safe = torch.clamp(obs, 0, L - 1).long()
    tgt = torch.where(ok, obs, L)
    R, t = m.kfs.R[slot], m.kfs.t[slot]
    cam = -R.T @ t
    ray = lms.xyz[safe] - cam
    dist = torch.linalg.norm(ray, dim=-1)
    rayn = ray / (dist[:, None] + 1e-12)
    blend = 0.7 * lms.normal[safe] + 0.3 * rayn
    blend = blend / (torch.linalg.norm(blend, dim=-1, keepdim=True) + 1e-12)
    base = torch.tensor(cfg.scale_factor, dtype=torch.float32, device=R.device)
    scale = torch.pow(base, m.kfs.octave[slot].to(torch.float32))
    lev_factor = cfg.scale_factor ** (cfg.n_levels - 1)
    dmax_new = dist * scale
    lms = lms._replace(
        normal=ops.scatter_set(lms.normal, tgt, blend),
        dmax=ops.scatter_set(lms.dmax, tgt, dmax_new),
        dmin=ops.scatter_set(lms.dmin, tgt, dmax_new / lev_factor),
    )
    return m._replace(lms=lms)


def best_covisible(m: MapState, slot: int, n: int) -> list[int]:
    """Host-side: the top-n covisible keyframe slots of ``slot`` (weight > 0),
    heaviest first, ties ordered as the reference's ``np.argsort`` orders them."""
    row = m.covis[slot].cpu().numpy()
    row = np.where(m.kfs.valid.cpu().numpy(), row, 0)
    order = np.argsort(-row)
    return [int(k) for k in order[:n] if row[k] > 0]


def cull_keyframes(m: MapState, cur_kf, cfg: EngineConfig) -> MapState:
    """Remove the most redundant keyframe (LocalMapping::KeyFrameCulling):
    >= 90% of its landmarks seen by >= 3 other keyframes at the same or finer
    scale. Culls at most one keyframe per call."""
    kfs, lms = m.kfs, m.lms
    K, F = kfs.obs_lm.shape
    L = lms.xyz.shape[0]
    dev = kfs.obs_lm.device

    obs_ok = kfs.valid[:, None] & kfs.feat_valid & (kfs.obs_lm >= 0)
    lm_of = torch.clamp(kfs.obs_lm, 0, L - 1).long()
    obs_ok = obs_ok & lms.valid[lm_of]
    n_oct = cfg.n_levels
    oc = torch.clamp(kfs.octave, 0, n_oct - 1).long()
    flat_idx = torch.where(obs_ok, lm_of, L) * n_oct + oc
    counts = ops.scatter_add(
        torch.zeros(((L + 1) * n_oct,), dtype=torch.int32, device=dev), flat_idx, 1
    ).reshape(L + 1, n_oct)[:L]
    cum = torch.cumsum(counts, dim=1)
    own_cum = cum[lm_of, oc]
    redundant_obs = obs_ok & ((own_cum - 1) >= 3)

    n_obs_kf = torch.sum(obs_ok.to(torch.int32), dim=1)
    n_red_kf = torch.sum(redundant_obs.to(torch.int32), dim=1)
    frac = n_red_kf.to(torch.float32) / torch.clamp(n_obs_kf, min=1).to(torch.float32)
    ar = torch.arange(K, device=dev)
    protected = (ar <= 1) | (ar == torch.as_tensor(cur_kf, device=dev)) | (n_obs_kf < 10)
    cull = kfs.valid & ~protected & (frac > 0.9)
    best = torch.argmax(torch.where(cull, frac, -1.0))
    do = cull[best]

    parent_of_best = kfs.parent[best]
    new_parent = torch.where(do & (kfs.parent == best), parent_of_best, kfs.parent)
    valid = kfs.valid.clone()
    valid[best] = torch.where(do, False, kfs.valid[best])
    clear = do & (ar == best)[:, None]
    obs_lm = torch.where(clear, INVALID_ID, kfs.obs_lm)
    sel = (ar == best) & do
    covis = torch.where(sel[:, None] | sel[None, :], 0, m.covis)
    safe_p = torch.clamp(parent_of_best, 0, K - 1)
    R_rp = kfs.R[best] @ kfs.R[safe_p].T
    t_rp = kfs.t[best] - R_rp @ kfs.t[safe_p]

    def set_at(x, v):
        out = x.clone()
        out[best] = torch.where(do, v, x[best])
        return out

    row = kfs.obs_lm[best]
    row_ok = do & kfs.feat_valid[best] & (row >= 0)
    sub = ops.scatter_add(
        torch.zeros((L,), dtype=torch.int32, device=dev),
        torch.where(row_ok, torch.clamp(row, 0, L - 1), L), 1,
    )
    lms2 = m.lms._replace(n_obs=torch.clamp(m.lms.n_obs - sub, min=0))
    return m._replace(
        kfs=kfs._replace(
            valid=valid, parent=new_parent, obs_lm=obs_lm,
            cull_parent=set_at(kfs.cull_parent, parent_of_best),
            cull_seq=set_at(kfs.cull_seq, kfs.seq[best]),
            cull_R=set_at(kfs.cull_R, R_rp),
            cull_t=set_at(kfs.cull_t, t_rp),
        ),
        covis=covis,
        lms=lms2,
    )


def cull_landmarks(m: MapState, cur_kf, cfg: EngineConfig) -> MapState:
    """Remove weak landmarks (LocalMapping::MapPointCulling)."""
    lms = m.lms
    ratio = lms.n_found.to(torch.float32) / torch.clamp(lms.n_visible.to(torch.float32), min=1.0)
    cur_seq = m.kfs.seq[cur_kf]
    age = cur_seq - lms.first_seq
    bad = lms.valid & (((ratio < 0.25) & (age <= 3)) | ((age >= 2) & (lms.n_obs <= 2)))
    bad = bad & (lms.first_seq != cur_seq)
    lms = lms._replace(valid=lms.valid & ~bad)
    L = lms.xyz.shape[0]
    obs = m.kfs.obs_lm
    obs_bad = (obs >= 0) & bad[torch.clamp(obs, 0, L - 1).long()]
    obs = torch.where(obs_bad, INVALID_ID, obs)
    return m._replace(kfs=m.kfs._replace(obs_lm=obs), lms=lms)


def process_new_keyframe(m: MapState, frame: FrameArrays, R, t, lm_ids, frame_id, timestamp,
                         slot: int, parent, cfg: EngineConfig, spawn_depth: bool = False,
                         n_neighbors: int = 4) -> MapState:
    """The keyframe pipeline: insert, spawn depth landmarks (stereo/RGB-D,
    ``spawn_depth``), triangulate and fuse against the top covisible
    neighbors (plus ``cfg.kf_fuse_two_hop`` of their best neighbors),
    refresh, cull."""
    with span("slam::kf_insert"):
        n_two_hop = cfg.kf_fuse_two_hop
        m = insert_keyframe(m, frame, R, t, lm_ids, frame_id, timestamp, slot, parent, cfg)
        if spawn_depth:
            m = spawn_depth_landmarks(m, slot, cfg)

        K = m.kfs.valid.shape[0]
        w = torch.where(m.kfs.valid, m.covis[slot], 0).clone()
        w[slot] = 0
        top_w, neighbors = ops.top_k(w, n_neighbors)
        neighbors = torch.where(top_w > 0, neighbors, slot)

        m = triangulate_fanout(m, slot, neighbors, cfg)

        fuse_targets = neighbors
        if n_two_hop > 0:
            one_hop = ops.scatter_set(
                torch.zeros((K,), dtype=torch.bool, device=w.device), torch.where(top_w > 0, neighbors, K), True
            )
            rows = torch.where((top_w > 0)[:, None], m.covis[neighbors], 0)
            w2 = torch.max(rows, dim=0).values
            w2 = torch.where(m.kfs.valid & ~one_hop, w2, 0).clone()
            w2[slot] = 0
            top_w2, nb2 = ops.top_k(w2, n_two_hop)
            nb2 = torch.where(top_w2 > 0, nb2, slot)
            fuse_targets = torch.cat([neighbors, nb2])

        with span("slam::fuse"):
            for nb in fuse_targets.tolist():
                if nb != slot:
                    m = fuse_landmarks_into_kf(m, slot, nb, cfg, recount=False)
                    m = fuse_landmarks_into_kf(m, nb, slot, cfg, recount=False)
        m = recount_lm_obs(m)
        m = update_covis_for_kf(m, slot)
        m = refresh_landmark_descriptors(m, slot, cfg)
        m = refresh_landmark_geometry(m, slot, cfg)
        m = cull_landmarks(m, slot, cfg)
        return cull_keyframes(m, slot, cfg)
