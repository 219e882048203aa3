"""Global bundle adjustment, its asynchronous fold, and landmark-sharded
solves (port of ``dialog_tpu/optim/global_ba.py``).

After a loop correction the engine refines the whole map: every valid
keyframe is a camera (camera index = keyframe slot, C = K) and every valid
landmark a point (P = L). Up to ``DENSE_SCHUR_MAX_CAMS`` cameras the dense
Schur LM of ``local_ba.solve_ba`` solves it (kernel C on the card); above,
the matrix-free PCG of ``schur_pcg``. The engine's asynchronous GBA runs the
PCG one LM iteration at a time and merges the result into the map as it
stands by then (``fold_gba_result``).

With a ``torch.distributed`` process group every rank builds the same
problem, keeps its contiguous slice of the landmarks (``shard_problem``) and
every camera, and the solvers sum the camera side over the ranks; the
landmarks come back whole through one ``all_reduce``
(``distributed.gather_landmarks``).
"""

from __future__ import annotations

import torch

from .. import ops
from ..config import EngineConfig
from ..containers import MapState
from ..distributed import gather_landmarks, landmark_slice
from .local_ba import BAProblem, solve_ba, write_back
from .schur_pcg import solve_ba_pcg

# camera count above which the dense reduced system gives way to the
# matrix-free Schur PCG: forming S costs O((6C)^2 3P) operations and (6C)^2
# memory, which at the KITTI00 preset's C = 2048 is 1.2e4 x 1.2e4
DENSE_SCHUR_MAX_CAMS = 192


def build_global_problem(m: MapState, cfg: EngineConfig):
    """All valid keyframes and all valid landmarks as one ``BAProblem``.

    Camera index = keyframe slot (C = max_keyframes). The first two slots
    are frozen as the gauge and scale anchor. Each landmark's observations
    are listed in keyframe order, a landmark observed twice in one keyframe
    row keeps its first feature, and observations past ``max_obs_per_lm``
    are cut. Returns ``(prob, n_dropped)``: ``n_dropped`` (a 0-d tensor)
    counts the observations cut, duplicates left out.

    The order comes from ONE stable argsort by landmark id: the flat index
    k * F + f already runs in keyframe order, so no composite (landmark,
    keyframe) key is needed, and none can overflow."""
    K, F = m.kfs.obs_lm.shape
    L = m.lms.xyz.shape[0]
    O = cfg.max_obs_per_lm
    dev = m.kfs.obs_lm.device

    cam_slots = torch.arange(K, dtype=torch.int32, device=dev)
    cam_opt = m.kfs.valid & (cam_slots >= 2)

    rows_ok = m.kfs.valid[:, None] & m.kfs.feat_valid & (m.kfs.obs_lm >= 0)
    safe = torch.clamp(m.kfs.obs_lm, 0, L - 1).long()
    li_flat = torch.where(rows_ok & m.lms.valid[safe], safe, L).reshape(-1)
    order = torch.argsort(li_flat, stable=True)
    sorted_li = li_flat[order]
    sorted_cam = order // F
    live = sorted_li < L
    # a landmark repeated within one keyframe row lands next to itself: all
    # but its first entry are duplicates
    dup = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev),
                     (sorted_li[1:] == sorted_li[:-1]) & (sorted_cam[1:] == sorted_cam[:-1])]) & live
    first = torch.searchsorted(sorted_li, sorted_li, side="left")
    # rank among the entries of the landmark's group that are not duplicates,
    # so a dropped duplicate leaves no hole in the observation list
    nd = (~dup & live).long()
    cum_excl = torch.cumsum(nd, 0) - nd
    rank = cum_excl - cum_excl[first]
    keep = live & ~dup & (rank < O)
    n_dropped = torch.sum(live & ~dup & (rank >= O))

    # the kept entries have distinct (landmark, rank) targets; every other entry
    # writes a scratch slot of its own past L x O (one shared slot would
    # serialize millions of writes at capacity)
    n = order.shape[0]
    flat = torch.where(keep, sorted_li * O + rank, L * O + torch.arange(n, device=dev))

    def place(fill, vals):
        out = torch.full((L * O + n,), fill, dtype=vals.dtype, device=dev)
        out[flat] = vals
        return out[: L * O].reshape(L, O)

    obs_cam = place(K, sorted_cam.to(torch.int32))
    obs_feat = place(0, (order % F).to(torch.int32))
    obs_ok = place(False, keep)

    safe_cam = torch.clamp(obs_cam, 0, K - 1).long()
    feat = obs_feat.long()
    obs_uv = m.kfs.uv[safe_cam, feat]
    obs_oct = m.kfs.octave[safe_cam, feat]
    obs_ur = None   # mono configurations never gather the right-x
    if cfg.bf > 0:
        obs_ur = torch.where(obs_ok, m.kfs.u_right[safe_cam, feat], -1.0)
    base = ops.scalar(cfg.scale_factor, torch.float32, dev)
    obs_w = torch.where(obs_ok, torch.pow(base, -2.0 * obs_oct.to(torch.float32)), 0.0)

    prob = BAProblem(
        cam_slots=cam_slots, cam_opt=cam_opt, R=m.kfs.R, t=m.kfs.t,
        lm_ids=torch.where(m.lms.valid, torch.arange(L, dtype=torch.int32, device=dev), L),
        xyz=m.lms.xyz, obs_cam=obs_cam, obs_uv=obs_uv, obs_w=obs_w, obs_ok=obs_ok, obs_feat=obs_feat,
        obs_ur=obs_ur,
    )
    return prob, n_dropped


def shard_problem(prob: BAProblem, group) -> BAProblem:
    """This rank's share of a global problem: its contiguous slice of the
    landmarks (``distributed.landmark_slice``), padded to the same count on
    every rank with landmarks that have no observation; every camera. The
    padding's landmark id is P, the global problem's own padding id (P = L)."""
    import torch.distributed as dist

    C = prob.cam_slots.shape[0]
    P = prob.lm_ids.shape[0]
    lo, hi, per = landmark_slice(P, dist.get_rank(group), dist.get_world_size(group))

    def cut(x, fill):
        if x is None:
            return None
        out = torch.full((per,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        out[: hi - lo] = x[lo:hi]
        return out

    return prob._replace(
        lm_ids=cut(prob.lm_ids, P), xyz=cut(prob.xyz, 0.0), obs_cam=cut(prob.obs_cam, C),
        obs_uv=cut(prob.obs_uv, 0.0), obs_w=cut(prob.obs_w, 0.0), obs_ok=cut(prob.obs_ok, False),
        obs_feat=cut(prob.obs_feat, 0), obs_ur=cut(prob.obs_ur, -1.0), lm_opt=cut(prob.lm_opt, False),
    )


class GBASnapshot:
    """Identity snapshot taken when an asynchronous GBA starts.

    Keyframes are known by their insertion number (``seq``) and landmarks
    by ``(first_seq, ref_kf)``; both survive slot recycling, so a slot culled
    and reused while the GBA runs is seen as a new entity and re-anchored,
    not overwritten with a stale optimum."""

    __slots__ = ("kf_seq", "kf_valid", "lm_valid", "lm_first_seq", "lm_ref")

    def __init__(self, m: MapState):
        self.kf_seq = m.kfs.seq.clone()
        self.kf_valid = m.kfs.valid.clone()
        self.lm_valid = m.lms.valid.clone()
        self.lm_first_seq = m.lms.first_seq.clone()
        self.lm_ref = m.lms.ref_kf.clone()


def fold_gba_result(m: MapState, kf_seq_snap, kf_valid_snap, lm_valid_snap, lm_first_snap, lm_ref_snap,
                    R_opt, t_opt, xyz_opt) -> MapState:
    """Merge an asynchronously computed GBA result into the live map.

    Keyframes that existed at snapshot time take their optimized pose;
    keyframes created meanwhile (or recycled slots) walk the spanning tree
    to their nearest snapshot ancestor ``a`` and keep their pose relative to
    it (``T_new = T_cur T_a_cur^-1 T_a_opt``). Snapshot landmarks take
    ``xyz_opt``; new landmarks move with their reference keyframe's anchor
    (``X_new = T_a_opt^-1 (T_a_cur X)``). One masked pass on the device
    (the reference: ``LoopClosing::RunGlobalBundleAdjustment``'s merge)."""
    K = m.kfs.valid.shape[0]
    same_kf = m.kfs.valid & kf_valid_snap & (m.kfs.seq == kf_seq_snap)

    # nearest snapshot ancestor along the parent tree: a bounded walk, since
    # the keyframes made during one GBA form a short chain
    anchor = torch.arange(K, dtype=torch.int32, device=m.kfs.valid.device)
    for _ in range(16):
        a = torch.clamp(anchor, 0, K - 1).long()
        anchor = torch.where((anchor >= 0) & ~same_kf[a], m.kfs.parent[a], anchor)
    a = torch.clamp(anchor, 0, K - 1).long()
    anchored = (anchor >= 0) & same_kf[a]

    R_cur, t_cur = m.kfs.R, m.kfs.t
    Ra_cur, ta_cur = R_cur[a], t_cur[a]
    Ra_opt, ta_opt = R_opt[a], t_opt[a]
    # T_rel = T_cur o T_a_cur^-1 ; T_new = T_rel o T_a_opt
    R_rel = torch.einsum("kij,kmj->kim", R_cur, Ra_cur)
    t_rel = t_cur - torch.einsum("kij,kj->ki", R_rel, ta_cur)
    R_reb = torch.einsum("kij,kjm->kim", R_rel, Ra_opt)
    t_reb = torch.einsum("kij,kj->ki", R_rel, ta_opt) + t_rel

    new_kf = m.kfs.valid & ~same_kf & anchored
    R_out = torch.where(same_kf[:, None, None], R_opt, torch.where(new_kf[:, None, None], R_reb, R_cur))
    t_out = torch.where(same_kf[:, None], t_opt, torch.where(new_kf[:, None], t_reb, t_cur))

    same_lm = m.lms.valid & lm_valid_snap & (m.lms.first_seq == lm_first_snap) & (m.lms.ref_kf == lm_ref_snap)
    ref = torch.clamp(m.lms.ref_kf, 0, K - 1).long()
    la = torch.clamp(anchor[ref], 0, K - 1).long()
    la_ok = (m.lms.ref_kf >= 0) & (anchor[ref] >= 0) & same_kf[la]
    X = m.lms.xyz
    Xc = torch.einsum("lij,lj->li", R_cur[la], X) + t_cur[la]
    X_reb = torch.einsum("lji,lj->li", R_opt[la], Xc - t_opt[la])
    new_lm = m.lms.valid & ~same_lm & la_ok
    xyz_out = torch.where(same_lm[:, None], xyz_opt, torch.where(new_lm[:, None], X_reb, X))
    return m._replace(kfs=m.kfs._replace(R=R_out, t=t_out), lms=m.lms._replace(xyz=xyz_out))


def solve_global_problem(part: BAProblem, cfg: EngineConfig, iters: int, group=None, cg_iters: int = 48,
                         cg_tol: float = 1e-6):
    """The global BA's solve of a problem or of this rank's landmark slice of
    it: ``local_ba.solve_ba`` (kernel C at C = K on the card) up to
    ``DENSE_SCHUR_MAX_CAMS`` cameras, the PCG above, with the mono robust
    threshold. Returns (R, t, xyz of the slice, cost)."""
    if part.cam_slots.shape[0] > DENSE_SCHUR_MAX_CAMS:
        return solve_ba_pcg(part, cfg, iters=iters, chi2_th=cfg.chi2_mono, cg_iters=cg_iters, cg_tol=cg_tol,
                            group=group)
    return solve_ba(part, cfg, iters=iters, chi2_th=cfg.chi2_mono, group=group)


def global_bundle_adjustment(m: MapState, cfg: EngineConfig, iters: int = 20, group=None,
                             stats: dict | None = None, cg_iters: int = 48, cg_tol: float = 1e-6) -> MapState:
    """Full-map BA, written back into the map (outlier observations
    stripped, as local BA does). At most ``DENSE_SCHUR_MAX_CAMS`` cameras:
    ``local_ba.solve_ba`` (kernel C at C = K on the card); above: the PCG,
    with ``cg_iters`` and ``cg_tol`` its CG budget per LM iteration (as in
    ``schur_pcg.solve_ba_pcg``). With a process group each rank solves on
    its landmark slice and every rank gets the whole result. ``stats`` (the
    engine's) counts the observations cut from the problem under
    ``"gba_obs_dropped"`` (one host read)."""
    prob, n_dropped = build_global_problem(m, cfg)
    if stats is not None:
        stats["gba_obs_dropped"] = stats.get("gba_obs_dropped", 0) + int(n_dropped)
    part = prob if group is None else shard_problem(prob, group)
    R, t, xyz, _ = solve_global_problem(part, cfg, iters, group, cg_iters, cg_tol)
    xyz = gather_landmarks(xyz, prob.lm_ids.shape[0], group)
    return write_back(m, prob, R, t, xyz, cfg, chi2_th=cfg.chi2_mono)
