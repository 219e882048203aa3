"""Loop detection and closure (port of ``dialog_tpu/loopclosing.py``).

Per keyframe: BoW candidate retrieval (one product against the keyframe BoW
database), the 3-consecutive covisibility-consistency gate on the host, the
Sim3 RANSAC between the two ends and its image-space refinement, a guided
match through the refined Sim3 (kernel B on the card), then the Sim3
essential-graph optimization and the landmark correction.

A detection is dispatched at one keyframe and evaluated at the next
(``LoopCloser.detect``); the batched entry hands the dispatched tensors to
the batch's own host pull instead (``take_pending``), so they cost no copy of
their own. ``compute_sim3`` reads the host four times per candidate (the
match count, RANSAC's success, the refined inlier count and the guided
count), as the reference does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import geometry as geo
from . import matching
from . import vocab as _vocab
from .config import EngineConfig, Sensor
from .containers import MapState, update_covis_for_kf
from .mapping import fuse_landmarks_into_kf
from .optim.pose_graph import apply_pose_graph_correction, build_pose_graph, solve_pose_graph
from .sim3 import draw_sim3_sets, refine_sim3_reproj, solve_sim3_ransac


def _pack_detect(m: MapState, bow_db: torch.Tensor, cur_kf: int):
    """One f32 vector [5K]: BoW scores against every keyframe, the
    covisibility row, validity, insertion numbers and shared-word counts (one
    product of the database's word sets with the query's); plus the uint8
    [K, K] covisibility adjacency the host's consistency check reads."""
    q = bow_db[cur_kf]
    scores = _vocab.bow_l1_scores(q, bow_db)
    common = (bow_db > 0).to(torch.float32) @ (q > 0).to(torch.float32)
    vec = torch.cat([
        scores,
        m.covis[cur_kf].to(torch.float32),
        m.kfs.valid.to(torch.float32),
        # insertion numbers: slot indices stop being age-ordered once culled
        # slots are recycled, so the "too recent" gate keys on seq
        m.kfs.seq.to(torch.float32),
        common,
    ])
    neigh = (m.covis > 0) & m.kfs.valid[None, :]
    return vec, neigh.to(torch.uint8)


def _guided_sim3_matches(m: MapState, cur_kf: int, cand_kf: int, s21, R21, t21, cfg: EngineConfig) -> torch.Tensor:
    """Count current-keyframe features matched to the candidate's landmarks
    under the refined Sim3 (reference: ``ORBmatcher::SearchBySim3``): the
    landmarks go through the candidate's camera and S21^-1 into the current
    camera, are projected, and matched in a window of radius 8 (scaled by
    octave, within 2 octaves) through ``match_projected``, kernel B's mutual
    mode on the card. Returns an i32 count on the device."""
    kfs, lms = m.kfs, m.lms
    L = lms.xyz.shape[0]
    obs_k = kfs.obs_lm[cand_kf]
    ids = torch.clamp(obs_k, 0, L - 1).long()
    ok_k = kfs.feat_valid[cand_kf] & (obs_k >= 0) & lms.valid[ids]
    Xk = geo.se3_apply(kfs.R[cand_kf], kfs.t[cand_kf], lms.xyz[ids])
    s12, R12, t12 = geo.sim3_inv(s21, R21, t21)
    X1 = geo.sim3_apply(s12, R12, t12, Xk)
    dev = X1.device
    uv_pred, z = geo.project(torch.eye(3, dtype=torch.float32, device=dev), torch.zeros(3, dtype=torch.float32,
                             device=dev), X1, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    vis = (ok_k & (z > 1e-3) & (uv_pred[:, 0] >= 0) & (uv_pred[:, 0] < cfg.width)
           & (uv_pred[:, 1] >= 0) & (uv_pred[:, 1] < cfg.height))
    match_ft, _ = matching.match_projected(
        lms.desc[ids], uv_pred, vis, kfs.octave[cand_kf],
        kfs.desc[cur_kf], kfs.uv[cur_kf], kfs.feat_valid[cur_kf], kfs.octave[cur_kf],
        radius=8.0, scale_factor=cfg.scale_factor, max_dist=cfg.th_high, ratio=1.0, octave_band=2,
    )
    return (match_ft >= 0).sum(dtype=torch.int32)


@dataclasses.dataclass
class LoopCandidate:
    cand_kf: int
    s: float            # S21: current camera -> candidate camera similarity
    R: np.ndarray
    t: np.ndarray
    n_inliers: int


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class LoopCloser:
    """Host-side consistency bookkeeping and the tensor steps it calls."""

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        # (group of insertion numbers, count) from the previous evaluation
        self._consistent: list[tuple[set[int], int]] = []
        self.closed_loops: list[tuple[int, int]] = []
        # monotonic insertion stamps (kf_count at dispatch), not slot ids:
        # slot recycling makes slot numbers unusable for "how long ago"
        self._last_loop_stamp = -(10**9)
        self._eval_stamp = -(10**9)
        self.last_eval_det_seq: int | None = None
        # detection dispatched at one keyframe, evaluated at the next:
        # (keyframe, packed vector, neighbour matrix, stamp), on the device
        self._pending_detect: tuple[int, torch.Tensor, torch.Tensor, int] | None = None

    # --- detection (reference: LoopClosing::DetectLoop) -----------------

    def dispatch(self, m: MapState, bow_db, vocab, cur_kf: int, stamp: int | None = None) -> None:
        """Queue detection for ``cur_kf``: device work only, nothing read.
        ``stamp`` is a monotonic insertion counter (the engine's kf_count)
        that gates the cooldown after a closure; ``cur_kf`` by default."""
        if stamp is None:
            stamp = cur_kf
        if bow_db is not None and vocab is not None and stamp - self._last_loop_stamp >= 10:
            vec, neigh = _pack_detect(m, bow_db, cur_kf)
            self._pending_detect = (cur_kf, vec, neigh, stamp)

    def take_pending(self):
        """Hand the pending detection to a caller that pulls it together
        with its own transfer (the batched resolve)."""
        prev = self._pending_detect
        self._pending_detect = None
        return prev

    def detect(self, m: MapState, bow_db, vocab, cur_kf: int,
               stamp: int | None = None) -> tuple[int, list[tuple[int, int]]]:
        """Dispatch detection for ``cur_kf``; pull, evaluate and return the
        previous keyframe's as (that keyframe, [(candidate slot, seq), ...])."""
        prev = self.take_pending()
        self.dispatch(m, bow_db, vocab, cur_kf, stamp=stamp)
        if prev is None:
            return -1, []
        return prev[0], self.evaluate(prev[0], _host(prev[1]), _host(prev[2]), stamp=prev[3])

    def evaluate(self, cur_kf: int, packed: np.ndarray, neigh_mat, stamp: int | None = None) -> list[tuple[int, int]]:
        """Host-side candidate gating on a pulled detection vector and its
        uint8 [K, K] neighbour matrix. Returns the accepted candidates as
        (slot, insertion seq): evaluated a keyframe after dispatch, a slot may
        have been culled and recycled since, so callers drop any candidate
        whose current seq differs."""
        K = neigh_mat.shape[0]
        self._eval_stamp = stamp if stamp is not None else cur_kf
        # the detecting keyframe's own insertion number at dispatch, so the
        # caller can reject the detection if ITS slot was recycled
        self.last_eval_det_seq = int(packed[3 * K + cur_kf])
        scores = packed[:K].copy()
        covis_row = packed[K : 2 * K]
        kf_valid = packed[2 * K : 3 * K] > 0.5
        seq = packed[3 * K : 4 * K].astype(np.int64)
        common = packed[4 * K : 5 * K] if len(packed) >= 5 * K else None
        neighbors = (covis_row > 0) & kf_valid
        scores[~kf_valid] = -1.0
        scores[cur_kf] = -1.0
        # the least score among strongly covisible neighbours is the gate
        neigh_scores = scores[neighbors & (covis_row >= 15)]
        min_score = float(neigh_scores.min()) if len(neigh_scores) else 0.3
        # candidates: non-neighbours above the gate, not inserted too recently
        recent = seq > seq[cur_kf] - 8
        cand_mask = (scores >= max(min_score, 0.05)) & ~neighbors & ~recent
        # shared-word gate: > 0.8 of the most words shared with any candidate
        if common is not None and cand_mask.any():
            max_cw = float(common[cand_mask].max())
            if max_cw > 0:
                cand_mask &= common >= 0.8 * max_cw
        cands = np.nonzero(cand_mask)[0]

        # accumulated covisibility-group scores: keep groups >= 0.75 of the
        # best, each group's best member
        covis_np = np.asarray(neigh_mat) if len(cands) else None
        if len(cands) > 1:
            acc = np.empty(len(cands), np.float32)
            best_member = np.empty(len(cands), np.int64)
            cand_set = cand_mask.copy()
            for idx, c in enumerate(cands):
                group = (covis_np[int(c)] > 0) & cand_set
                group[int(c)] = True
                members = np.nonzero(group)[0]
                acc[idx] = float(scores[members].sum())
                best_member[idx] = members[np.argmax(scores[members])]
            keep = acc >= 0.75 * float(acc.max())
            cands = np.unique(best_member[keep])

        # 3-consecutive-keyframe covisibility consistency; groups are keyed
        # on insertion numbers, so a recycled slot cannot fake continuity
        accepted = []
        new_groups: list[tuple[set[int], int]] = []
        for c in cands:
            group_slots = np.nonzero((covis_np[int(c)] > 0) & kf_valid)[0]
            group = {int(seq[s]) for s in group_slots}
            group.add(int(seq[c]))
            count = 1
            for prev_group, prev_count in self._consistent:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count >= self.cfg.covis_consistency_th:
                accepted.append((int(c), int(seq[c])))
        self._consistent = new_groups
        return accepted

    # --- Sim3 computation (reference: LoopClosing::ComputeSim3) ---------

    def compute_sim3(self, m: MapState, cur_kf: int, cand_kf: int, pick: torch.Tensor | None = None,
                     generator: torch.Generator | None = None) -> LoopCandidate | None:
        """The similarity between the two keyframes, or None: a dense mutual
        descriptor match (>= 20), Sim3 RANSAC on the matched landmarks in the
        two cameras' frames (>= 20 inliers; hypotheses ``pick``, else drawn
        from ``generator``), the image-space refinement (>= 20 inliers), and
        the guided match under the refined Sim3 (>= ``loop_min_matches``)."""
        cfg = self.cfg
        kfs, lms = m.kfs, m.lms
        L = lms.xyz.shape[0]
        obs_c = kfs.obs_lm[cur_kf]
        obs_k = kfs.obs_lm[cand_kf]
        ok_c = kfs.feat_valid[cur_kf] & (obs_c >= 0) & lms.valid[torch.clamp(obs_c, 0, L - 1).long()]
        ok_k = kfs.feat_valid[cand_kf] & (obs_k >= 0) & lms.valid[torch.clamp(obs_k, 0, L - 1).long()]
        dist = matching.hamming_distance_matrix(kfs.desc[cur_kf], kfs.desc[cand_kf])
        mb, _ = matching.match_mutual(dist, ok_c, ok_k, max_dist=cfg.th_low, ratio=0.75)
        has = mb >= 0
        if int(has.sum()) < 20:                                  # host read 1
            return None

        jb = torch.clamp(mb, 0, obs_k.shape[0] - 1).long()
        X_cur_w = lms.xyz[torch.clamp(obs_c, 0, L - 1).long()]
        X_cand_w = lms.xyz[torch.clamp(obs_k[jb], 0, L - 1).long()]
        # camera-frame points at the two ends (their drifted world frames differ)
        X1 = geo.se3_apply(kfs.R[cur_kf], kfs.t[cur_kf], X_cur_w)
        X2 = geo.se3_apply(kfs.R[cand_kf], kfs.t[cand_kf], X_cand_w)
        fix_scale = cfg.sensor != Sensor.MONOCULAR
        if pick is None:
            pick = draw_sim3_sets(has, cfg.sim3_ransac_iters, generator)
        res = solve_sim3_ransac(X1, X2, has, pick, fix_scale=fix_scale, min_inliers=20)
        if not bool(res.success):                                # host read 2
            return None
        s2, R2, t2, _, n_inl = refine_sim3_reproj(
            res.s, res.R, res.t, X1, X2, kfs.uv[cur_kf], kfs.uv[cand_kf][jb], res.inliers,
            cfg.fx, cfg.fy, cfg.cx, cfg.cy, fix_scale=fix_scale,
        )
        n_inl = int(n_inl)                                       # host read 3
        if n_inl < 20:
            return None
        # the guided pass must clear loop_min_matches before a closure commits
        n_guided = int(_guided_sim3_matches(m, cur_kf, cand_kf, s2, R2, t2, cfg))   # host read 4
        if n_guided < cfg.loop_min_matches:
            return None
        return LoopCandidate(cand_kf=cand_kf, s=float(s2), R=_host(R2), t=_host(t2), n_inliers=n_inl)

    # --- correction (reference: LoopClosing::CorrectLoop) ---------------

    def correct(self, m: MapState, cur_kf: int, loop: LoopCandidate, cfg: EngineConfig,
                pose_graph_iters: int = 15) -> MapState:
        """Pose-graph optimize with the loop edge, move the landmarks, fuse
        duplicates across the closed junction both ways and refresh the two
        keyframes' covisibility."""
        # the loop edge S_ij = S_i o S_j^-1 with i = cur, j = cand is S21^-1
        dev = m.kfs.R.device
        s_m, R_m, t_m = geo.sim3_inv(torch.tensor(loop.s, dtype=torch.float32, device=dev),
                                     torch.as_tensor(loop.R).to(dev), torch.as_tensor(loop.t).to(dev))
        prob = build_pose_graph(m, cfg, loop_i=cur_kf, loop_j=loop.cand_kf, loop_s=s_m, loop_R=R_m, loop_t=t_m,
                                fixed_kf=loop.cand_kf)
        s, R, t, _ = solve_pose_graph(prob, iters=pose_graph_iters)
        m = apply_pose_graph_correction(m, s, R, t, cfg)
        m = fuse_landmarks_into_kf(m, loop.cand_kf, cur_kf, cfg)
        m = fuse_landmarks_into_kf(m, cur_kf, loop.cand_kf, cfg)
        m = update_covis_for_kf(m, cur_kf)
        m = update_covis_for_kf(m, loop.cand_kf)
        self.closed_loops.append((cur_kf, loop.cand_kf))
        self._last_loop_stamp = self._eval_stamp
        self._consistent = []
        return m
