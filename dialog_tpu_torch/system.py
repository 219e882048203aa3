"""Engine facade: the per-frame SLAM engine (port of ``dialog_tpu/system.py``).

Monocular, stereo and RGB-D entry points. A monocular engine bootstraps
from two views; a stereo or RGB-D one from its first frame with enough
depth, and tracks and bundle-adjusts with the stereo (uR) rows.

The host runs the scalar state machine (NOT_INITIALIZED / OK / LOST) and
calls the tensor steps; the map lives on ``device`` as a ``MapState``. Per
tracked frame the host reads one packed vector (pose, relative pose, counts).

This engine has no place recognition yet: no vocabulary, no relocalization,
no loop closing and no global BA. A LOST frame retries tracking from the last
pose, which is what the reference does until its vocabulary exists
(``vocab_min_kfs`` keyframes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import geometry as geo
from . import mapping, matching, tracking
from .config import EngineConfig, Sensor
from .containers import INVALID_ID, FrameArrays, MapMeta, MapState, empty_map, pack_map_meta
from .frontend import extract_features
from .init2view import initialize_two_view
from .optim.local_ba import local_bundle_adjustment
from .stereo import depth_from_rgbd, stereo_match_frames

NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
LOST = "LOST"


@dataclasses.dataclass
class FrameRecord:
    """Per-frame output. ``R_rel/t_rel`` hold the pose relative to keyframe
    ``ref_kf`` (T_cr = T_cw o T_rw^-1), so later keyframe corrections reach
    every frame in ``final_poses``."""

    frame_id: int
    timestamp: float
    R: np.ndarray
    t: np.ndarray
    state: str
    n_tracked: int
    ref_kf: int = -1
    R_rel: np.ndarray | None = None
    t_rel: np.ndarray | None = None


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Engine:
    """SLAM engine on one device.

    Usage::

        eng = Engine(config, device="cuda")
        for img, ts in frames:
            rec = eng.track_image(img, ts)   # track_stereo / track_rgbd by cfg.sensor
        eng.save_trajectory_tum(path)
    """

    def __init__(self, cfg: EngineConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.m: MapState = empty_map(cfg, device=self.device)
        self.state = NOT_INITIALIZED
        self.frame_id = 0
        self.kf_count = 0
        self.ref_kf = 0
        self.last_kf_frame_id = -(10**9)
        self.last_kf_tracked = 0
        self.kf_interval = cfg.max_frames_between_kf
        self.stats = {"lm_dropped": 0, "kf_slot_full": 0}
        self._init_frame: Optional[FrameArrays] = None
        self._init_ts = 0.0
        self._init_fid = 0
        self._last_lm_ids = None
        self._last_R = np.eye(3, dtype=np.float32)
        self._last_t = np.zeros(3, dtype=np.float32)
        self._vel: Optional[tuple[np.ndarray, np.ndarray]] = None
        self.trajectory: list[FrameRecord] = []
        # RANSAC minimal sets come from this generator (the reference's
        # PRNGKey(n_features); the two streams differ by construction)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.n_features)
        # keyframe slot recycling: host view of live slots + allocations the
        # last device snapshot has not confirmed yet (slot -> expected seq)
        self._kf_valid_host = np.zeros(cfg.max_keyframes, bool)
        self._recent_kf_allocs: dict[int, int] = {}
        self._seq_next = 0
        self._recs_by_ref: dict[int, list[FrameRecord]] = {}

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def track_image(self, img, timestamp: float) -> FrameRecord:
        """Monocular image entry (reference: System::TrackMonocular)."""
        img = torch.as_tensor(img, dtype=torch.float32).to(self.device)
        frame = self._undistort(extract_features(img, self.cfg))
        return self.track_features(frame, timestamp)

    def track_stereo(self, img_left, img_right, timestamp: float) -> FrameRecord:
        """Stereo pair entry (reference: System::TrackStereo)."""
        img_left = torch.as_tensor(img_left, dtype=torch.float32).to(self.device)
        img_right = torch.as_tensor(img_right, dtype=torch.float32).to(self.device)
        left = extract_features(img_left, self.cfg)
        right = extract_features(img_right, self.cfg)
        left = stereo_match_frames(left, right, self.cfg, img_left=img_left, img_right=img_right)
        return self.track_features(self._undistort(left), timestamp)

    def track_rgbd(self, img, depth_img, timestamp: float) -> FrameRecord:
        """RGB-D entry (reference: System::TrackRGBD); ``depth_img`` in the
        sensor's units (metres x cfg.depth_map_factor)."""
        img = torch.as_tensor(img, dtype=torch.float32).to(self.device)
        depth_img = torch.as_tensor(depth_img, dtype=torch.float32).to(self.device)
        frame = depth_from_rgbd(extract_features(img, self.cfg), depth_img, self.cfg)
        return self.track_features(self._undistort(frame), timestamp)

    def track_features(self, frame: FrameArrays, timestamp: float) -> FrameRecord:
        """Track a pre-extracted feature frame (also the synthetic-data entry)."""
        if self.state == NOT_INITIALIZED:
            rec = self._initialize(frame, timestamp)
        else:
            rec = self._track(frame, timestamp)
        self._append_record(rec)
        self.frame_id += 1
        return rec

    def final_poses(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Per-frame world->camera poses composed against the current map."""
        kf_R = _host(self.m.kfs.R)
        kf_t = _host(self.m.kfs.t)
        out = []
        for r in self.trajectory:
            if r.ref_kf >= 0 and r.R_rel is not None:
                Rr, tr = kf_R[r.ref_kf], kf_t[r.ref_kf]
                out.append((r.R_rel @ Rr, r.R_rel @ tr + r.t_rel))
            else:
                out.append((r.R, r.t))
        return out

    def save_trajectory_tum(self, path: str) -> None:
        from .eval.trajectory import save_tum

        poses = self.final_poses()
        save_tum(path, [r.timestamp for r in self.trajectory], [p[0] for p in poses], [p[1] for p in poses])

    @property
    def positions(self) -> np.ndarray:
        """Camera centers [N, 3] (world frame), BA-corrected."""
        out = [-R.T @ t for R, t in self.final_poses()]
        return np.stack(out) if out else np.zeros((0, 3))

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _undistort(self, frame: FrameArrays) -> FrameArrays:
        c = self.cfg
        if c.k1 == 0.0 and c.k2 == 0.0 and c.p1 == 0.0 and c.p2 == 0.0:
            return frame
        uv = geo.undistort_points(frame.uv_raw, c.fx, c.fy, c.cx, c.cy, c.k1, c.k2, c.p1, c.p2, c.k3)
        return frame._replace(uv=uv)

    def _record(self, ts, R, t, n_tracked=0, ref_kf=-1) -> FrameRecord:
        R, t = _host(R), _host(t)
        R_rel = t_rel = None
        if ref_kf >= 0:
            Rr = _host(self.m.kfs.R[ref_kf])
            tr = _host(self.m.kfs.t[ref_kf])
            R_rel = R @ Rr.T
            t_rel = t - R_rel @ tr
        return FrameRecord(
            frame_id=self.frame_id, timestamp=ts, R=R, t=t, state=self.state,
            n_tracked=int(n_tracked), ref_kf=int(ref_kf), R_rel=R_rel, t_rel=t_rel,
        )

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32)).to(self.device)

    # --- keyframe slot recycling ----------------------------------------
    # Culling runs inside keyframe processing; the host learns of it from
    # the map-meta snapshot and re-anchors records of a culled keyframe to
    # its spanning-tree parent (reference: SaveTrajectoryTUM's bad-KF walk).

    def _append_record(self, rec: FrameRecord) -> None:
        self.trajectory.append(rec)
        if rec.ref_kf >= 0:
            self._recs_by_ref.setdefault(rec.ref_kf, []).append(rec)

    def _kf_slot_view(self) -> np.ndarray:
        mask = self._kf_valid_host.copy()
        for s in self._recent_kf_allocs:
            mask[s] = True
        return mask

    def _has_free_kf_slot(self) -> bool:
        return bool((~self._kf_slot_view()).any())

    def _alloc_kf_slot(self) -> int | None:
        free = np.nonzero(~self._kf_slot_view())[0]
        if len(free) == 0:
            return None
        slot = int(free[0])
        self._mark_kf_slot(slot)
        return slot

    def _mark_kf_slot(self, slot: int) -> None:
        self._recent_kf_allocs[slot] = self._seq_next
        self._seq_next += 1
        self._kf_valid_host[slot] = True

    def _observe_kf_meta(self, meta: MapMeta) -> None:
        """Fold a device keyframe snapshot into the host slot view and
        re-anchor trajectory records whose reference keyframe was culled."""
        self.stats["lm_dropped"] = max(self.stats["lm_dropped"], meta.lm_dropped)
        for s, expected in list(self._recent_kf_allocs.items()):
            if meta.seq[s] >= expected:
                del self._recent_kf_allocs[s]
        pending = self._recent_kf_allocs
        newly_dead = [
            int(s) for s in np.nonzero(self._kf_valid_host & ~meta.valid)[0] if int(s) not in pending
        ]
        self._kf_valid_host = meta.valid.copy()
        for s in pending:
            self._kf_valid_host[s] = True

        for s in newly_dead:
            recs = self._recs_by_ref.pop(s, [])
            if not recs:
                continue
            hop = self._chain_to_live(meta, s)
            if hop is None:
                for rec in recs:
                    if rec.R_rel is None:
                        continue
                    rec.R = rec.R_rel @ meta.R[s]
                    rec.t = rec.R_rel @ meta.t[s] + rec.t_rel
                    rec.ref_kf, rec.R_rel, rec.t_rel = -1, None, None
                continue
            p, R_rp, t_rp = hop
            keep = self._recs_by_ref.setdefault(p, [])
            for rec in recs:
                if rec.R_rel is not None:
                    rec.t_rel = rec.R_rel @ t_rp + rec.t_rel
                    rec.R_rel = rec.R_rel @ R_rp
                rec.ref_kf = p
                keep.append(rec)

    @staticmethod
    def _chain_to_live(meta: MapMeta, s: int):
        """Walk cull records from dead slot ``s`` to a live ancestor:
        (anchor_slot, R_sp, t_sp), or None when no record exists."""
        if meta.cull_parent[s] < 0 or meta.cull_seq[s] != meta.seq[s]:
            return None
        p = int(meta.cull_parent[s])
        R_sp = meta.cull_R[s]
        t_sp = meta.cull_t[s]
        for _ in range(meta.valid.shape[0]):
            if p < 0:
                return None
            if meta.valid[p]:
                return p, R_sp, t_sp
            if meta.cull_parent[p] < 0 or meta.cull_seq[p] != meta.seq[p]:
                return None
            t_sp = R_sp @ meta.cull_t[p] + t_sp
            R_sp = R_sp @ meta.cull_R[p]
            p = int(meta.cull_parent[p])
        return None

    def _refresh_kf_meta_blocking(self) -> None:
        self._observe_kf_meta(MapMeta(pack_map_meta(self.m), self.cfg.max_keyframes))

    # --- monocular initialization (reference: MonocularInitialization) ---

    def _initialize(self, frame: FrameArrays, ts: float) -> FrameRecord:
        cfg = self.cfg
        if cfg.sensor != Sensor.MONOCULAR:
            return self._initialize_depth(frame, ts)
        n_valid = int(frame.valid.sum())
        if self._init_frame is None or n_valid < cfg.init_min_features:
            self._set_init_frame(frame, ts, n_valid)
            return self._record(ts, np.eye(3), np.zeros(3))

        init = self._init_frame
        mb, _ = matching.match_window(
            init.desc, init.uv, init.valid, frame.desc, frame.uv, frame.valid,
            radius=100.0, max_dist=cfg.th_low, ratio=cfg.nn_ratio_init,
            angle_a=init.angle, angle_b=frame.angle,
        )
        ok = mb >= 0
        if int(ok.sum()) < cfg.init_min_matches:
            self._set_init_frame(frame, ts, n_valid)
            return self._record(ts, np.eye(3), np.zeros(3))

        F = frame.uv.shape[0]
        jb = torch.clamp(mb, 0, F - 1).long()
        res = initialize_two_view(
            init.uv, frame.uv[jb], ok, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
            iters=cfg.init_ransac_iters, min_good=cfg.init_min_good, generator=self._gen,
        )
        if not bool(res.success):
            if self.frame_id - self._init_fid > 20:
                self._set_init_frame(frame, ts, n_valid)
            return self._record(ts, np.eye(3), np.zeros(3))

        # --- the initial map (CreateInitialMapMonocular) ------------------
        good = _host(res.good)
        z = _host(res.points)[:, 2]
        med = float(np.median(z[good])) if good.any() else 1.0
        med = max(med, 1e-6)
        X = res.points / med
        R1 = res.R
        t1 = res.t / med
        dev = self.device
        eye3 = torch.eye(3, dtype=torch.float32, device=dev)
        zero3 = torch.zeros(3, dtype=torch.float32, device=dev)

        m, slot_of = mapping.alloc_landmarks(self.m, X, init.desc, init.octave, res.good, 0, zero3, cfg)
        L = cfg.max_landmarks
        lm0 = torch.where(res.good & (slot_of < L), slot_of, INVALID_ID).to(torch.int32)
        lm1 = torch.full((F,), INVALID_ID, dtype=torch.int32, device=dev)
        from .ops import scatter_set

        lm1 = scatter_set(lm1, torch.where(lm0 >= 0, jb, F), torch.where(lm0 >= 0, lm0, INVALID_ID))
        m = mapping.insert_keyframe(m, init, eye3, zero3, lm0, self._init_fid, self._init_ts, 0, -1, cfg)
        m = mapping.insert_keyframe(m, frame, R1, t1, lm1, self.frame_id, ts, 1, 0, cfg)
        self.m = m
        self.kf_count = 2
        self._mark_kf_slot(0)
        self._mark_kf_slot(1)
        self.ref_kf = 1
        self.last_kf_frame_id = self.frame_id
        self.state = OK
        self._last_lm_ids = lm1
        self._last_R = _host(R1)
        self._last_t = _host(t1)
        self._vel = None
        n_pts = int((lm1 >= 0).sum())
        self.last_kf_tracked = n_pts
        return self._record(ts, self._last_R, self._last_t, n_pts, ref_kf=1)

    def _initialize_depth(self, frame: FrameArrays, ts: float) -> FrameRecord:
        """Stereo/RGB-D bootstrap: the first frame with enough depth becomes
        keyframe 0 and spawns landmarks directly (reference: StereoInitialization)."""
        cfg = self.cfg
        if int((frame.valid & (frame.depth > 0)).sum()) < cfg.init_min_features:
            return self._record(ts, np.eye(3), np.zeros(3))
        dev = self.device
        eye3 = torch.eye(3, dtype=torch.float32, device=dev)
        zero3 = torch.zeros(3, dtype=torch.float32, device=dev)
        lm_none = torch.full((frame.uv.shape[0],), INVALID_ID, dtype=torch.int32, device=dev)
        m = mapping.insert_keyframe(self.m, frame, eye3, zero3, lm_none, self.frame_id, ts, 0, -1, cfg)
        self.m = mapping.spawn_depth_landmarks(m, 0, cfg)
        self.kf_count = 1
        self._mark_kf_slot(0)
        self.ref_kf = 0
        self.last_kf_frame_id = self.frame_id
        self.state = OK
        self._last_lm_ids = self.m.kfs.obs_lm[0]
        self._last_R = np.eye(3, dtype=np.float32)
        self._last_t = np.zeros(3, dtype=np.float32)
        self._vel = None
        n_pts = int((self._last_lm_ids >= 0).sum())
        self.last_kf_tracked = n_pts
        return self._record(ts, self._last_R, self._last_t, n_pts, ref_kf=0)

    def _set_init_frame(self, frame, ts, n_valid):
        self._init_frame = frame if n_valid >= self.cfg.init_min_features else None
        self._init_ts = ts
        self._init_fid = self.frame_id

    # --- per-frame tracking (reference: Track() with state OK) -----------

    def _track(self, frame: FrameArrays, ts: float) -> FrameRecord:
        cfg = self.cfg
        # a LOST frame retries tracking from the last known pose
        if self._vel is not None:
            Rv, tv = self._vel
            R_pred = Rv @ self._last_R
            t_pred = Rv @ self._last_t + tv
        else:
            R_pred, t_pred = self._last_R, self._last_t

        R_cur_d, t_cur_d, lm_ids, packed, counts = tracking.fused_track_step(
            self.m, self._last_lm_ids, frame, self._tensor(R_pred), self._tensor(t_pred),
            self._tensor(self._last_R), self._tensor(self._last_t), self.ref_kf, cfg,
            use_stereo=cfg.sensor != Sensor.MONOCULAR and cfg.bf > 0,
        )
        self.m = tracking.apply_track_counts(self.m, counts)
        p = _host(packed)                # the per-frame host read
        n_tracked = int(p[24])
        if n_tracked < cfg.min_inliers_local:
            return self._handle_lost(frame, ts)

        R_cur = p[:9].reshape(3, 3)
        t_cur = p[9:12]
        self._vel = (R_cur @ self._last_R.T, t_cur - (R_cur @ self._last_R.T) @ self._last_t)
        self._last_R, self._last_t = R_cur, t_cur
        self._last_lm_ids = lm_ids
        self.state = OK

        if self._need_keyframe(n_tracked):
            self._create_keyframe(frame, ts, R_cur_d, t_cur_d, lm_ids, n_tracked)
            return self._record(ts, self._last_R, self._last_t, n_tracked, ref_kf=self.ref_kf)
        return FrameRecord(
            frame_id=self.frame_id, timestamp=ts, R=R_cur, t=t_cur, state=self.state,
            n_tracked=n_tracked, ref_kf=self.ref_kf,
            R_rel=p[12:21].reshape(3, 3), t_rel=p[21:24],
        )

    def _handle_lost(self, frame: FrameArrays, ts: float) -> FrameRecord:
        self.state = LOST
        self._vel = None
        ref = self.ref_kf if self.kf_count > 0 else -1
        return self._record(ts, self._last_R, self._last_t, 0, ref_kf=ref)

    # --- keyframe policy (reference: NeedNewKeyFrame) --------------------

    def _need_keyframe(self, n_tracked: int, fid: int | None = None) -> bool:
        if not self._has_free_kf_slot():
            # at capacity: a standalone cull pass keeps freeing slots
            self.stats["kf_slot_full"] += 1
            self.m = mapping.cull_keyframes(self.m, self.ref_kf, self.cfg)
            self._refresh_kf_meta_blocking()
            return False
        fid = self.frame_id if fid is None else fid
        since = fid - self.last_kf_frame_id
        if since < 1:
            return False
        weak = n_tracked < self.cfg.kf_tracked_ratio * max(self.last_kf_tracked, 1)
        starving = n_tracked < 2 * self.cfg.min_inliers_local
        stale = since >= self.kf_interval
        return ((weak or starving) and n_tracked > 15) or stale

    def _create_keyframe(self, frame, ts, R, t, lm_ids, n_tracked):
        cfg = self.cfg
        slot = self._alloc_kf_slot()
        if slot is None:
            return
        self.m = mapping.process_new_keyframe(
            self.m, frame, R, t, lm_ids, self.frame_id, ts, slot, self.ref_kf, cfg,
            spawn_depth=cfg.sensor != Sensor.MONOCULAR, n_neighbors=cfg.kf_tri_neighbors,
        )
        if self.kf_count >= 2:
            self.m = local_bundle_adjustment(self.m, slot, cfg, iters=cfg.local_ba_iters)
            self._last_R = _host(self.m.kfs.R[slot])
            self._last_t = _host(self.m.kfs.t[slot])
        self._last_lm_ids = self.m.kfs.obs_lm[slot]
        self.ref_kf = slot
        self.kf_count += 1
        self.last_kf_frame_id = self.frame_id
        self.last_kf_tracked = n_tracked
        self._refresh_kf_meta_blocking()
