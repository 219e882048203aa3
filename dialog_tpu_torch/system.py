"""Engine facade: the per-frame SLAM engine (port of ``dialog_tpu/system.py``).

Monocular, stereo and RGB-D entry points. A monocular engine bootstraps
from two views; a stereo or RGB-D one from its first frame with enough
depth, and tracks and bundle-adjusts with the stereo (uR) rows.

The host runs the scalar state machine (NOT_INITIALIZED / OK / LOST) and
calls the tensor steps; the map lives on ``device`` as a ``MapState``. Per
tracked frame the host reads one packed vector (pose, relative pose, counts).

Three ways in: ``track_features`` (and the image entries above it) reads
that vector at once; ``track_features_async`` keeps ``pipeline_depth``
frames in flight and reads each one's vector that much later;
``track_batch`` queues B frames against a frozen map and reads their
vectors in one pull when the next batch arrives, so mapping lags tracking by
a batch. A pull is a non-blocking copy into pinned host memory with a CUDA
event behind it; the resolve waits on that event alone.

Place recognition: a vocabulary trained from the map's own descriptors at
``vocab_min_kfs`` keyframes (retrained when their number has doubled), one
BoW row per keyframe, relocalization of a LOST frame (BoW candidates, PnP
RANSAC, pose refinement), and loop closing (``loopclosing.LoopCloser``): a
detection dispatched at each keyframe and evaluated at the next, Sim3
RANSAC, the essential-graph correction. The per-frame and pipelined entries
pull the detection themselves; ``track_batch`` takes it into the batch's own
pull and evaluates it at the batch's resolve.

Global BA after each loop correction (reference: the transient
``RunGlobalBundleAdjustment`` thread): asynchronously by default, one PCG LM
iteration per tracked frame (``track_features``) or batch (``track_batch`` in
state OK), folded into the live map when done (``optim.global_ba``); the
pipelined entry ticks only through ``track_features``, so its GBA runs at
``flush``, which drains it. With ``gba_async = False`` the closure solves
it at once. Over a ``torch.distributed`` group with more than one rank
(``distributed.initialize``) each rank solves on its slice of the
landmarks.

The other modes of the reference's ``System``: ``block_refine`` (block
bundle adjustment of the whole map, its blocks dealt out over the process
group when there is one), ``set_localization_mode`` (track only: no new
keyframe), ``reset``, ``save_checkpoint`` / ``load_checkpoint`` (a resume
goes LOST and relocalizes against the loaded map), and the writers
``save_trajectory_tum`` / ``save_trajectory_kitti`` /
``save_keyframe_trajectory_tum`` / ``export_map_ply``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import distributed
from . import geometry as geo
from . import mapping, matching, tracking
from . import pnp as _pnp
from . import vocab as _vocab
from .config import EngineConfig, Sensor
from .containers import (INVALID_ID, FrameArrays, MapMeta, MapState, empty_map, load_map, map_meta_len,
                         pack_map_meta, save_map)
from .frontend import extract_features
from .init2view import initialize_two_view
from .loopclosing import LoopCloser
from .optim.global_ba import (GBASnapshot, build_global_problem, fold_gba_result, global_bundle_adjustment,
                               shard_problem)
from .optim.local_ba import local_bundle_adjustment
from .optim.pose_only import pose_optimization
from .optim.schur_pcg import lm_init_pcg, lm_steps_pcg, segment_orders
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
    """SLAM engine on one device: the CUDA card unless ``device`` says
    otherwise (``device="cpu"`` takes the kernels' plain versions).

    Usage::

        eng = Engine(config)
        for img, ts in frames:
            rec = eng.track_image(img, ts)   # track_stereo / track_rgbd by cfg.sensor
        eng.save_trajectory_tum(path)
    """

    def __init__(self, cfg: EngineConfig, device="cuda"):
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
        # capacity events: landmarks the free list could not take, keyframes
        # with no free slot, global-BA observations cut at max_obs_per_lm;
        # each also goes to ``logger`` (an instrument.RunLogger) when one is set.
        # Also the global BA runs started and the relocalizations that succeeded.
        self.stats = {"lm_dropped": 0, "kf_slot_full": 0, "gba_obs_dropped": 0, "gba_runs": 0,
                      "relocalizations": 0}
        self.logger = None
        self._init_frame: Optional[FrameArrays] = None
        self._init_ts = 0.0
        self._init_fid = 0
        self._last_frame: Optional[FrameArrays] = None
        self._last_lm_ids = None
        self._last_R = np.eye(3, dtype=np.float32)
        self._last_t = np.zeros(3, dtype=np.float32)
        self._vel: Optional[tuple[np.ndarray, np.ndarray]] = None
        self.trajectory: list[FrameRecord] = []
        # RANSAC minimal sets and the vocabulary's initial sample come from
        # this generator (the reference's PRNGKey(n_features); the two streams
        # differ by construction)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.n_features)
        # place recognition
        self._vocab: Optional[_vocab.Vocabulary] = None
        self._bow_db: Optional[torch.Tensor] = None   # f32[K, W] BoW vector per keyframe
        self._vocab_trained_kfs = 0                   # kf_count at the last (re)train
        self._loop = LoopCloser(cfg)
        self.loop_closing_enabled = True
        self.localization_only = False
        # global BA after a loop correction: chunked into one LM iteration per
        # tracked frame or batch (``_gba_tick``) unless gba_async is off
        self.gba_async = True
        self.gba_iters = 8
        self._gba: Optional[dict] = None
        # a process group with more than one rank: global BA splits the landmarks over it
        self.group = distributed.default_group()
        # pipelined tracking: frames (track_features_async) and batches
        # (track_batch) in flight, and the device-side tracking state they chain
        self._pending: list = []
        self._pending_b: list = []
        self._dev_state: Optional[dict] = None
        self.pipeline_depth = 3
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
        self._gba_tick()
        if self.state == NOT_INITIALIZED:
            rec = self._initialize(frame, timestamp)
        else:
            rec = self._track(frame, timestamp)
        self._append_record(rec)
        self.frame_id += 1
        return rec

    # --- pipelined tracking (throughput mode) --------------------------

    def _chain_state(self) -> dict:
        """The device-side state the next pipelined step starts from."""
        if self._dev_state is not None:
            return self._dev_state
        R, t = self._tensor(self._last_R), self._tensor(self._last_t)
        return {"R": R, "t": t, "R_prev": R, "t_prev": t, "lm_ids": self._last_lm_ids,
                "has_vel": torch.zeros((), dtype=torch.bool, device=self.device)}

    def _start_pull(self, packed: torch.Tensor, det=None):
        """Start the host copy of ``packed`` (flattened) followed by the
        keyframe bookkeeping snapshot of the map as it stands and, given a
        pending loop detection ``det`` (``LoopCloser.take_pending``), its
        vector and neighbour matrix, as ONE vector: (host tensor, event). On
        the card the copy is non-blocking into pinned memory and the event is
        recorded behind it; the bytes are the result only once the event has
        passed (``_finish_pull``)."""
        parts = [packed.reshape(-1), pack_map_meta(self.m)]
        if det is not None:
            parts += [det[1], det[2].reshape(-1).to(torch.float32)]
        vec = torch.cat(parts)
        if vec.device.type != "cuda":
            return vec, None
        host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
        host.copy_(vec, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(vec.device))
        return host, done

    @staticmethod
    def _finish_pull(pull) -> np.ndarray:
        """Wait for the pull's event, and for nothing else; the result is a
        copy, so the pinned block goes back to its pool."""
        host, done = pull
        if done is not None:
            done.synchronize()
        return np.array(host.numpy())

    def track_features_async(self, frame: FrameArrays, timestamp: float):
        """Pipelined entry: queue this frame's device step and resolve the
        frame ``pipeline_depth`` steps back, whose result has long been
        copied. The step takes its prediction and its fallback on the device,
        so queueing never waits for the card; mapping lags tracking by the
        depth. Returns the resolved frame's record (None while the pipeline
        fills; the frame's own record while the engine is not OK)."""
        if self.state != OK or self._last_lm_ids is None:
            self.flush()
            self.track_features(frame, timestamp)
            return self.trajectory[-1]
        cfg = self.cfg
        dev = self._chain_state()
        R_d, t_d, lm_ids_d, packed, counts = tracking.fused_track_step_auto(
            self.m, dev["lm_ids"], frame, dev["R"], dev["t"], dev["R_prev"], dev["t_prev"], dev["has_vel"],
            self.ref_kf, cfg, use_stereo=cfg.sensor != Sensor.MONOCULAR and cfg.bf > 0,
        )
        self.m = tracking.apply_track_counts(self.m, counts)
        self._dev_state = {"R": R_d, "t": t_d, "R_prev": dev["R"], "t_prev": dev["t"], "lm_ids": lm_ids_d,
                           "has_vel": torch.ones((), dtype=torch.bool, device=self.device)}
        # the keyframe bookkeeping snapshot rides every pull, so keyframe
        # culls are seen without a blocking refresh on this path
        pull = self._start_pull(packed)
        self._pending.append((frame, timestamp, self.frame_id, self.ref_kf, R_d, t_d, lm_ids_d, pull))
        self.frame_id += 1
        if len(self._pending) > self.pipeline_depth:
            return self._resolve_oldest()
        return None

    def track_batch(self, frames: FrameArrays, timestamps) -> list[FrameRecord]:
        """Batched pipelined entry: track B frames (a leading B on every leaf
        of ``frames``, e.g. from ``frontend.extract_features_batch``) against
        the map as it stands, with one host pull for the batch. Results
        resolve one batch behind. Returns the records this call resolved
        (possibly none)."""
        B = len(timestamps)
        if self.state == OK:
            # an in-flight global BA advances by one chunk; its device work
            # queues between the batches' dispatches
            self._gba_tick()
        if self.state != OK or self._last_lm_ids is None:
            # per frame until healthy; the next batch re-enters batched mode
            self.flush()
            return [self.track_features(FrameArrays(*[x[b] for x in frames]), float(timestamps[b]))
                    for b in range(B)]
        # resolve the in-flight batch BEFORE queueing this one: its pull was
        # started a batch ago, and any keyframe the resolve creates lands in
        # the map this batch tracks against
        out = []
        if self._pending_b:
            out = self._resolve_batch()
            if self.state != OK:
                # recovery: this batch goes through the per-frame path (relocalization)
                out += [self.track_features(FrameArrays(*[x[b] for x in frames]), float(timestamps[b]))
                        for b in range(B)]
                return out
        cfg = self.cfg
        dev = self._chain_state()
        R_l, t_l, R_p, t_p, lm_l, packed, counts = tracking.fused_track_multi(
            self.m, dev["lm_ids"], frames, dev["R"], dev["t"], dev["R_prev"], dev["t_prev"], dev["has_vel"],
            self.ref_kf, cfg, use_stereo=cfg.sensor != Sensor.MONOCULAR and cfg.bf > 0,
        )
        self.m = tracking.apply_track_counts(self.m, counts)
        self._dev_state = {"R": R_l, "t": t_l, "R_prev": R_p, "t_prev": t_p, "lm_ids": lm_l,
                           "has_vel": torch.ones((), dtype=torch.bool, device=self.device)}
        fids = list(range(self.frame_id, self.frame_id + B))
        self.frame_id += B
        # the loop detection dispatched at the last keyframe rides this
        # batch's pull and is evaluated when the batch resolves
        det = self._loop.take_pending() if self.loop_closing_enabled else None
        pull = self._start_pull(packed, det)
        det = None if det is None else (det[0], det[3])
        self._pending_b.append((frames, [float(t) for t in timestamps], fids, self.ref_kf, lm_l, pull, det))
        return out

    def _resolve_batch(self) -> list[FrameRecord]:
        frames, ts_list, fids, ref_launch, lm_l, pull, det = self._pending_b.pop(0)
        cfg = self.cfg
        B = len(ts_list)
        K = cfg.max_keyframes
        V = self._finish_pull(pull)                  # ONE pull per batch
        P = V[: B * 26].reshape(B, 26)
        det_at = B * 26 + map_meta_len(K)           # the detection's vector [5K] and neighbour matrix [K, K]
        out = []
        lost_at = None
        for b in range(B):
            p = P[b]
            n_tracked = int(p[24])
            if n_tracked < cfg.min_inliers_local:
                lost_at = b
                break
            rec = FrameRecord(
                frame_id=fids[b], timestamp=ts_list[b], R=p[:9].reshape(3, 3), t=p[9:12], state=OK,
                n_tracked=n_tracked, ref_kf=ref_launch, R_rel=p[12:21].reshape(3, 3), t_rel=p[21:24],
            )
            self._append_record(rec)
            out.append(rec)
            self._last_R, self._last_t = rec.R, rec.t
        # the keyframe bookkeeping snapshot taken when this batch was queued
        self._observe_kf_meta(MapMeta(V[B * 26 :], cfg.max_keyframes))
        if lost_at is not None:
            # tracking failed mid-batch: the rest of this batch and every
            # deeper batch in flight were computed against a state that no
            # longer holds. Re-track them frame by frame: state LOST sends
            # each through relocalization.
            retrack = [(FrameArrays(*[x[b] for x in frames]), ts_list[b], fids[b]) for b in range(lost_at, B)]
            for fr2, ts2, fid2, *_ in self._pending_b:
                retrack += [(FrameArrays(*[x[b] for x in fr2]), ts2[b], fid2[b]) for b in range(len(ts2))]
            self._pending_b.clear()
            self._dev_state = None
            self.state = LOST
            self._vel = None
            fid_after = self.frame_id
            for fb, ts_b, fid_b in retrack:
                self.frame_id = fid_b
                out.append(self.track_features(fb, float(ts_b)))
            self.frame_id = fid_after
            return out
        # keyframe decision: the batch's LAST frame is the only candidate (its
        # pose and its associations lm_l belong together); one keyframe per
        # batch keeps mapping bounded
        n_last = int(P[B - 1, 24])
        self._last_lm_ids = lm_l
        self._last_frame = None
        self.state = OK
        slot = None
        if self._need_keyframe(n_last, fid=fids[B - 1]):
            slot = self._alloc_kf_slot()
        if slot is not None:
            self._insert_keyframe(FrameArrays(*[x[B - 1] for x in frames]), ts_list[B - 1], fids[B - 1],
                                  self._tensor(P[B - 1, :9].reshape(3, 3)), self._tensor(P[B - 1, 9:12]), lm_l,
                                  slot, n_last)
            # dispatch only: the detection rides the next batch's pull
            self._detect_and_close_loop(slot, dispatch_only=True)
        # the detection dispatched at an earlier keyframe, pulled with this batch
        if det is not None:
            det_kf, stamp = det
            vec = V[det_at : det_at + 5 * K]
            neigh = V[det_at + 5 * K : det_at + 5 * K + K * K].reshape(K, K).astype(np.uint8)
            self._close_loop_from(det_kf, self._loop.evaluate(det_kf, vec, neigh, stamp=stamp))
        return out

    def shutdown(self) -> None:
        """Drain all in-flight work; the engine remains usable afterwards."""
        self.flush()

    def flush(self) -> None:
        """Drain the pipeline (call before reading the trajectory)."""
        while self._pending:
            self._resolve_oldest()
        while self._pending_b:
            self._resolve_batch()
        while self._gba is not None:
            self._gba_tick()
        self._dev_state = None

    def _resolve_oldest(self) -> FrameRecord:
        frame, ts, fid, ref_launch, R_d, t_d, lm_ids_d, pull = self._pending.pop(0)
        cfg = self.cfg
        p = self._finish_pull(pull)
        self._observe_kf_meta(MapMeta(p[26:], cfg.max_keyframes))
        n_tracked = int(p[24])
        if n_tracked < cfg.min_inliers_local:
            # tracking failed at this frame: the frames in flight were computed
            # against the state before the loss and are recorded LOST with it
            dropped = [(e[1], e[2], e[3]) for e in self._pending]
            self._pending.clear()
            self._dev_state = None
            self.state = LOST
            self._vel = None
            rec = None
            for d_ts, d_fid, d_ref in [(ts, fid, ref_launch)] + dropped:
                lost = FrameRecord(frame_id=d_fid, timestamp=d_ts, R=self._last_R, t=self._last_t, state=LOST,
                                   n_tracked=0, ref_kf=d_ref)
                self._append_record(lost)
                rec = rec or lost
            return rec
        rec = FrameRecord(
            frame_id=fid, timestamp=ts, R=p[:9].reshape(3, 3), t=p[9:12], state=OK, n_tracked=n_tracked,
            ref_kf=ref_launch, R_rel=p[12:21].reshape(3, 3), t_rel=p[21:24],
        )
        self._append_record(rec)
        self._last_R, self._last_t = rec.R, rec.t
        self._last_frame = frame
        self._last_lm_ids = lm_ids_d
        self.state = OK
        slot = None
        if self._need_keyframe(n_tracked, fid=fid):
            slot = self._alloc_kf_slot()
        if slot is not None:
            self._insert_keyframe(frame, ts, fid, R_d, t_d, lm_ids_d, slot, n_tracked)
            self._detect_and_close_loop(slot)
        return rec

    def _insert_keyframe(self, frame, ts, fid, R, t, lm_ids, slot, n_tracked) -> None:
        """The keyframe pipeline: insertion, local BA, the vocabulary and the
        BoW row. The pipelined entries go on from their device-side state, so
        they do not read the refined pose back. Each caller then detects
        loops (``_detect_and_close_loop``) where the reference does: the
        per-frame entry after taking up the refined pose, the batched one
        dispatch only."""
        cfg = self.cfg
        self.m = mapping.process_new_keyframe(
            self.m, frame, R, t, lm_ids, fid, ts, slot, self.ref_kf, cfg,
            spawn_depth=cfg.sensor != Sensor.MONOCULAR, n_neighbors=cfg.kf_tri_neighbors,
        )
        if self.kf_count >= 2:
            self.m = local_bundle_adjustment(self.m, slot, cfg, iters=cfg.local_ba_iters)
        self.ref_kf = slot
        self.kf_count += 1
        self.last_kf_frame_id = fid
        self.last_kf_tracked = n_tracked
        self._ensure_vocab()
        self._update_bow_row(slot)

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

    def save_trajectory_kitti(self, path: str) -> None:
        from .eval.trajectory import save_kitti

        poses = self.final_poses()
        save_kitti(path, [p[0] for p in poses], [p[1] for p in poses])

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        """Keyframe poses only, ordered by insertion number (reference:
        System::SaveKeyFrameTrajectoryTUM)."""
        from .eval.trajectory import save_tum

        valid, seq, ts = _host(self.m.kfs.valid), _host(self.m.kfs.seq), _host(self.m.kfs.timestamp)
        kf_R, kf_t = _host(self.m.kfs.R), _host(self.m.kfs.t)
        slots = np.nonzero(valid)[0]
        slots = slots[np.argsort(seq[slots])]
        save_tum(path, [float(ts[s]) for s in slots], [kf_R[s] for s in slots], [kf_t[s] for s in slots])

    def export_map_ply(self, path: str) -> None:
        """Landmarks (grey) and keyframe centres (red) as an ASCII PLY point
        cloud (the reference's offline stand-in for the Pangolin viewer)."""
        lv, kv = _host(self.m.lms.valid), _host(self.m.kfs.valid)
        pts = _host(self.m.lms.xyz)[lv]
        kR, kt = _host(self.m.kfs.R)[kv], _host(self.m.kfs.t)[kv]
        cams = np.stack([-R.T @ t for R, t in zip(kR, kt)]) if kv.any() else np.zeros((0, 3))
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n"
                    f"element vertex {len(pts) + len(cams)}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                    "end_header\n")
            for p in pts:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} 180 180 180\n")
            for c in cams:
                f.write(f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f} 255 40 40\n")

    def save_checkpoint(self, path: str) -> None:
        """The map as one ``.npz`` (``containers.save_map``; the JAX engine
        reads and writes the same format)."""
        save_map(self.m, path)

    def load_checkpoint(self, path: str) -> None:
        """Resume from a saved map. An in-flight global BA belongs to the old
        map and is abandoned; every record is baked to an absolute pose first.
        The host's keyframe counters rebuild from the loaded masks; the engine
        goes LOST at the newest keyframe and relocalizes against the loaded
        map, retraining the vocabulary lazily from its descriptors."""
        self._gba = None
        self.flush()
        self._bake_all_records()
        self.m = load_map(self.cfg, path, device=self.device)
        valid, seq = _host(self.m.kfs.valid), _host(self.m.kfs.seq)
        self.kf_count = int(_host(self.m.num_kfs))
        self._kf_valid_host = valid.copy()
        self._recent_kf_allocs.clear()
        self._seq_next = int(seq.max()) + 1
        alive = np.nonzero(valid)[0]
        if len(alive):
            # the newest surviving keyframe by insertion number (slots are recycled)
            last = int(alive[np.argmax(seq[alive])])
            self.ref_kf = last
            self._last_R = _host(self.m.kfs.R[last])
            self._last_t = _host(self.m.kfs.t[last])
            self._last_lm_ids = self.m.kfs.obs_lm[last]
            self.state = LOST
            self._vocab = None
            self._bow_db = None
            self._vocab_trained_kfs = 0
        else:
            self.state = NOT_INITIALIZED

    def _bake_all_records(self) -> None:
        """Every record to an absolute pose against the map as it stands, its
        keyframe link dropped: called before the map is discarded (reset,
        checkpoint load), so that no record re-composes against an unrelated
        keyframe that later takes the same slot."""
        kf_R, kf_t = _host(self.m.kfs.R), _host(self.m.kfs.t)
        for rec in self.trajectory:
            if rec.ref_kf >= 0 and rec.R_rel is not None:
                rec.R = rec.R_rel @ kf_R[rec.ref_kf]
                rec.t = rec.R_rel @ kf_t[rec.ref_kf] + rec.t_rel
            rec.ref_kf, rec.R_rel, rec.t_rel = -1, None, None
        self._recs_by_ref.clear()

    def block_refine(self, n_blocks: int = 8, rounds: int = 2, iters: int = 6, cams_pb: int = 64,
                     lms_pb: int = 4096) -> None:
        """Block bundle adjustment of the whole map (``optim.block_ba``), its
        blocks dealt out over the engine's process group when it has one.
        Drains the pipeline first, rewrites poses and landmarks at once, and
        re-bases tracking on the refined reference keyframe. Call when
        tracking is idle. ``stats`` counts the observations cut and, unlike
        the reference, the owned keyframes left out (ROADMAP R1)."""
        from .optim.block_ba import block_bundle_adjustment

        self.flush()
        self.m = block_bundle_adjustment(self.m, self.cfg, n_blocks=n_blocks, rounds=rounds, iters=iters,
                                         cams_pb=cams_pb, lms_pb=lms_pb, group=self.group, stats=self.stats)
        self._last_R = _host(self.m.kfs.R[self.ref_kf])
        self._last_t = _host(self.m.kfs.t[self.ref_kf])
        self._vel = None
        self._dev_state = None
        self._refresh_kf_meta_blocking()

    def set_localization_mode(self, on: bool) -> None:
        """Freeze the map and track only (reference: ActivateLocalizationMode)."""
        self.localization_only = on

    def reset(self) -> None:
        """Clear the map and start over (reference: System::Reset). An
        in-flight global BA is abandoned, not drained; frames in flight are
        resolved, then every record is baked to an absolute pose."""
        self._gba = None
        self.flush()
        self._bake_all_records()
        self._pending.clear()
        self._pending_b.clear()
        self._dev_state = None
        self.m = empty_map(self.cfg, device=self.device)
        self.state = NOT_INITIALIZED
        self.kf_count = 0
        self.ref_kf = 0
        self.last_kf_frame_id = -(10**9)
        self.last_kf_tracked = 0
        self._init_frame = None
        self._last_frame = None
        self._last_lm_ids = None
        self._last_R = np.eye(3, dtype=np.float32)
        self._last_t = np.zeros(3, dtype=np.float32)
        self._vel = None
        self._vocab = None
        self._bow_db = None
        self._vocab_trained_kfs = 0
        self._kf_valid_host = np.zeros(self.cfg.max_keyframes, bool)
        self._recent_kf_allocs.clear()
        self._seq_next = 0
        self._loop = LoopCloser(self.cfg)

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
        if meta.lm_dropped > self.stats["lm_dropped"]:
            self.stats["lm_dropped"] = meta.lm_dropped
            if self.logger is not None:
                self.logger.log_event("lm_freelist_full", dropped=meta.lm_dropped)
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
        self._last_frame = frame
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
        self._last_frame = frame
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
        if self.state == LOST:
            rec = self._try_relocalize(frame, ts)
            if rec is not None:
                return rec
            # not recovered: retry tracking from the last known pose
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
        self._last_frame = frame
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
        self._last_frame = frame
        self._vel = None
        ref = self.ref_kf if self.kf_count > 0 else -1
        return self._record(ts, self._last_R, self._last_t, 0, ref_kf=ref)

    # --- place recognition and relocalization ---------------------------

    def _ensure_vocab(self) -> None:
        """Train, and now and then retrain, the codebook from the map's own
        descriptors: first at ``vocab_min_kfs`` keyframes, again whenever
        their number has doubled since, so the words follow the scene. A
        fresh train starts from a random sample of the valid descriptors
        (drawn from the engine's generator), a retrain from the current
        words. idf comes from the keyframe corpus, and every keyframe's BoW
        row is rebuilt under the new codebook in one pass."""
        if self.kf_count < self.cfg.vocab_min_kfs:
            return
        if self._vocab is not None and self.kf_count < 2 * max(self._vocab_trained_kfs, 1):
            return
        kfs = self.m.kfs
        K, F = kfs.obs_lm.shape
        desc = kfs.desc.reshape(K * F, 8)
        feat_ok = kfs.feat_valid & kfs.valid[:, None]
        valid = feat_ok.reshape(K * F)
        W = self.cfg.vocab_words
        init = _vocab.draw_init_words(desc, valid, W, self._gen) if self._vocab is None else self._vocab.words
        vocab = _vocab.train_vocab(desc, valid, init, n_words=W, iters=4)
        if W >= 8192:
            # large codebooks get the two-level quantizer
            vocab = _vocab.build_two_level(vocab, n_coarse=max(64, int(np.sqrt(W))))
        self._vocab_trained_kfs = self.kf_count
        # invalid slots quantize to the sentinel word and fall out of the counts
        wid = _vocab.quantize(vocab, desc, valid)
        doc_ids = torch.arange(K, dtype=torch.int32, device=desc.device).repeat_interleave(F)
        self._vocab = _vocab.compute_idf(vocab, wid, doc_ids, K, n_live=kfs.valid.sum())
        self._bow_db = _vocab.bow_db_rows(self._vocab, kfs.desc, feat_ok)

    def _update_bow_row(self, slot: int) -> None:
        if self._vocab is None:
            return
        kfs = self.m.kfs
        self._bow_db[slot] = _vocab.bow_vector(self._vocab, kfs.desc[slot], kfs.feat_valid[slot])

    def _try_relocalize(self, frame: FrameArrays, ts: float) -> Optional[FrameRecord]:
        """BoW candidates -> PnP RANSAC -> pose refinement (reference:
        Tracking::Relocalization). Candidates: keyframes sharing at least 0.8
        of the most words shared with any, grouped with their covisible
        candidates; each well-scoring group's best member is tried, best
        first, three at most. Returns a record on success, else None."""
        self._ensure_vocab()
        if self._vocab is None:
            return None
        cfg = self.cfg
        q = _vocab.bow_vector(self._vocab, frame.desc, frame.valid)
        scores = torch.where(self.m.kfs.valid, _vocab.bow_l1_scores(q, self._bow_db), -1.0)
        common = _host((self._bow_db > 0).to(torch.float32) @ (q > 0).to(torch.float32)).copy()
        scores = _host(scores)
        valid = _host(self.m.kfs.valid)
        common[~valid] = 0.0
        cand_mask = valid & (scores > 0.0)
        if cand_mask.any():
            max_cw = common[cand_mask].max()
            if max_cw > 0:
                cand_mask &= common >= 0.8 * max_cw
        cands = np.nonzero(cand_mask)[0]
        if len(cands) > 1:
            covis = _host(self.m.covis)        # a blocking read; relocalization is rare
            acc = np.empty(len(cands), np.float32)
            best_member = np.empty(len(cands), np.int64)
            for i, c in enumerate(cands):
                group = (covis[int(c)] > 0) & cand_mask
                group[int(c)] = True
                members = np.nonzero(group)[0]
                acc[i] = scores[members].sum()
                best_member[i] = members[np.argmax(scores[members])]
            best = np.unique(best_member[acc >= 0.75 * acc.max()])
            order = [int(c) for c in best[np.argsort(-scores[best])]][:3]
        else:
            order = [int(c) for c in cands]
        for cand in order:
            if float(scores[cand]) <= 0.0:
                break
            lm_ids, n = tracking.match_reference_kf(self.m, cand, frame, cfg)
            if int(n) < 15:
                continue
            X, uv, inv_s2, ok = tracking.gather_track_problem(self.m, frame, lm_ids, cfg)
            pnp = _pnp.solve_pnp_ransac(X, uv, ok, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                                        _pnp.draw_pnp_sets(ok, cfg.pnp_ransac_iters, self._gen))
            if not bool(pnp.success):
                continue
            res = pose_optimization(pnp.R, pnp.t, X, uv, inv_s2, ok, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                                    chi2_th=cfg.chi2_mono)
            n_inl = int(res.n_inliers)
            if n_inl < cfg.reloc_min_inliers:
                continue
            self.state = OK
            self.ref_kf = cand
            self._last_R = _host(res.R)
            self._last_t = _host(res.t)
            self._last_frame = frame
            self._last_lm_ids = torch.where(res.inlier, lm_ids, INVALID_ID)
            self._vel = None
            self.stats["relocalizations"] += 1
            return self._record(ts, res.R, res.t, n_inl, ref_kf=cand)
        return None

    # --- keyframe policy (reference: NeedNewKeyFrame) --------------------

    def _need_keyframe(self, n_tracked: int, fid: int | None = None) -> bool:
        if self.localization_only:
            return False
        if not self._has_free_kf_slot():
            # at capacity: a standalone cull pass keeps freeing slots
            self.stats["kf_slot_full"] += 1
            if self.logger is not None:
                self.logger.log_event("kf_slots_full", count=self.stats["kf_slot_full"])
            self.m = mapping.cull_keyframes(self.m, self.ref_kf, self.cfg)
            if not self._pending_b and not self._pending:
                # no pull in flight to learn the freed slot from
                self._refresh_kf_meta_blocking()
            return False
        fid = self.frame_id if fid is None else fid
        # frames resolved from the per-frame pipeline were queued before the
        # last keyframe's map update landed: without a cooldown the weak and
        # starving triggers fire again on every lagged frame
        if self._pending and fid - self.last_kf_frame_id < len(self._pending) + 2:
            return False
        # batches decide once each: at least one whole batch between keyframes
        if self._pending_b and fid - self.last_kf_frame_id < len(self._pending_b[0][1]):
            return False
        since = fid - self.last_kf_frame_id
        if since < 1:
            return False
        weak = n_tracked < self.cfg.kf_tracked_ratio * max(self.last_kf_tracked, 1)
        starving = n_tracked < 2 * self.cfg.min_inliers_local
        stale = since >= self.kf_interval
        return ((weak or starving) and n_tracked > 15) or stale

    def _create_keyframe(self, frame, ts, R, t, lm_ids, n_tracked):
        """The per-frame entry's keyframe: the shared pipeline, then tracking
        goes on from the refined pose and the keyframe's own associations."""
        slot = self._alloc_kf_slot()
        if slot is None:
            return
        refined = self.kf_count >= 2      # local BA runs from the third keyframe on
        self._insert_keyframe(frame, ts, self.frame_id, R, t, lm_ids, slot, n_tracked)
        if refined:
            self._last_R = _host(self.m.kfs.R[slot])
            self._last_t = _host(self.m.kfs.t[slot])
        self._last_lm_ids = self.m.kfs.obs_lm[slot]
        self._detect_and_close_loop(slot)
        self._refresh_kf_meta_blocking()

    # --- loop closing (reference: LoopClosing::Run) ----------------------

    def _detect_and_close_loop(self, slot: int, dispatch_only: bool = False) -> None:
        """Detection for keyframe ``slot``. Synchronous: dispatch it, and
        evaluate (and close) the previous keyframe's. ``dispatch_only`` (the
        batched entry): queue it; ``track_batch`` takes it into its pull."""
        if not self.loop_closing_enabled or self._vocab is None or self.kf_count <= 10:
            return
        if dispatch_only:
            self._loop.dispatch(self.m, self._bow_db, self._vocab, slot, stamp=self.kf_count)
            return
        det_kf, cands = self._loop.detect(self.m, self._bow_db, self._vocab, slot, stamp=self.kf_count)
        self._close_loop_from(det_kf, cands)

    def _close_loop_from(self, det_kf: int, cands) -> None:
        """Compute the Sim3 of each accepted candidate in turn and correct
        the map with the first that holds; tracking resumes from the
        corrected pose of the reference keyframe."""
        if not cands:
            return
        # detection lags evaluation by a keyframe: a slot involved may have
        # been culled and recycled into an unrelated keyframe since. Check the
        # insertion numbers against the live map (a blocking read, only when
        # there are candidates)
        seq_now = _host(self.m.kfs.seq)
        valid_now = _host(self.m.kfs.valid)
        det_seq = self._loop.last_eval_det_seq
        if not valid_now[det_kf] or (det_seq is not None and int(seq_now[det_kf]) != det_seq):
            return
        for c, c_seq in cands:
            if not valid_now[c] or int(seq_now[c]) != c_seq:
                continue
            lc = self._loop.compute_sim3(self.m, det_kf, c, generator=self._gen)
            if lc is None:
                continue
            # a global BA still in flight optimized the graph before this
            # correction: abandon it (reference: mbStopGBA stops the running
            # thread before CorrectLoop starts a new one)
            self._gba = None
            self.m = self._loop.correct(self.m, det_kf, lc, self.cfg)
            # refine the whole map after the correction
            if self.gba_async:
                self._start_gba(self.gba_iters)
            else:
                self.m = global_bundle_adjustment(self.m, self.cfg, iters=8, group=self.group, stats=self.stats)
            self._last_R = _host(self.m.kfs.R[self.ref_kf])
            self._last_t = _host(self.m.kfs.t[self.ref_kf])
            self._vel = None
            # in-flight device tracking state predates the correction
            self._dev_state = None
            break

    # --- asynchronous loop-closure global BA ------------------------------

    def _start_gba(self, iters: int) -> None:
        """Snapshot the map and start a global BA that advances one LM
        iteration per ``_gba_tick`` (reference: ``CorrectLoop`` starting
        ``RunGlobalBundleAdjustment`` on a thread), so that a tracked frame
        stalls for one PCG iteration, not for the whole solve. Reads the
        count of cut observations back to the host once."""
        prob, n_dropped = build_global_problem(self.m, self.cfg)
        self.stats["gba_runs"] += 1
        n_dropped = int(n_dropped)
        self.stats["gba_obs_dropped"] += n_dropped
        if self.logger is not None and n_dropped:
            self.logger.log_event("gba_obs_dropped", n=n_dropped)
        n_lms = prob.lm_ids.shape[0]
        if self.group is not None:
            prob = shard_problem(prob, self.group)
        snap = GBASnapshot(self.m)
        carry = lm_init_pcg(prob, self.cfg, chi2_th=self.cfg.chi2_mono, group=self.group)
        # at capacity-scale maps a tick's stall is bounded by a truncated CG
        # with a loose tolerance (inexact Newton); small maps keep the full budget
        big = n_lms > 65536
        self._gba = {"prob": prob, "snap": snap, "carry": carry, "left": int(iters), "n_lms": n_lms,
                     "seg": segment_orders(prob), "cg_iters": 16 if big else 48, "cg_tol": 1e-4 if big else 1e-6}

    def _gba_tick(self) -> None:
        """Advance the global BA in flight by one LM iteration; fold it in
        after its last."""
        if self._gba is None:
            return
        g = self._gba
        g["carry"] = lm_steps_pcg(g["prob"], self.cfg, g["carry"], chi2_th=self.cfg.chi2_mono,
                                  cg_iters=g["cg_iters"], cg_tol=g["cg_tol"], group=self.group, seg=g["seg"])
        g["left"] -= 1
        if g["left"] <= 0:
            self._finish_gba()

    def _finish_gba(self) -> None:
        """Fold the finished global BA into the live map and re-anchor tracking."""
        g = self._gba
        self._gba = None
        R, t, xyz = g["carry"][:3]
        xyz = distributed.gather_landmarks(xyz, g["n_lms"], self.group)
        snap = g["snap"]
        self.m = fold_gba_result(self.m, snap.kf_seq, snap.kf_valid, snap.lm_valid, snap.lm_first_seq, snap.lm_ref,
                                 geo.orthogonalize(R), t, xyz)
        self._last_R = _host(self.m.kfs.R[self.ref_kf])
        self._last_t = _host(self.m.kfs.t[self.ref_kf])
        self._vel = None
        self._dev_state = None
        self._refresh_kf_meta_blocking()
