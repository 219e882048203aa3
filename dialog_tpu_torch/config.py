"""Typed engine configuration (framework-free copy of ``dialog_tpu/config.py``).

The port keeps the reference's ``EngineConfig`` field for field, so a
configuration built for one package means the same in the other. Nothing
here imports a framework: the dataclass is plain Python.

``load_yaml`` accepts the reference YAML schema (Camera.fx, ORBextractor.*,
ThDepth, ...) for drop-in dataset compatibility.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # --- camera (intrinsics + distortion) -------------------------------
    fx: float = 517.306408
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0          # stereo baseline * fx (Camera.bf)
    fps: float = 30.0
    width: int = 640
    height: int = 480
    depth_map_factor: float = 5000.0   # RGB-D depth scaling (TUM: 5000)
    th_depth: float = 40.0             # close/far point threshold (x baseline)

    sensor: Sensor = Sensor.MONOCULAR

    # --- ORB frontend ----------------------------------------------------
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    cell_size: int = 32           # detection grid cell (px, level-0 scale)

    # --- capacities (fixed tensor shapes) ---------------------------------
    max_features: int = 1024      # F: per-frame feature capacity (the pose LM kernel takes any F)
    max_keyframes: int = 512      # K
    max_landmarks: int = 32768    # L
    max_new_landmarks: int = 4096 # per-keyframe triangulation budget
    max_local_kfs: int = 32       # local-BA camera window capacity
    max_local_obs: int = 16384    # local-BA observation capacity
    max_local_lms: int = 8192     # local-map landmark candidate capacity
    max_obs_per_lm: int = 12      # BA observation fan-in per landmark
    max_fixed_kfs: int = 32       # BA fixed-observer camera capacity

    # --- matching thresholds (reference: ORBmatcher.cc TH_LOW/TH_HIGH) ---
    th_low: int = 50
    th_high: int = 100
    nn_ratio_track: float = 0.9
    nn_ratio_init: float = 0.9

    # --- tracking --------------------------------------------------------
    motion_search_radius: float = 15.0
    view_cos_th: float = 0.5      # isInFrustum viewing-angle gate (cos 60°)
    min_inliers_track: int = 10
    min_inliers_local: int = 30
    kf_tracked_ratio: float = 0.9
    max_frames_between_kf: int = 30   # ~1 s at fps

    # --- initialization ---------------------------------------------------
    init_min_features: int = 100
    init_min_matches: int = 100
    init_min_good: int = 50

    # --- RANSAC batch sizes ----------------------------------------------
    init_ransac_iters: int = 256
    pnp_ransac_iters: int = 256
    sim3_ransac_iters: int = 128

    # --- BA --------------------------------------------------------------
    pose_opt_rounds: int = 2
    pose_opt_iters: int = 6
    local_ba_iters: int = 8
    kf_tri_neighbors: int = 2     # triangulation/fusion fan-out per keyframe
    kf_fuse_two_hop: int = 2      # second-degree fusion fan-out (reference:
                                  # SearchInNeighbors' two-hop neighbor set)
    # descriptor gate for new-point triangulation between keyframes. Looser
    # than th_low on purpose: the epipolar/reproj/parallax/cheirality checks
    # do the real filtering, and map growth starves if this is tight
    # (reference uses TH_LOW but restricts candidates to BoW buckets first)
    tri_match_max_dist: int = 80
    tri_match_ratio: float = 0.95
    global_ba_iters: int = 20
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815

    # --- loop closing ----------------------------------------------------
    covis_consistency_th: int = 3
    loop_min_matches: int = 40
    covis_th: int = 15            # covisibility edge weight threshold
    essential_covis_th: int = 100

    # --- vocabulary ------------------------------------------------------
    vocab_k: int = 10
    vocab_levels: int = 4         # kept for reference-config compat
    vocab_words: int = 2048       # flat codebook size (Hamming-argmin)
    vocab_min_kfs: int = 5        # train the codebook once this many KFs exist
    vocab_path: Optional[str] = None
    reloc_min_inliers: int = 25

    @property
    def grid_cols(self) -> int:
        return max(1, self.width // self.cell_size)

    @property
    def grid_rows(self) -> int:
        return max(1, self.height // self.cell_size)

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.bf > 0 else 0.0

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


def load_yaml(path: str, sensor: Sensor = Sensor.MONOCULAR, **overrides) -> EngineConfig:
    """Load a reference-format YAML settings file (cv::FileStorage schema).

    Mirrors the keys parsed by the canonical Tracking constructor:
    Camera.{fx,fy,cx,cy,k1,k2,p1,p2,k3,bf,fps,RGB}, ThDepth, DepthMapFactor,
    ORBextractor.{nFeatures,scaleFactor,nLevels,iniThFAST,minThFAST}.
    """
    import re

    vals: dict = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            m = re.match(r"([\w.]+)\s*:\s*([-\d.eE+]+)\s*$", line)
            if m:
                try:
                    vals[m.group(1)] = float(m.group(2))
                except ValueError:
                    pass

    def g(key, default):
        return vals.get(key, default)

    cfg = EngineConfig(
        fx=g("Camera.fx", 517.3),
        fy=g("Camera.fy", 516.5),
        cx=g("Camera.cx", 318.6),
        cy=g("Camera.cy", 255.3),
        k1=g("Camera.k1", 0.0),
        k2=g("Camera.k2", 0.0),
        p1=g("Camera.p1", 0.0),
        p2=g("Camera.p2", 0.0),
        k3=g("Camera.k3", 0.0),
        bf=g("Camera.bf", 0.0),
        fps=g("Camera.fps", 30.0),
        width=int(g("Camera.width", 640)),
        height=int(g("Camera.height", 480)),
        depth_map_factor=g("DepthMapFactor", 5000.0),
        th_depth=g("ThDepth", 40.0),
        sensor=sensor,
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        scale_factor=g("ORBextractor.scaleFactor", 1.2),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
    )
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


# Convenience presets matching the reference's shipped configs.
TUM1 = EngineConfig(
    fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
    k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
    width=640, height=480, fps=30.0, n_features=1000,
)

KITTI00 = EngineConfig(
    fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
    bf=386.1448, width=1241, height=376, fps=10.0,
    n_features=2000, max_features=2048, sensor=Sensor.STEREO,
    th_depth=35.0, max_keyframes=2048, max_landmarks=262144,
)
