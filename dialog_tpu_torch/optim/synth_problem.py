"""Synthetic BA problem generator (port of ``dialog_tpu/optim/synth_problem.py``).

Builds a ground-truth-known ``BAProblem``: cameras on an arc observing a box
of points, the poses (all but two gauge cameras) and the points perturbed.
The draws come from numpy in the reference's order, so the same seed gives
the reference's problem up to one f32 retraction. With ``stereo_frac > 0``
(and a config whose ``bf > 0``) that share of the observations also carries
the right-camera coordinate ``uR = u - bf/z``. ``chip_smoke.py`` takes its
seeded local-BA windows for kernel C's solve check from here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import geometry as geo
from ..config import EngineConfig
from .local_ba import BAProblem

FIXTURE_CFG = EngineConfig(
    max_local_kfs=8, max_fixed_kfs=4, max_local_lms=128, max_obs_per_lm=8
)


def make_problem(
    seed=0,
    n_cams=6,
    n_pts=100,
    noise_px=0.4,
    perturb=0.05,
    cfg: EngineConfig = FIXTURE_CFG,
    stereo_frac: float = 0.0,
    device="cuda",
):
    """Cameras on an arc looking at a point cloud; each point is seen by
    ``min(max_obs_per_lm, n_cams)`` cameras drawn at random.

    Returns ``(prob, Rs, ts, pts, n_cams, n_pts)`` with ground-truth poses
    and points (numpy) for assertion; ``prob``'s tensors are on ``device``.
    """
    rng = np.random.default_rng(seed)
    pts = np.stack(
        [
            rng.uniform(-3, 3, n_pts),
            rng.uniform(-2, 2, n_pts),
            rng.uniform(6, 10, n_pts),
        ],
        -1,
    ).astype(np.float32)
    Rs, ts = [], []
    for i in range(n_cams):
        a = (i / (n_cams - 1) - 0.5) * 2.0
        eye = np.array([a * 2.0, 0.1 * a, 0.0])
        fwd = np.array([0.0, 0.0, 8.0]) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0, -1, 0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd]).astype(np.float32)
        Rs.append(R)
        ts.append((-R @ eye).astype(np.float32))
    Rs, ts = np.stack(Rs), np.stack(ts)

    C = cfg.max_local_kfs + cfg.max_fixed_kfs
    P = cfg.max_local_lms
    O = cfg.max_obs_per_lm
    obs_cam = np.full((P, O), C, np.int32)
    obs_uv = np.zeros((P, O, 2), np.float32)
    obs_ur = np.full((P, O), -1.0, np.float32)
    obs_ok = np.zeros((P, O), bool)
    cam_pick = [
        rng.choice(n_cams, size=min(O, n_cams), replace=False)
        for _ in range(n_pts)
    ]
    for p in range(n_pts):
        for o, c in enumerate(cam_pick[p]):
            Xc = Rs[c] @ pts[p] + ts[c]
            u = cfg.fx * Xc[0] / Xc[2] + cfg.cx
            v = cfg.fy * Xc[1] / Xc[2] + cfg.cy
            obs_cam[p, o] = c
            obs_uv[p, o] = [u + rng.normal(0, noise_px), v + rng.normal(0, noise_px)]
            obs_ok[p, o] = True
            if stereo_frac > 0 and cfg.bf > 0 and rng.random() < stereo_frac:
                obs_ur[p, o] = (
                    u - cfg.bf / Xc[2] + rng.normal(0, noise_px)
                )

    # perturb poses (except the two gauge cams) and points
    R0 = np.zeros((C, 3, 3), np.float32)
    R0[:] = np.eye(3)
    t0 = np.zeros((C, 3), np.float32)
    R0[:n_cams] = Rs
    t0[:n_cams] = ts
    cam_opt = np.zeros((C,), bool)
    cam_opt[2:n_cams] = True
    for c in range(2, n_cams):
        xi = rng.normal(0, perturb, 6).astype(np.float32)
        Rp, tp = geo.se3_retract(
            torch.from_numpy(R0[c]), torch.from_numpy(t0[c]), torch.from_numpy(xi)
        )
        R0[c], t0[c] = Rp.numpy(), tp.numpy()
    xyz0 = np.zeros((P, 3), np.float32)
    xyz0[:n_pts] = pts + rng.normal(0, perturb * 2, (n_pts, 3))

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    prob = BAProblem(
        cam_slots=dev(np.r_[np.arange(n_cams), np.full(C - n_cams, 999)], torch.int32),
        cam_opt=dev(cam_opt),
        R=dev(R0),
        t=dev(t0),
        lm_ids=dev(np.r_[np.arange(n_pts), np.full(P - n_pts, cfg.max_landmarks)], torch.int32),
        xyz=dev(xyz0),
        obs_cam=dev(obs_cam),
        obs_uv=dev(obs_uv),
        obs_w=dev(obs_ok.astype(np.float32)),
        obs_ok=dev(obs_ok),
        obs_feat=torch.zeros((P, O), dtype=torch.int32, device=device),
        obs_ur=dev(obs_ur) if stereo_frac > 0 else None,
    )
    return prob, Rs, ts, pts, n_cams, n_pts
