"""Relative pose error + KITTI odometry devkit metrics.

The reference is evaluated with the TUM RGB-D benchmark's
``evaluate_rpe.py`` and the KITTI odometry devkit (SURVEY.md §4); this
module reimplements both so the framework evaluates itself without the
external tools:

* ``rpe``: per-pair relative pose error at a fixed frame delta
  (E_i = (Q_i^-1 Q_{i+d})^-1 (P_i^-1 P_{i+d})), translational drift in
  metres and rotational drift in radians — TUM evaluate_rpe semantics.
* ``kitti_odometry_errors``: average translational error (%) and
  rotational error (deg/m) over all subsequences of length
  100..800 m — the devkit's headline table numbers.

All inputs are world->camera poses (the engine's convention,
``Engine.final_poses``). A numpy copy of the reference's module.
"""

from __future__ import annotations

import numpy as np


def _inv(R, t):
    return R.T, -R.T @ t


def _compose(Ra, ta, Rb, tb):
    return Ra @ Rb, Ra @ tb + ta


def _rot_angle(R) -> float:
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def rpe(
    est_R: np.ndarray, est_t: np.ndarray,
    gt_R: np.ndarray, gt_t: np.ndarray,
    delta: int = 1,
):
    """Relative pose errors at frame delta: (trans [m], rot [rad]) arrays."""
    n = len(est_R)
    trans, rot = [], []
    for i in range(n - delta):
        j = i + delta
        # relative motions P = est_i^-1 est_j, Q = gt_i^-1 gt_j (cam_i frame)
        Ri, ti = _inv(est_R[i], est_t[i])
        Pr, pt = _compose(est_R[j], est_t[j], Ri, ti)
        Gi, gi = _inv(gt_R[i], gt_t[i])
        Qr, qt = _compose(gt_R[j], gt_t[j], Gi, gi)
        Qi, qi = _inv(Qr, qt)
        Er, et = _compose(Qi, qi, Pr, pt)
        trans.append(np.linalg.norm(et))
        rot.append(_rot_angle(Er))
    return np.asarray(trans), np.asarray(rot)


def rpe_rmse(
    est_R, est_t, gt_R, gt_t, delta: int = 1
) -> tuple[float, float]:
    """(translational RMSE [m], rotational RMSE [rad]) at the given delta."""
    tr, ro = rpe(est_R, est_t, gt_R, gt_t, delta)
    if len(tr) == 0:
        return 0.0, 0.0
    return float(np.sqrt(np.mean(tr**2))), float(np.sqrt(np.mean(ro**2)))


_KITTI_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def kitti_odometry_errors(
    est_R: np.ndarray, est_t: np.ndarray,
    gt_R: np.ndarray, gt_t: np.ndarray,
    lengths=_KITTI_LENGTHS,
    step: int = 10,
):
    """KITTI devkit metric: (avg translation error fraction, avg rotation
    error rad/m) over all subsequences of the given path lengths.

    ``step`` subsamples start frames (the devkit uses every 10th frame).
    Returns (t_err, r_err, n_segments); zeros if the trajectory is shorter
    than the smallest length.
    """
    n = len(gt_R)
    C_gt = np.stack([-gt_R[i].T @ gt_t[i] for i in range(n)])
    dist = np.concatenate(
        [[0.0], np.cumsum(np.linalg.norm(np.diff(C_gt, axis=0), axis=1))]
    )

    def frame_at(start: int, length: float):
        target = dist[start] + length
        j = int(np.searchsorted(dist, target))
        return j if j < n else -1

    t_errs, r_errs = [], []
    for start in range(0, n, step):
        for length in lengths:
            j = frame_at(start, length)
            if j < 0:
                continue
            Ri, ti = _inv(est_R[start], est_t[start])
            Pr, pt = _compose(est_R[j], est_t[j], Ri, ti)
            Gi, gi = _inv(gt_R[start], gt_t[start])
            Qr, qt = _compose(gt_R[j], gt_t[j], Gi, gi)
            Qi, qi = _inv(Qr, qt)
            Er, et = _compose(Qi, qi, Pr, pt)
            t_errs.append(np.linalg.norm(et) / length)
            r_errs.append(_rot_angle(Er) / length)
    if not t_errs:
        return 0.0, 0.0, 0
    return float(np.mean(t_errs)), float(np.mean(r_errs)), len(t_errs)
