"""Absolute trajectory error (numpy copy of ``dialog_tpu/eval/ate.py``; TUM evaluate_ate.py).

Aligns the estimated trajectory to ground truth with a (optionally scaled)
Umeyama/Horn similarity — monocular trajectories need scale alignment —
and reports the RMSE of translational residuals.
"""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Find (s, R, t) minimizing ||gt - (s R est + t)||; returns (s, R, t)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / len(est)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    var_e = (ec**2).sum(1).mean()
    s = float(np.trace(np.diag(S) @ D) / var_e) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = True) -> float:
    """RMSE of aligned translational error. est, gt: [N, 3] positions."""
    s, R, t = align_umeyama(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    return float(np.sqrt((err**2).mean()))


def rpe_translation(est: np.ndarray, gt: np.ndarray, delta: int = 1) -> float:
    """RMSE of relative translational drift over `delta`-frame intervals."""
    e = np.diff(est[::delta], axis=0)
    g = np.diff(gt[::delta], axis=0)
    n = min(len(e), len(g))
    err = np.linalg.norm(e[:n] - g[:n], axis=1)
    return float(np.sqrt((err**2).mean()))


def kitti_translation_error(
    est: np.ndarray, gt: np.ndarray,
    lengths=(100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0),
) -> float:
    """KITTI odometry devkit metric: mean translational error (%) averaged
    over sub-trajectories of the standard lengths. est/gt: positions [N, 3]
    in metres (metric scale — stereo/RGB-D)."""
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    dist = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(gt, axis=0), axis=1))])
    errs = []
    for L in lengths:
        for i in range(0, n, 10):
            j = np.searchsorted(dist, dist[i] + L)
            if j >= n:
                break
            gt_d = gt[j] - gt[i]
            est_d = est[j] - est[i]
            errs.append(np.linalg.norm(est_d - gt_d) / max(L, 1e-9))
    return float(np.mean(errs) * 100.0) if errs else float("nan")
