"""Trajectory export in TUM and KITTI formats (numpy copy of ``dialog_tpu/eval/trajectory.py``).

Poses are stored as world->camera (T_cw) internally; files contain
camera->world (T_wc), as the reference emits.
"""

from __future__ import annotations

import numpy as np


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) from rotation matrix (numpy, Shepperd)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def save_tum(path: str, timestamps, Rs, ts) -> None:
    """TUM format: `timestamp tx ty tz qx qy qz qw` of T_wc per line."""
    with open(path, "w") as f:
        for ts_, R, t in zip(timestamps, Rs, ts):
            R = np.asarray(R, np.float64)
            t = np.asarray(t, np.float64)
            Rwc = R.T
            twc = -Rwc @ t
            q = _quat_from_R(Rwc)
            f.write(
                f"{ts_:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
            )


def save_kitti(path: str, Rs, ts) -> None:
    """KITTI format: 3x4 row-major T_wc per line."""
    with open(path, "w") as f:
        for R, t in zip(Rs, ts):
            R = np.asarray(R, np.float64)
            t = np.asarray(t, np.float64)
            Rwc = R.T
            twc = -Rwc @ t
            P = np.concatenate([Rwc, twc[:, None]], axis=1).reshape(-1)
            f.write(" ".join(f"{x:.9e}" for x in P) + "\n")


def load_tum(path: str):
    """Read a TUM trajectory/groundtruth file -> (timestamps, positions [N,3],
    quaternions [N,4] (x,y,z,w))."""
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split()
            if len(v) < 8:
                continue
            ts.append(float(v[0]))
            pos.append([float(x) for x in v[1:4]])
            quat.append([float(x) for x in v[4:8]])
    return np.asarray(ts), np.asarray(pos), np.asarray(quat)
