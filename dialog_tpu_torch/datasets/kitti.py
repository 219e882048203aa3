"""KITTI odometry dataset loader.

Replaces the reference's KITTI drivers (canonical
``Examples/Stereo/stereo_kitti.cc``, ``Examples/Monocular/mono_kitti.cc`` —
SURVEY.md §2.1): reads ``times.txt`` and the ``image_0`` / ``image_1``
grayscale streams of a sequence directory, decoded by ``datasets.png``
with cv2's bits.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from . import png


def _load_gray(path: str) -> np.ndarray:
    return png.read_gray(path).astype(np.float32)


def read_times(seq_dir: str) -> list[float]:
    with open(os.path.join(seq_dir, "times.txt")) as f:
        return [float(x) for x in f.read().split()]


def iter_stereo(seq_dir: str) -> Iterator[tuple[float, np.ndarray, np.ndarray]]:
    """Yield (timestamp, left, right) for a KITTI sequence dir (.../00)."""
    times = read_times(seq_dir)
    for i, ts in enumerate(times):
        name = f"{i:06d}.png"
        yield (
            ts,
            _load_gray(os.path.join(seq_dir, "image_0", name)),
            _load_gray(os.path.join(seq_dir, "image_1", name)),
        )


def iter_mono(seq_dir: str) -> Iterator[tuple[float, np.ndarray]]:
    times = read_times(seq_dir)
    for i, ts in enumerate(times):
        yield ts, _load_gray(os.path.join(seq_dir, "image_0", f"{i:06d}.png"))


def load_poses(path: str) -> np.ndarray:
    """Ground-truth poses file (3x4 row-major per line) -> positions [N, 3]."""
    P = np.loadtxt(path).reshape(-1, 3, 4)
    return P[:, :, 3]


def load_poses_full(path: str):
    """Full ground-truth poses as world->camera (R [N,3,3], t [N,3]).

    The devkit file stores camera-to-world T_wc per line; the engine's
    convention (and eval.rpe's input) is world->camera, so invert.
    """
    P = np.loadtxt(path).reshape(-1, 3, 4).astype(np.float32)
    R_wc, C = P[:, :, :3], P[:, :, 3]
    R_cw = np.transpose(R_wc, (0, 2, 1))
    t_cw = -np.einsum("nij,nj->ni", R_cw, C)
    return R_cw, t_cw
