"""EuRoC MAV dataset loader.

Replaces the reference's EuRoC drivers (canonical
``Examples/Monocular/mono_euroc.cc``, ``Examples/Stereo/stereo_euroc.cc`` —
SURVEY.md §2.1): reads the ASL folder layout
(``mav0/cam0/data.csv`` + ``mav0/cam0/data/<ts>.png``), decoded by
``datasets.png`` with cv2's bits.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from . import png


def _read_csv(cam_dir: str) -> list[tuple[float, str]]:
    out = []
    with open(os.path.join(cam_dir, "data.csv")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts_ns, name = line.split(",")[:2]
            out.append((float(ts_ns) * 1e-9, name.strip()))
    return out


def _load_gray(path: str) -> np.ndarray:
    return png.read_gray(path).astype(np.float32)


def iter_mono(root: str, cam: str = "cam0") -> Iterator[tuple[float, np.ndarray]]:
    """root: the sequence dir containing mav0/."""
    cam_dir = os.path.join(root, "mav0", cam)
    for ts, name in _read_csv(cam_dir):
        yield ts, _load_gray(os.path.join(cam_dir, "data", name))


def iter_stereo(root: str) -> Iterator[tuple[float, np.ndarray, np.ndarray]]:
    c0 = os.path.join(root, "mav0", "cam0")
    c1 = os.path.join(root, "mav0", "cam1")
    list0 = _read_csv(c0)
    names1 = {name for _, name in _read_csv(c1)}
    for ts, name in list0:
        if name not in names1:
            continue
        yield (
            ts,
            _load_gray(os.path.join(c0, "data", name)),
            _load_gray(os.path.join(c1, "data", name)),
        )


def load_groundtruth(root: str):
    """(timestamps, positions [N,3]) from the state estimate CSV."""
    p = os.path.join(
        root, "mav0", "state_groundtruth_estimate0", "data.csv"
    )
    rows = np.loadtxt(p, delimiter=",", skiprows=1, usecols=(0, 1, 2, 3))
    return rows[:, 0] * 1e-9, rows[:, 1:4]
