"""TUM RGB-D dataset loader.

Replaces the reference's TUM example drivers + association tool (canonical
``Examples/Monocular/mono_tum.cc``, ``Examples/RGB-D/rgbd_tum.cc``,
``Examples/RGB-D/associate.py`` — SURVEY.md §2.1): reads ``rgb.txt`` /
``depth.txt`` image lists, associates rgb/depth pairs by nearest timestamp,
and yields grayscale (and depth) arrays, decoded by ``datasets.png`` with
cv2's bits. A depth file that does not exist is skipped, as cv2's ``None``
is in the reference; one that does not decode raises.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from . import png


def _read_list(path: str) -> list[tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            out.append((float(ts), rel))
    return out


def associate(
    a: list[tuple[float, str]],
    b: list[tuple[float, str]],
    max_dt: float = 0.02,
) -> list[tuple[float, str, str]]:
    """Nearest-timestamp association (reference: associate.py)."""
    out = []
    bi = 0
    for ts, rel in a:
        while bi + 1 < len(b) and abs(b[bi + 1][0] - ts) <= abs(b[bi][0] - ts):
            bi += 1
        if b and abs(b[bi][0] - ts) <= max_dt:
            out.append((ts, rel, b[bi][1]))
    return out


def _load_gray(path: str) -> np.ndarray:
    return png.read_gray(path).astype(np.float32)


def iter_mono(root: str) -> Iterator[tuple[float, np.ndarray]]:
    """Yield (timestamp, gray image) for a TUM sequence directory."""
    for ts, rel in _read_list(os.path.join(root, "rgb.txt")):
        yield ts, _load_gray(os.path.join(root, rel))


def iter_rgbd(root: str) -> Iterator[tuple[float, np.ndarray, np.ndarray]]:
    """Yield (timestamp, gray, depth_raw) pairs (depth in sensor units)."""
    rgb = _read_list(os.path.join(root, "rgb.txt"))
    depth = _read_list(os.path.join(root, "depth.txt"))
    for ts, rrel, drel in associate(rgb, depth):
        try:
            d = png.read_unchanged(os.path.join(root, drel))
        except FileNotFoundError:
            continue
        yield ts, _load_gray(os.path.join(root, rrel)), d.astype(np.float32)


def load_groundtruth(root: str):
    """(timestamps, positions [N,3]) from groundtruth.txt."""
    from ..eval.trajectory import load_tum

    return load_tum(os.path.join(root, "groundtruth.txt"))[:2]
