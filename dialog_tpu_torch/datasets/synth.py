"""Synthetic scenes with exact ground truth (numpy copy of ``dialog_tpu/datasets/synth.py``).

``make_scene`` draws a random landmark cloud and a smooth camera path with
known poses; ``render_image`` rasterizes the landmarks as distinctive texture
patches so the full image frontend can run in the loop. Both produce the
same arrays as the reference from the same seed. The reference smooths the
render with ``cv2.GaussianBlur(img, (0, 0), 1.2)`` when OpenCV is importable;
this copy implements that blur itself (``gaussian_blur_cv``), so it needs
no OpenCV.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..config import EngineConfig


class SynthScene(NamedTuple):
    xyz: np.ndarray        # f32[L, 3] world landmarks
    desc: np.ndarray       # u32[L, 8] landmark descriptors
    R: np.ndarray          # f32[T, 3, 3] world->camera per frame
    t: np.ndarray          # f32[T, 3]
    cfg: EngineConfig


def _lookat(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)):
    """World->camera (R, t) for a camera at `eye` looking at `target`."""
    fwd = target - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / (np.linalg.norm(right) + 1e-12)
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], axis=0)
    t = -R_wc @ eye
    return R_wc.astype(np.float32), t.astype(np.float32)


def make_scene(seed: int = 0, n_points: int = 600, n_frames: int = 30, trajectory: str = "sweep",
               cfg: EngineConfig | None = None, period: int | None = None) -> SynthScene:
    """Random landmark cloud + smooth camera path ("sweep" or "loop")."""
    cfg = cfg or EngineConfig()
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 2**32, (n_points, 8), dtype=np.uint32)

    Rs, ts = [], []
    if trajectory == "sweep":
        xyz = np.stack(
            [rng.uniform(-4.0, 4.0, n_points), rng.uniform(-3.0, 3.0, n_points), rng.uniform(4.0, 12.0, n_points)],
            axis=-1,
        ).astype(np.float32)
        for i in range(n_frames):
            a = i / max(n_frames - 1, 1)
            eye = np.array([-1.5 + 3.0 * a, 0.3 * np.sin(2 * np.pi * a), -0.2 * a])
            R, t = _lookat(eye, np.array([0.0, 0.0, 8.0]))
            Rs.append(R)
            ts.append(t)
    elif trajectory == "loop":
        path_r = 10.0
        ang = rng.uniform(0, 2 * np.pi, n_points)
        rad = rng.uniform(14.0, 20.0, n_points)
        xyz = np.stack(
            [rad * np.sin(ang), rng.uniform(-3.0, 3.0, n_points), rad * np.cos(ang)], axis=-1
        ).astype(np.float32)
        per = period or n_frames
        for i in range(n_frames):
            th = 2 * np.pi * i / per
            eye = path_r * np.array([np.sin(th), 0.0, np.cos(th)])
            R, t = _lookat(eye, 2.5 * path_r * np.array([np.sin(th), 0.0, np.cos(th)]))
            Rs.append(R)
            ts.append(t)
    else:
        raise ValueError(f"unknown trajectory '{trajectory}'")
    return SynthScene(xyz, desc, np.stack(Rs), np.stack(ts), cfg)


def _gaussian_taps(sigma: float) -> np.ndarray:
    """OpenCV's f32 Gaussian kernel for a float image and ksize (0, 0)."""
    n = int(round(sigma * 4 * 2 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    taps = np.exp(-0.5 / (sigma * sigma) * x * x).astype(np.float32)
    total = float(np.sum(taps.astype(np.float64)))
    return (taps.astype(np.float64) / total).astype(np.float32)


def gaussian_blur_cv(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur with BORDER_REFLECT_101 borders, as
    ``cv2.GaussianBlur(img, (0, 0), sigma)`` computes it for f32 images."""
    k = _gaussian_taps(sigma)
    r = len(k) // 2
    H, W = img.shape
    p = np.pad(img.astype(np.float32), ((0, 0), (r, r)), mode="reflect")
    rows = np.zeros((H, W), np.float32)
    for i, w in enumerate(k):
        rows += w * p[:, i : i + W]
    p = np.pad(rows, ((r, r), (0, 0)), mode="reflect")
    out = np.zeros((H, W), np.float32)
    for i, w in enumerate(k):
        out += w * p[i : i + H, :]
    return out


def render_image(scene: SynthScene, frame: int, patch_r: int = 5) -> np.ndarray:
    """Rasterize landmarks as distinctive texture patches -> f32[H, W]."""
    cfg = scene.cfg
    R, t = scene.R[frame], scene.t[frame]
    Xc = scene.xyz @ R.T + t
    z = Xc[:, 2]
    u = cfg.fx * Xc[:, 0] / np.maximum(z, 1e-9) + cfg.cx
    v = cfg.fy * Xc[:, 1] / np.maximum(z, 1e-9) + cfg.cy
    img = np.full((cfg.height, cfg.width), 40.0, np.float32)
    p = 2 * patch_r + 1
    m = patch_r + 1
    vis = (z > 0.1) & (u >= m) & (u < cfg.width - m) & (v >= m) & (v < cfg.height - m)
    # farther landmarks drawn first so near ones overwrite (painter's order)
    order = np.argsort(-z[vis])
    for i in np.nonzero(vis)[0][order]:
        tex = np.random.default_rng(1000 + int(i)).uniform(60, 250, (p, p)).astype(np.float32)
        x0, y0 = int(round(u[i])), int(round(v[i]))
        img[y0 - patch_r : y0 + patch_r + 1, x0 - patch_r : x0 + patch_r + 1] = tex
    # camera PSF: smooth the texture so descriptors are stable to sub-pixel shifts
    return gaussian_blur_cv(img, 1.2)
