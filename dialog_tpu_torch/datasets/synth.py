"""Synthetic scenes with exact ground truth (numpy copy of ``dialog_tpu/datasets/synth.py``).

``make_scene`` draws a random landmark cloud and a smooth camera path with
known poses; ``render_image`` rasterizes the landmarks as distinctive texture
patches so the full image frontend can run in the loop, and ``render_depth``
gives the depth map aligned with it; ``observe`` bypasses the frontend and
emits projected, noisy keypoints (with stereo right-x and depth when
``cfg.bf > 0``). All produce the same arrays as the reference from the same
seed. The reference smooths the
render with ``cv2.GaussianBlur(img, (0, 0), 1.2)`` when OpenCV is importable;
this copy implements that blur itself (``gaussian_blur_cv``), so it needs
no OpenCV.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import EngineConfig
from ..containers import FrameArrays


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


def observe(scene: SynthScene, frame: int, noise_px: float = 0.5, desc_flips: int = 8,
            seed: int | None = None, drop_rate: float = 0.0, device="cuda"):
    """Project the scene into frame ``frame`` -> (FrameArrays on ``device``,
    lm_ids i32[F] numpy).

    lm_ids[j] is the ground-truth landmark index of feature j (-1 for padding).
    Keypoints carry N(0, noise_px) pixel noise and descriptors ``desc_flips``
    flipped bits, drawn from the reference's numpy stream; with ``cfg.bf > 0``
    each keypoint also carries its true depth and the right-x ``u - bf/z``.
    """
    cfg = scene.cfg
    rng = np.random.default_rng(frame * 7919 + 13 if seed is None else seed)
    R, t = scene.R[frame], scene.t[frame]
    Xc = scene.xyz @ R.T + t
    z = Xc[:, 2]
    u = cfg.fx * Xc[:, 0] / np.maximum(z, 1e-9) + cfg.cx
    v = cfg.fy * Xc[:, 1] / np.maximum(z, 1e-9) + cfg.cy
    vis = ((z > 0.1) & (u >= 8) & (u < cfg.width - 8) & (v >= 8) & (v < cfg.height - 8)
           & (rng.random(len(z)) >= drop_rate))
    ids = np.nonzero(vis)[0]
    rng.shuffle(ids)
    ids = ids[: cfg.max_features]
    n = len(ids)

    F = cfg.max_features
    uv = np.zeros((F, 2), np.float32)
    uv[:n, 0] = u[ids] + rng.normal(0, noise_px, n)
    uv[:n, 1] = v[ids] + rng.normal(0, noise_px, n)
    # detection octave tracks apparent size (closer -> coarser level)
    octave = np.zeros((F,), np.int32)
    dist = np.linalg.norm(scene.xyz[ids] - (-(R.T @ t)), axis=1)
    octave[:n] = np.clip(
        np.round(np.log(25.0 / np.maximum(dist, 1e-3)) / np.log(cfg.scale_factor)), 0, cfg.n_levels - 1
    ).astype(np.int32)
    desc = np.zeros((F, 8), np.uint32)
    desc[:n] = scene.desc[ids]
    if desc_flips > 0 and n > 0:
        words = rng.integers(0, 8, (n, desc_flips))
        bits = rng.integers(0, 32, (n, desc_flips))
        for i in range(n):
            for w, b in zip(words[i], bits[i]):
                desc[i, w] ^= np.uint32(1 << b)
    depth = np.full((F,), -1.0, np.float32)
    u_right = np.full((F,), -1.0, np.float32)
    if cfg.bf > 0:
        depth[:n] = z[ids]
        u_right[:n] = uv[:n, 0] - cfg.bf / np.maximum(z[ids], 1e-9)
    valid = np.zeros((F,), bool)
    valid[:n] = True
    lm_ids = np.full((F,), -1, np.int32)
    lm_ids[:n] = ids

    def t_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    fr = FrameArrays(
        uv=t_(uv), uv_raw=t_(uv.copy()), response=t_(np.where(valid, 50.0, 0.0).astype(np.float32)),
        octave=t_(octave), angle=t_(np.zeros((F,), np.float32)), desc=t_(desc.view(np.int32)),
        valid=t_(valid), u_right=t_(u_right), depth=t_(depth),
    )
    return fr, lm_ids


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


@functools.lru_cache(maxsize=4)
def _textures(n: int, p: int) -> np.ndarray:
    """Landmark i's fixed p x p texture, seeded by its index, for i < n
    (read-only; drawn once per scene size instead of once per frame)."""
    out = np.stack([np.random.default_rng(1000 + i).uniform(60, 250, (p, p)) for i in range(n)])
    out = out.astype(np.float32)
    out.flags.writeable = False
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
    tex = _textures(len(z), p)
    for i in np.nonzero(vis)[0][order]:
        x0, y0 = int(round(u[i])), int(round(v[i]))
        img[y0 - patch_r : y0 + patch_r + 1, x0 - patch_r : x0 + patch_r + 1] = tex[i]
    # camera PSF: smooth the texture so descriptors are stable to sub-pixel shifts
    return gaussian_blur_cv(img, 1.2)


def render_depth(scene: SynthScene, frame: int, patch_r: int = 5) -> np.ndarray:
    """Depth map aligned with ``render_image``: f32[H, W] metres, 0 = none.

    Each landmark's patch carries its camera-frame depth, drawn in the same
    painter's order as the intensity render."""
    cfg = scene.cfg
    R, t = scene.R[frame], scene.t[frame]
    Xc = scene.xyz @ R.T + t
    z = Xc[:, 2]
    u = cfg.fx * Xc[:, 0] / np.maximum(z, 1e-9) + cfg.cx
    v = cfg.fy * Xc[:, 1] / np.maximum(z, 1e-9) + cfg.cy
    depth = np.zeros((cfg.height, cfg.width), np.float32)
    m = patch_r + 1
    vis = (z > 0.1) & (u >= m) & (u < cfg.width - m) & (v >= m) & (v < cfg.height - m)
    order = np.argsort(-z[vis])
    for i in np.nonzero(vis)[0][order]:
        x0, y0 = int(round(u[i])), int(round(v[i]))
        depth[y0 - patch_r : y0 + patch_r + 1, x0 - patch_r : x0 + patch_r + 1] = z[i]
    return depth
