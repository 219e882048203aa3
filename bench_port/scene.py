"""The benchmark's traffic generator: rendered synthetic scenes and the sweep over them.

A frozen copy of the port's ``datasets/synth.py`` (``make_scene``'s "sweep"
trajectory and ``render_image``), kept here so that a change to the port
cannot move the yardstick. Two differences: the landmarks' textures are drawn
from a seed of their own in one call (the original seeds each landmark's by
its index), and the Gaussian smoothing of the rasterized frames (OpenCV's ``GaussianBlur(img, (0, 0), 1.2)`` with
BORDER_REFLECT_101) runs on the device, all frames of a scene at once, in
plain elementwise float32 operations, so it is deterministic and takes no
host time per frame.

``sweep_order`` is the traffic: the camera runs the trajectory forward, then
backward, and so on, as a patrolling robot does, so a window of any length
needs no reset.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Scene(NamedTuple):
    xyz: np.ndarray        # f32[L, 3] world landmarks
    R: np.ndarray          # f32[T, 3, 3] world->camera per frame
    t: np.ndarray          # f32[T, 3]


def _lookat(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)):
    """World->camera (R, t) for a camera at ``eye`` looking at ``target``."""
    fwd = target - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / (np.linalg.norm(right) + 1e-12)
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], axis=0)
    return R_wc.astype(np.float32), (-R_wc @ eye).astype(np.float32)


def make_scene(seed: int, n_points: int, n_frames: int) -> Scene:
    """A random landmark cloud 4-12 m ahead and a smooth lateral sweep
    looking at its centre (the port's ``make_scene(trajectory="sweep")``)."""
    rng = np.random.default_rng(seed)
    rng.integers(0, 2**32, (n_points, 8), dtype=np.uint32)   # the descriptors the original draws first
    xyz = np.stack([rng.uniform(-4.0, 4.0, n_points), rng.uniform(-3.0, 3.0, n_points),
                    rng.uniform(4.0, 12.0, n_points)], axis=-1).astype(np.float32)
    Rs, ts = [], []
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1)
        eye = np.array([-1.5 + 3.0 * a, 0.3 * np.sin(2 * np.pi * a), -0.2 * a])
        R, t = _lookat(eye, np.array([0.0, 0.0, 8.0]))
        Rs.append(R)
        ts.append(t)
    return Scene(xyz, np.stack(Rs), np.stack(ts))


def shifted(scene: Scene, baseline: float) -> Scene:
    """The same scene seen by a camera ``baseline`` to the right (a stereo rig's right camera)."""
    return scene._replace(t=scene.t - np.array([baseline, 0.0, 0.0], np.float32))


def textures(n: int, seed: int, p: int = 11) -> np.ndarray:
    """Each landmark's p x p texture, drawn from ``seed`` in one call: f32[n, p, p]."""
    return np.random.default_rng(seed).uniform(60, 250, (n, p, p)).astype(np.float32)


def rasterize(scene: Scene, frame: int, cam: dict, tex: np.ndarray, patch_r: int = 5) -> np.ndarray:
    """Landmarks as texture patches, farther ones first (painter's order), before the blur: f32[H, W]."""
    R, t = scene.R[frame], scene.t[frame]
    Xc = scene.xyz @ R.T + t
    z = Xc[:, 2]
    u = cam["fx"] * Xc[:, 0] / np.maximum(z, 1e-9) + cam["cx"]
    v = cam["fy"] * Xc[:, 1] / np.maximum(z, 1e-9) + cam["cy"]
    H, W = cam["height"], cam["width"]
    img = np.full((H, W), 40.0, np.float32)
    m = patch_r + 1
    vis = (z > 0.1) & (u >= m) & (u < W - m) & (v >= m) & (v < H - m)
    order = np.argsort(-z[vis])
    for i in np.nonzero(vis)[0][order]:
        x0, y0 = int(round(u[i])), int(round(v[i]))
        img[y0 - patch_r : y0 + patch_r + 1, x0 - patch_r : x0 + patch_r + 1] = tex[i]
    return img


def gaussian_taps(sigma: float) -> np.ndarray:
    """OpenCV's f32 Gaussian kernel for a float image and ksize (0, 0)."""
    n = int(round(sigma * 4 * 2 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    taps = np.exp(-0.5 / (sigma * sigma) * x * x).astype(np.float32)
    return (taps.astype(np.float64) / float(np.sum(taps.astype(np.float64)))).astype(np.float32)


def _reflect101(n: int, r: int) -> torch.Tensor:
    """Source index of each of n + 2r padded positions under BORDER_REFLECT_101."""
    idx = np.arange(-r, n + r)
    idx = np.abs(idx)
    idx = np.where(idx > n - 1, 2 * (n - 1) - idx, idx)
    return torch.from_numpy(idx)


def blur(imgs: torch.Tensor, sigma: float = 1.2) -> torch.Tensor:
    """Separable Gaussian blur of f32[N, H, W] with BORDER_REFLECT_101 borders."""
    k = gaussian_taps(sigma)
    r = len(k) // 2
    N, H, W = imgs.shape
    p = imgs[:, :, _reflect101(W, r).to(imgs.device)]
    rows = torch.zeros_like(imgs)
    for i, w in enumerate(k):
        rows += float(w) * p[:, :, i : i + W]
    p = rows[:, _reflect101(H, r).to(imgs.device), :]
    out = torch.zeros_like(imgs)
    for i, w in enumerate(k):
        out += float(w) * p[:, i : i + H, :]
    return out


def render(scene: Scene, cam: dict, tex: np.ndarray, device, chunk: int = 64) -> torch.Tensor:
    """Every frame of ``scene`` with the landmarks' textures ``tex``: f32[T, H, W] on ``device``."""
    out = []
    for s in range(0, len(scene.R), chunk):
        raw = np.stack([rasterize(scene, i, cam, tex) for i in range(s, min(s + chunk, len(scene.R)))])
        out.append(blur(torch.from_numpy(raw).to(device)))
    return torch.cat(out)


def sweep_order(n_frames: int, start: int, count: int) -> list[int]:
    """Scene frame of each of ``count`` steps from step ``start`` of the
    back-and-forth sweep 0, 1, ..., T-1, T-2, ..., 1, 0, 1, ..."""
    period = 2 * (n_frames - 1)
    out = []
    for k in range(start, start + count):
        p = k % period
        out.append(p if p < n_frames else period - p)
    return out
