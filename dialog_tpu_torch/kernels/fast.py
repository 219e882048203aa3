"""Kernel A: fused FAST-9 score + NMS + rank (CUDA: ``csrc/fast.cu``).

Port of ``fast_nms_rank`` in ``dialog_tpu/kernels/fast.py``. Per pixel of one pyramid
level the rank map is

    rank = 0                      if not a FAST corner at min_th after 3x3 NMS
         = score                  if min_th < score <= th_fast
         = score + 1000           if score > th_fast   (two-tier bonus)

with the border mask folded in; score is OpenCV's FAST-9 score.
``fast_nms_rank_plain`` is the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import common

# 16-pixel Bresenham circle of radius 3, circularly ordered (dx, dy)
CIRCLE = [
    (3, 0), (3, 1), (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3), (0, -3), (1, -3), (2, -2), (3, -1),
]


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """FAST-9 score of every pixel (edge-padded image), f32[H, W]."""
    H, W = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    neigh = torch.stack([p[3 + dy : 3 + dy + H, 3 + dx : 3 + dx + W] for dx, dy in CIRCLE])
    diff = neigh - img[None]

    def run9_min(d):
        m2 = torch.minimum(d, torch.roll(d, -1, 0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, 0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, 0))
        m9 = torch.minimum(m8, torch.roll(d, -8, 0))
        return torch.amax(m9, 0)

    return torch.maximum(run9_min(diff), run9_min(-diff))


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression keeping strict local maxima (-inf padding)."""
    mx = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= mx, score, torch.zeros_like(score))


def fast_nms_rank_plain(img, min_th: float, th_fast: float, border: int) -> torch.Tensor:
    H, W = img.shape
    s = nms3(fast_score(img))
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    s = torch.where(inb, s, torch.zeros_like(s))
    bonus = torch.where(s > th_fast, 1000.0, 0.0)
    return torch.where(s > min_th, s + bonus, torch.zeros_like(s))


def fast_nms_rank(img: torch.Tensor, min_th: float, th_fast: float, border: int) -> torch.Tensor:
    """Per-pixel FAST-9 corner rank map f32[H, W] (0 = rejected)."""
    if common.route(img) == "cpu":
        return fast_nms_rank_plain(img, min_th, th_fast, border)
    from .build import load

    lib = load("fast")
    H, W = img.shape
    common.require(img, "img", torch.float32, (H, W), img.device)
    out = torch.empty_like(img)
    fn = lib.fast_nms_rank_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    err = fn(common.ptr(img), common.ptr(out), H, W, float(min_th), float(th_fast),
             int(border), common.stream_ptr(img.device))
    common.launches["fast_nms_rank"] += 1
    common.check(err, "fast_nms_rank")
    return out
