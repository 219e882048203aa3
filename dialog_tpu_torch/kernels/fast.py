"""Kernel A: fused FAST-9 score + NMS + rank (CUDA: ``csrc/fast.cu``).

Port of ``fast_nms_rank`` in ``dialog_tpu/kernels/fast.py``. Per pixel of one pyramid
level the rank map is

    rank = 0                      if not a FAST corner at min_th after 3x3 NMS
         = score                  if min_th < score <= th_fast
         = score + 1000           if score > th_fast   (two-tier bonus)

with the border mask folded in; score is OpenCV's FAST-9 score.
``fast_nms_rank_levels`` takes all pyramid levels of an image in one launch
and may write each rank map into a zero-padded buffer whose sides are
multiples of ``pad_to`` (the detector's cell grid); ``fast_nms_rank`` is its
one-level case. ``fast_nms_rank_plain`` and ``fast_nms_rank_levels_plain`` are
the same functions in plain PyTorch.
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


def _padded(n: int, pad_to: int) -> int:
    return -(-n // pad_to) * pad_to


def fast_nms_rank_levels_plain(levels, min_th: float, th_fast: float, border: int, pad_to: int = 1):
    """``fast_nms_rank_plain`` level by level, each zero-padded at the bottom
    and the right to multiples of ``pad_to``."""
    out = []
    for img in levels:
        H, W = img.shape
        s = fast_nms_rank_plain(img, min_th, th_fast, border)
        out.append(F.pad(s, (0, _padded(W, pad_to) - W, 0, _padded(H, pad_to) - H)))
    return out


MAX_LEVELS = 32   # levels one launch takes (the table's room in csrc/fast.cu)


def fast_nms_rank_levels(levels, min_th: float, th_fast: float, border: int, pad_to: int = 1):
    """Rank maps of up to ``MAX_LEVELS`` images (f32[H_l, W_l]) in one launch.

    Returns one f32[ceil(H_l / pad_to) * pad_to, ceil(W_l / pad_to) * pad_to]
    per level: the level's rank map (see ``fast_nms_rank``) with zeros beyond
    the image. On the card the outputs are views of one allocation.
    """
    levels = list(levels)
    if not levels:
        return []
    if pad_to < 1:
        raise ValueError(f"fast_nms_rank_levels: pad_to must be at least 1, got {pad_to}")
    if common.route(levels[0]) == "cpu":
        return fast_nms_rank_levels_plain(levels, min_th, th_fast, border, pad_to)
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"fast_nms_rank_levels: at most {MAX_LEVELS} levels in one launch, got {len(levels)}")
    dev = levels[0].device
    for l, img in enumerate(levels):
        if img.dim() != 2 or img.shape[0] < 1 or img.shape[1] < 1:
            raise ValueError(f"level {l}: expected a non-empty f32[H, W] image, got {tuple(img.shape)}")
        common.require(img, f"level {l}", torch.float32, img.shape, dev)
    from .build import load

    n = len(levels)
    dims, outs, total = [], [], 0
    for img in levels:
        H, W = img.shape
        Ho, Wo = _padded(H, pad_to), _padded(W, pad_to)
        dims += [H, W, Ho, Wo]
        outs.append((total, Ho, Wo))
        total += Ho * Wo
    flat = torch.empty((total,), dtype=torch.float32, device=dev)
    base = flat.data_ptr()
    err = load("fast").fast_levels_launch(
        (ctypes.c_void_p * n)(*[img.data_ptr() for img in levels]),
        (ctypes.c_void_p * n)(*[base + 4 * off for off, _, _ in outs]), (ctypes.c_int * (4 * n))(*dims), n,
        float(min_th), float(th_fast), int(border), common.stream_ptr(dev))
    common.launches["fast_nms_rank"] += 1
    common.check(err, "fast_nms_rank")
    return [flat[off : off + Ho * Wo].view(Ho, Wo) for off, Ho, Wo in outs]


def fast_nms_rank(img: torch.Tensor, min_th: float, th_fast: float, border: int) -> torch.Tensor:
    """Per-pixel FAST-9 corner rank map f32[H, W] (0 = rejected)."""
    if common.route(img) == "cpu":
        return fast_nms_rank_plain(img, min_th, th_fast, border)
    return fast_nms_rank_levels([img], min_th, th_fast, border)[0]
