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
one-level case, and ``fast_nms_rank_levels_batch`` takes the levels of a whole
batch of same-shape images ([B, H_l, W_l] stacks) in one launch.
``fast_nms_rank_plain``, ``fast_nms_rank_levels_plain`` and
``fast_nms_rank_levels_batch_plain`` are the same functions in plain PyTorch.
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
    """FAST-9 score of every pixel (edge-padded image), f32[..., H, W]."""
    H, W = img.shape[-2:]
    p = F.pad(img.reshape(-1, 1, H, W), (3, 3, 3, 3), mode="replicate").reshape(img.shape[:-2] + (H + 6, W + 6))
    neigh = torch.stack([p[..., 3 + dy : 3 + dy + H, 3 + dx : 3 + dx + W] for dx, dy in CIRCLE])
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
    H, W = score.shape[-2:]
    mx = F.max_pool2d(score.reshape(-1, 1, H, W), 3, stride=1, padding=1).reshape(score.shape)
    return torch.where(score >= mx, score, torch.zeros_like(score))


def fast_nms_rank_plain(img, min_th: float, th_fast: float, border: int) -> torch.Tensor:
    """Rank map of f32[H, W], or of every image of f32[B, H, W]: min/max and
    differences only, so an image's result does not depend on the batch."""
    H, W = img.shape[-2:]
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
    and the right to multiples of ``pad_to``. A level may be one image
    f32[H, W] or a stack f32[B, H, W]."""
    out = []
    for img in levels:
        H, W = img.shape[-2:]
        s = fast_nms_rank_plain(img, min_th, th_fast, border)
        out.append(F.pad(s, (0, _padded(W, pad_to) - W, 0, _padded(H, pad_to) - H)))
    return out


fast_nms_rank_levels_batch_plain = fast_nms_rank_levels_plain   # the plain version takes stacks as they are

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
    for l, img in enumerate(levels):
        if img.dim() != 2:
            raise ValueError(f"level {l}: expected an f32[H, W] image, got {tuple(img.shape)}")
    outs = _launch_levels([img[None] for img in levels], min_th, th_fast, border, pad_to, "fast_nms_rank")
    return [o[0] for o in outs]


def fast_nms_rank_levels_batch(levels, min_th: float, th_fast: float, border: int, pad_to: int = 1):
    """Rank maps of a batch of B same-shape images in ONE launch: ``levels`` is
    the pyramid as up to ``MAX_LEVELS`` contiguous stacks f32[B, H_l, W_l]
    (level l of every image). Returns one f32[B, ceil(H_l / pad_to) * pad_to,
    ceil(W_l / pad_to) * pad_to] per level; image b's maps equal
    ``fast_nms_rank_levels`` of its own levels, bit for bit."""
    levels = list(levels)
    if not levels:
        return []
    if pad_to < 1:
        raise ValueError(f"fast_nms_rank_levels_batch: pad_to must be at least 1, got {pad_to}")
    B = levels[0].shape[0]
    for l, img in enumerate(levels):
        if img.dim() != 3 or img.shape[0] != B:
            raise ValueError(f"level {l}: expected an f32[{B}, H, W] stack, got {tuple(img.shape)}")
    if common.route(levels[0]) == "cpu":
        return fast_nms_rank_levels_batch_plain(levels, min_th, th_fast, border, pad_to)
    return _launch_levels(levels, min_th, th_fast, border, pad_to, "fast_nms_rank_batch")


def _launch_levels(levels, min_th, th_fast, border, pad_to, count):
    """One launch of kernel A over the stacks f32[B, H_l, W_l]; adds one to
    ``common.launches[count]``. The outputs are views of one allocation."""
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"{count}: at most {MAX_LEVELS} levels in one launch, got {len(levels)}")
    dev = levels[0].device
    B = levels[0].shape[0]
    for l, img in enumerate(levels):
        if min(img.shape) < 1:
            raise ValueError(f"level {l}: expected non-empty images, got {tuple(img.shape)}")
        common.require(img, f"level {l}", torch.float32, img.shape, dev)
    from .build import load

    n = len(levels)
    dims, outs, total = [], [], 0
    for img in levels:
        H, W = img.shape[1:]
        Ho, Wo = _padded(H, pad_to), _padded(W, pad_to)
        dims += [H, W, Ho, Wo]
        outs.append((total, Ho, Wo))
        total += B * Ho * Wo
    flat = torch.empty((total,), dtype=torch.float32, device=dev)
    base = flat.data_ptr()
    err = load("fast").fast_levels_batch_launch(
        (ctypes.c_void_p * n)(*[img.data_ptr() for img in levels]),
        (ctypes.c_void_p * n)(*[base + 4 * off for off, _, _ in outs]), (ctypes.c_int * (4 * n))(*dims), n, B,
        float(min_th), float(th_fast), int(border), common.stream_ptr(dev))
    common.launches[count] += 1
    common.check(err, count)
    return [flat[off : off + B * Ho * Wo].view(B, Ho, Wo) for off, Ho, Wo in outs]


def fast_nms_rank(img: torch.Tensor, min_th: float, th_fast: float, border: int) -> torch.Tensor:
    """Per-pixel FAST-9 corner rank map f32[H, W] (0 = rejected)."""
    if common.route(img) == "cpu":
        return fast_nms_rank_plain(img, min_th, th_fast, border)
    return fast_nms_rank_levels([img], min_th, th_fast, border)[0]
