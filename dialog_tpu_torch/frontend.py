"""ORB-style feature frontend (port of ``dialog_tpu/frontend.py``).

8-level image pyramid, FAST-9 detection through kernel A, per-cell top-K
selection, intensity-centroid orientation and 256-bit steered BRIEF
descriptors with the orientation discretized to 30 bins of 12 degrees.

The sampling pattern, the resize and blur operators and the comparison
tables come from the reference's numpy code (``RandomState(1234)``), so both
packages sample identical points. The TPU-only forms are gone: patches are
gathered by plain indexing, and each descriptor bit is the difference of
two bf16-rounded blurred samples (the reference's {-1, 0, +1} matmul has one
+1 and one -1 per row, so the f32 result is the same, bit for bit).

Top-k keeps the reference's tie rule (lower index first) through a stable
descending sort.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import ops
from .config import EngineConfig
from .containers import FrameArrays
from .instrument import span
from .kernels.fast import fast_nms_rank_levels, fast_nms_rank_levels_batch

PATCH_R = 15          # orientation / descriptor patch radius
PATCH = 2 * PATCH_R + 1
BORDER = PATCH_R + 4  # keep full patches inside the image (+blur margin)
N_ANGLE_BINS = 30     # 12 deg orientation discretization (ORB paper §4.3)


def _brief_pattern(n_bits: int = 256, seed: int = 1234) -> np.ndarray:
    """Fixed Gaussian BRIEF sampling pattern: (n_bits, 2, 2) offsets."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(n_bits, 2, 2) * (PATCH / 5.0)
    return np.clip(np.round(pts), -PATCH_R + 1, PATCH_R - 1).astype(np.float32)


_PATTERN = _brief_pattern()

_yy, _xx = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1]
_CIRC_MASK = ((_xx**2 + _yy**2) <= PATCH_R**2 + 1).astype(np.float32)
_MOM_X = (_xx * _CIRC_MASK).astype(np.float32)
_MOM_Y = (_yy * _CIRC_MASK).astype(np.float32)


def level_shapes(cfg: EngineConfig) -> list[tuple[int, int]]:
    """(H, W) per pyramid level."""
    shapes = []
    for l in range(cfg.n_levels):
        s = cfg.scale_factor**l
        shapes.append((max(int(round(cfg.height / s)), 2 * BORDER + 8),
                       max(int(round(cfg.width / s)), 2 * BORDER + 8)))
    return shapes


def features_per_level(cfg: EngineConfig) -> list[int]:
    """Geometric split of n_features over levels (reference: ORBextractor ctor)."""
    inv = 1.0 / cfg.scale_factor
    total = (1 - inv) / (1 - inv**cfg.n_levels)
    counts = [int(round(cfg.n_features * total * inv**l)) for l in range(cfg.n_levels - 1)]
    counts.append(max(cfg.n_features - sum(counts), 1))
    return counts


# ---------------------------------------------------------------------------
# resize / blur operators (the reference's banded matrices)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_src: int, n_dst: int) -> np.ndarray:
    """[n_dst, n_src] antialiased triangle-filter resize operator."""
    scale = n_src / n_dst
    support = max(scale, 1.0)
    out = np.zeros((n_dst, n_src), np.float32)
    for i in range(n_dst):
        pos = (i + 0.5) * scale - 0.5
        j0 = int(math.floor(pos - support)) - 1
        for j in range(j0, j0 + int(2 * support) + 3):
            w = max(0.0, 1.0 - abs(j - pos) / support)
            if w > 0.0:
                out[i, min(max(j, 0), n_src - 1)] += w
        out[i] /= out[i].sum()
    return out


@functools.lru_cache(maxsize=None)
def _blur_matrix(n: int, sigma: float = 2.0, radius: int = 3) -> np.ndarray:
    """[n, n] banded Gaussian blur operator with edge clamping."""
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    out = np.zeros((n, n), np.float32)
    for off, w in zip(range(-radius, radius + 1), k):
        idx = np.clip(np.arange(n) + off, 0, n - 1)
        out[np.arange(n), idx] += w
    return out


@functools.lru_cache(maxsize=None)
def _operator(kind: str, args: tuple, device: str) -> torch.Tensor:
    mat = _resize_matrix(*args) if kind == "resize" else _blur_matrix(*args)
    return torch.from_numpy(mat).to(device)


def _apply_separable(my: torch.Tensor, img: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """my @ img @ mx^T for f32[H, W], and image by image for a stack
    f32[B, H, W]. A stack's two products stay per image because a float
    product's rounding follows the shapes the library is given: on an H100
    neither a broadcast, a batched nor a folded product of the stack gave
    every level the bits of the one-image product, which is what an
    image's features are defined by. Everything downstream of the operators
    takes the stack whole."""
    if img.dim() == 2:
        return my @ img @ mx.T
    return torch.stack([my @ im @ mx.T for im in img])


def resize_bilinear(img: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Separable triangle-filter resize: ry @ img @ rx^T, of f32[H, W] or of
    every image of f32[B, H, W]."""
    ry = _operator("resize", (img.shape[-2], shape[0]), str(img.device))
    rx = _operator("resize", (img.shape[-1], shape[1]), str(img.device))
    return _apply_separable(ry, img, rx)


def build_pyramid(img: torch.Tensor, cfg: EngineConfig) -> list[torch.Tensor]:
    """f32[H, W] (or a stack f32[B, H, W]) -> list of per-level images."""
    levels = [img]
    shapes = level_shapes(cfg)
    for l in range(1, cfg.n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]))
    return levels


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur (the reference blurs before descriptor sampling)
    of f32[H, W], or of every image of f32[B, H, W]."""
    by = _operator("blur", (img.shape[-2], sigma, radius), str(img.device))
    bx = _operator("blur", (img.shape[-1], sigma, radius), str(img.device))
    return _apply_separable(by, img, bx)


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------


CELL = 16   # side of the detector's uniformity cells, pixels


def detect_level(img_l: torch.Tensor, n_take: int, th_fast: float, min_th_fast: float, cell: int = CELL):
    """Up to n_take FAST keypoints on one level with spatial uniformity.

    Returns (uv f32[n_take, 2] level coords, score f32[n_take], valid bool).
    """
    padded = fast_nms_rank_levels([img_l], float(min_th_fast), float(th_fast), BORDER, pad_to=cell)[0]
    return select_keypoints(padded, n_take, cell)


def select_keypoints(padded: torch.Tensor, n_take: int, cell: int = CELL):
    """The n_take best of a level's per-cell best ranks. ``padded`` is the
    level's rank map, zero-padded to whole cells (kernel A writes it so), or
    a stack [B, Hp, Wp] of them: then every output has a leading B."""
    lead = padded.shape[:-2]
    Hc, Wc = padded.shape[-2] // cell, padded.shape[-1] // cell
    cells = padded.reshape(lead + (Hc, cell, Wc, cell)).transpose(-3, -2).reshape(lead + (Hc * Wc, cell * cell))
    k = max(1, min(cell * cell, -(-2 * n_take // (Hc * Wc))))
    topv, topi = ops.top_k(cells, k)
    cidx = torch.arange(Hc * Wc, device=padded.device)[:, None]
    py = ((cidx // Wc) * cell + topi // cell).reshape(lead + (-1,))
    px = ((cidx % Wc) * cell + topi % cell).reshape(lead + (-1,))
    gv, gi = ops.top_k(topv.reshape(lead + (-1,)), n_take)
    uv = torch.stack([torch.gather(px, -1, gi), torch.gather(py, -1, gi)], dim=-1).to(torch.float32)
    valid = gv > 0.0
    score = torch.where(gv > 1000.0, gv - 1000.0, gv)
    return uv, score, valid


# ---------------------------------------------------------------------------
# patches / orientation / descriptors
# ---------------------------------------------------------------------------


def _gather_patches(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """31x31 patches at integer keypoints, clamped inside the image:
    [N, 31, 31] from f32[H, W] and uv [N, 2], [B, N, 31, 31] from stacks."""
    H, W = img.shape[-2:]
    y0 = torch.clamp(uv[..., 1].to(torch.int64) - PATCH_R, 0, H - PATCH)
    x0 = torch.clamp(uv[..., 0].to(torch.int64) - PATCH_R, 0, W - PATCH)
    off = torch.arange(PATCH, device=img.device)
    rows = (y0[..., None] + off)[..., :, None]
    cols = (x0[..., None] + off)[..., None, :]
    if img.dim() == 2:
        return img[rows, cols]
    b = torch.arange(img.shape[0], device=img.device)[:, None, None, None]
    return img[b, rows, cols]


def _gather_patches2(img_a: torch.Tensor, img_b: torch.Tensor, uv: torch.Tensor):
    """Patches from two same-shape images at shared keypoints."""
    return _gather_patches(img_a, uv), _gather_patches(img_b, uv)


@functools.lru_cache(maxsize=None)
def _moment_tables(device: str):
    return torch.from_numpy(_MOM_X).to(device), torch.from_numpy(_MOM_Y).to(device)


def compute_orientation(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per patch (reference: IC_Angle)."""
    mx, my = _moment_tables(str(patches.device))
    m10 = torch.einsum("nij,ij->n", patches, mx)
    m01 = torch.einsum("nij,ij->n", patches, my)
    return torch.atan2(m01, m10)


def _rotated_pattern_indices() -> tuple[np.ndarray, np.ndarray]:
    """Flat patch indices (i0, i1) [N_ANGLE_BINS, 256] of each rotated pair."""
    x = _PATTERN[..., 0]
    y = _PATTERN[..., 1]
    i0 = np.zeros((N_ANGLE_BINS, 256), np.int64)
    i1 = np.zeros((N_ANGLE_BINS, 256), np.int64)
    for b in range(N_ANGLE_BINS):
        a = 2.0 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(a), np.sin(a)
        xi = np.clip(np.round(x * c - y * s) + PATCH_R, 0, PATCH - 1).astype(int)
        yi = np.clip(np.round(x * s + y * c) + PATCH_R, 0, PATCH - 1).astype(int)
        flat = yi * PATCH + xi
        i0[b], i1[b] = flat[:, 0], flat[:, 1]
    return i0, i1


@functools.lru_cache(maxsize=None)
def _desc_compare_matrix() -> np.ndarray:
    """[(N_ANGLE_BINS * 256), 961] {-1,0,+1} comparison operator (reference form)."""
    D = np.zeros((N_ANGLE_BINS * 256, PATCH * PATCH), np.float32)
    i0, i1 = _rotated_pattern_indices()
    for b in range(N_ANGLE_BINS):
        rows = b * 256 + np.arange(256)
        np.add.at(D, (rows, i1[b]), 1.0)
        np.add.at(D, (rows, i0[b]), -1.0)
    return D


@functools.lru_cache(maxsize=None)
def _pattern_tables(device: str):
    i0, i1 = _rotated_pattern_indices()
    return torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[N, 256] -> 8 little-endian 32-bit words per row, as int32 bit-casts."""
    N = bits.shape[0]
    w = bits.reshape(N, 8, 32).to(torch.int64) << torch.arange(32, device=bits.device)
    w = w.sum(-1)
    w = w - ((w >> 31) & 1) * (1 << 32)
    return w.to(torch.int32)


def compute_descriptors(patches_blur: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF descriptors from blurred patches: i32[N, 8].

    Bit s of a keypoint in angle bin b is (p[i1[b, s]] - p[i0[b, s]] > 0) on
    the bf16-rounded blurred patch p -- exactly the reference's bf16 operands
    with f32 accumulation.
    """
    N = patches_blur.shape[0]
    flat = patches_blur.reshape(N, PATCH * PATCH).to(torch.bfloat16).to(torch.float32)
    bin_f = angle * (N_ANGLE_BINS / (2.0 * np.pi))
    bins = torch.remainder(torch.round(bin_f).to(torch.int64), N_ANGLE_BINS)
    i0, i1 = _pattern_tables(str(patches_blur.device))
    s = torch.gather(flat, 1, i1[bins]) - torch.gather(flat, 1, i0[bins])
    return pack_bits(s > 0.0)


def extract_features(img: torch.Tensor, cfg: EngineConfig) -> FrameArrays:
    """Full frontend: f32[H, W] grayscale in [0, 255] -> FrameArrays.

    Keypoint uv is in level-0 pixel coordinates, octave the pyramid level,
    desc the packed 256-bit descriptor.
    """
    if tuple(img.shape) != (cfg.height, cfg.width):
        raise ValueError(
            f"image shape {tuple(img.shape)} does not match config ({cfg.height}, {cfg.width})"
        )
    with span("slam::frontend"):
        return _extract_one(img, cfg)


def extract_features_batch(imgs: torch.Tensor, cfg: EngineConfig) -> FrameArrays:
    """Batched frontend: f32[B, H, W] -> FrameArrays with a leading B on
    every leaf; image b's features equal ``extract_features(imgs[b])``.

    Kernel A runs once for all B x levels rank maps, and the per-cell
    selection, the patch gathers and the descriptors once per level or once
    in all over the B x N keypoints. The float matrix products (the resize
    and blur operators, the orientation moments) stay one image at a time
    (``_apply_separable``).
    """
    if imgs.dim() != 3 or tuple(imgs.shape[1:]) != (cfg.height, cfg.width):
        raise ValueError(
            f"image batch shape {tuple(imgs.shape)} does not match config ({cfg.height}, {cfg.width})"
        )
    with span("slam::frontend"):
        return _extract(imgs, cfg)


def _extract_one(img: torch.Tensor, cfg: EngineConfig) -> FrameArrays:
    return _extract(img, cfg)


def _extract(img: torch.Tensor, cfg: EngineConfig) -> FrameArrays:
    """The frontend on one image f32[H, W] or on a stack f32[B, H, W]."""
    img = img.to(torch.float32).contiguous()
    dev = img.device
    lead = img.shape[:-2]
    pyr = build_pyramid(img, cfg)
    counts = features_per_level(cfg)
    # kernel A: every level's rank map in one launch, each in its cell-aligned buffer
    rank_levels = fast_nms_rank_levels_batch if lead else fast_nms_rank_levels
    ranks = rank_levels(pyr, float(cfg.min_th_fast), float(cfg.ini_th_fast), BORDER, pad_to=CELL)
    all_uv, all_score, all_valid, all_oct, all_praw, all_pblur = [], [], [], [], [], []
    for l in range(cfg.n_levels):
        img_l = pyr[l]
        uv, score, valid = select_keypoints(ranks[l], counts[l])
        praw, pblur = _gather_patches2(img_l, gaussian_blur(img_l), uv)
        all_uv.append(uv * ops.scalar(cfg.scale_factor**l, torch.float32, dev))
        all_score.append(score)
        all_valid.append(valid)
        all_oct.append(torch.full(score.shape, l, dtype=torch.int32, device=dev))
        all_praw.append(praw)
        all_pblur.append(pblur)

    uv = torch.cat(all_uv, dim=-2)
    score = torch.cat(all_score, dim=-1)
    valid = torch.cat(all_valid, dim=-1)
    octv = torch.cat(all_oct, dim=-1)
    n = score.shape[-1]
    # orientation over all levels at once, image by image: its two sums over
    # the patch are matrix products, whose rounding follows the number of
    # rows, so a stack's moments would not be each image's own to the bit
    praw = torch.cat(all_praw, dim=-3)
    ang = torch.stack([compute_orientation(p) for p in praw]) if lead else compute_orientation(praw)
    # descriptors over all keypoints (of all images) at once: gathers and compares
    desc = compute_descriptors(torch.cat(all_pblur, dim=-3).reshape(-1, PATCH, PATCH), ang.reshape(-1))
    desc = desc.reshape(lead + (n, 8))

    F = cfg.max_features
    if n < F:
        pad = F - n
        uv = torch.cat([uv, uv.new_zeros(lead + (pad, 2))], dim=-2)
        score = torch.cat([score, score.new_zeros(lead + (pad,))], dim=-1)
        valid = torch.cat([valid, valid.new_zeros(lead + (pad,))], dim=-1)
        octv = torch.cat([octv, octv.new_zeros(lead + (pad,))], dim=-1)
        ang = torch.cat([ang, ang.new_zeros(lead + (pad,))], dim=-1)
        desc = torch.cat([desc, desc.new_zeros(lead + (pad, 8))], dim=-2)
    elif n > F:
        _, keep = ops.top_k(torch.where(valid, score, -1.0), F)

        def pick(x):
            idx = keep.reshape(keep.shape + (1,) * (x.dim() - keep.dim())).expand(keep.shape + x.shape[keep.dim():])
            return torch.gather(x, len(lead), idx)

        uv, score, valid = pick(uv), pick(score), pick(valid)
        octv, ang, desc = pick(octv), pick(ang), pick(desc)

    return FrameArrays(
        uv=uv,
        uv_raw=uv,
        response=score,
        octave=octv,
        angle=ang,
        desc=desc,
        valid=valid,
        u_right=-torch.ones(lead + (F,), dtype=torch.float32, device=dev),
        depth=-torch.ones(lead + (F,), dtype=torch.float32, device=dev),
    )
