"""Plain reference of the ORB frontend and of stereo matching.

The function that kernel A and the frontend around it compute, written out
from its definition: an 8-level pyramid by separable triangle-filter resize
operators, FAST-9 scores with 3x3 non-maximum suppression and a two-tier rank
(score, or score + 1000 above the initial threshold), the best ranks per
16-pixel cell and then per level, the intensity-centroid angle on a 31x31
patch, and 256-bit steered BRIEF on the blurred patch (each sample rounded to
bfloat16; 30 angle bins; the Gaussian pattern of ``RandomState(1234)``).
Stereo: the mutual-best Hamming match in a row band, disparity range and
octave band, refined by the SAD of 11x11 patches slid +-5 px and a parabola.

Keypoints come out as integer level coordinates, so that a comparison does
not depend on how either side scales them to level 0.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import dtype, mm

PATCH_R = 15
PATCH = 2 * PATCH_R + 1
BORDER = PATCH_R + 4
N_ANGLE_BINS = 30
CELL = 16
CIRCLE = [(3, 0), (3, 1), (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1),
          (-3, 0), (-3, -1), (-2, -2), (-1, -3), (0, -3), (1, -3), (2, -2), (3, -1)]
SAD_W = 5
SAD_L = 5
MAX_DIST = 257


class Features(NamedTuple):
    """Valid keypoints of one image, in selection order."""

    xy: np.ndarray       # i64[N, 2] level coordinates
    octave: np.ndarray   # i64[N]
    desc: np.ndarray     # u8[N, 32]  descriptor bytes (little-endian words)
    uv: torch.Tensor     # f32[N, 2] level-0 coordinates: level xy x float32(scale ** level), as the program states them
    angle: torch.Tensor  # [N]


def level_shapes(cam: dict) -> list[tuple[int, int]]:
    out = []
    for lvl in range(cam["n_levels"]):
        s = cam["scale_factor"] ** lvl
        out.append((max(int(round(cam["height"] / s)), 2 * BORDER + 8), max(int(round(cam["width"] / s)), 2 * BORDER + 8)))
    return out


def features_per_level(cam: dict) -> list[int]:
    inv = 1.0 / cam["scale_factor"]
    n = cam["n_levels"]
    total = (1 - inv) / (1 - inv**n)
    counts = [int(round(cam["n_features"] * total * inv**lvl)) for lvl in range(n - 1)]
    counts.append(max(cam["n_features"] - sum(counts), 1))
    return counts


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_src: int, n_dst: int) -> np.ndarray:
    scale = n_src / n_dst
    support = max(scale, 1.0)
    out = np.zeros((n_dst, n_src), np.float64)
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
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    out = np.zeros((n, n), np.float64)
    for off, w in zip(range(-radius, radius + 1), k):
        out[np.arange(n), np.clip(np.arange(n) + off, 0, n - 1)] += w
    return out


def _separable(img, my: np.ndarray, mx: np.ndarray, mode: str):
    dev = img.device
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return mm(mm(t(my), img, mode), t(mx).T, mode)


def _brief_pattern() -> np.ndarray:
    rng = np.random.RandomState(1234)
    pts = rng.randn(256, 2, 2) * (PATCH / 5.0)
    return np.clip(np.round(pts), -PATCH_R + 1, PATCH_R - 1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pattern_tables() -> tuple[np.ndarray, np.ndarray]:
    pat = _brief_pattern()
    x, y = pat[..., 0], pat[..., 1]
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
def _moments() -> tuple[np.ndarray, np.ndarray]:
    yy, xx = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1]
    circ = ((xx**2 + yy**2) <= PATCH_R**2 + 1).astype(np.float64)
    return xx * circ, yy * circ


def fast_rank(img: torch.Tensor, min_th: float, th_fast: float) -> torch.Tensor:
    """FAST-9 score (replicate-padded), 3x3 NMS, border mask and two-tier rank of one level."""
    H, W = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    neigh = torch.stack([p[3 + dy : 3 + dy + H, 3 + dx : 3 + dx + W] for dx, dy in CIRCLE])
    diff = neigh - img[None]

    def run9_min(d):
        m2 = torch.minimum(d, torch.roll(d, -1, 0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, 0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, 0))
        return torch.amax(torch.minimum(m8, torch.roll(d, -8, 0)), 0)

    score = torch.maximum(run9_min(diff), run9_min(-diff))
    mx = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    s = torch.where(score >= mx, score, 0.0)
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    s = torch.where((ys >= BORDER) & (ys < H - BORDER) & (xs >= BORDER) & (xs < W - BORDER), s, 0.0)
    return torch.where(s > min_th, s + torch.where(s > th_fast, 1000.0, 0.0), 0.0)


def select(rank: torch.Tensor, n_take: int):
    """The n_take best of the per-cell best ranks (ties to the lower index): (x, y, valid)."""
    H, W = rank.shape
    Hp, Wp = -(-H // CELL) * CELL, -(-W // CELL) * CELL
    padded = F.pad(rank, (0, Wp - W, 0, Hp - H))
    Hc, Wc = Hp // CELL, Wp // CELL
    cells = padded.reshape(Hc, CELL, Wc, CELL).transpose(1, 2).reshape(Hc * Wc, CELL * CELL)
    k = max(1, min(CELL * CELL, -(-2 * n_take // (Hc * Wc))))
    topv, topi = [a[:, :k] for a in torch.sort(cells, dim=-1, descending=True, stable=True)]
    cidx = torch.arange(Hc * Wc, device=rank.device)[:, None]
    py = ((cidx // Wc) * CELL + topi // CELL).reshape(-1)
    px = ((cidx % Wc) * CELL + topi % CELL).reshape(-1)
    gv, gi = [a[:n_take] for a in torch.sort(topv.reshape(-1), descending=True, stable=True)]
    return px[gi], py[gi], gv > 0.0


def extract(img: torch.Tensor, cam: dict, mode: str = "f64") -> Features:
    """The frontend on one image f32[H, W] (values 0-255)."""
    dt = dtype(mode)
    dev = img.device
    shapes = level_shapes(cam)
    counts = features_per_level(cam)
    lvl_img = img.to(dt)
    i0, i1 = (torch.from_numpy(a).to(dev) for a in _pattern_tables())
    mom_x, mom_y = (torch.from_numpy(a).to(dev) for a in _moments())
    xy, octv, desc, uv, ang = [], [], [], [], []
    off = torch.arange(PATCH, device=dev)
    for lvl in range(cam["n_levels"]):
        if lvl:
            H0, W0 = lvl_img.shape
            lvl_img = _separable(lvl_img, _resize_matrix(H0, shapes[lvl][0]), _resize_matrix(W0, shapes[lvl][1]), mode)
        H, W = lvl_img.shape
        px, py, ok = select(fast_rank(lvl_img, float(cam["min_th_fast"]), float(cam["ini_th_fast"])), counts[lvl])
        px, py = px[ok], py[ok]
        y0 = torch.clamp(py - PATCH_R, 0, H - PATCH)
        x0 = torch.clamp(px - PATCH_R, 0, W - PATCH)
        rows = (y0[:, None] + off)[:, :, None]
        cols = (x0[:, None] + off)[:, None, :]
        raw = lvl_img[rows, cols]
        blurred = _separable(lvl_img, _blur_matrix(H), _blur_matrix(W), mode)[rows, cols]
        a = torch.atan2(torch.einsum("nij,ij->n", raw, mom_y.to(dt)), torch.einsum("nij,ij->n", raw, mom_x.to(dt)))
        flat = blurred.reshape(-1, PATCH * PATCH).to(torch.float32).to(torch.bfloat16).to(torch.float32)
        bins = torch.remainder(torch.round(a * (N_ANGLE_BINS / (2.0 * np.pi))).to(torch.int64), N_ANGLE_BINS)
        bits = (torch.gather(flat, 1, i1[bins]) - torch.gather(flat, 1, i0[bins])) > 0.0
        xy.append(torch.stack([px, py], -1))
        octv.append(torch.full(px.shape, lvl, dtype=torch.int64, device=dev))
        desc.append(bits)
        uv.append(torch.stack([px, py], -1).to(torch.float32)
                  * torch.tensor(cam["scale_factor"] ** lvl, dtype=torch.float32, device=dev))
        ang.append(a)
    bits = torch.cat(desc).cpu().numpy()
    return Features(xy=torch.cat(xy).cpu().numpy(), octave=torch.cat(octv).cpu().numpy(),
                    desc=np.packbits(bits, axis=1, bitorder="little"), uv=torch.cat(uv), angle=torch.cat(ang))


def _hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """u8[N, 32] x u8[M, 32] -> i64[N, M] Hamming distances (exact)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.int64)
    bits_a = np.unpackbits(a, axis=1).astype(np.float64)
    bits_b = np.unpackbits(b, axis=1).astype(np.float64)
    return np.rint(bits_a.sum(1)[:, None] + bits_b.sum(1)[None, :] - 2.0 * bits_a @ bits_b.T).astype(np.int64)


def mutual_best(dist: np.ndarray, max_dist: int, ratio: float) -> np.ndarray:
    """Mutual-nearest match with a Lowe ratio on the row side (ties to the lower index): i64[N], -1 = none."""
    N, M = dist.shape
    if M == 0:
        return np.full(N, -1, np.int64)
    best = np.argmin(dist, axis=1)
    best_d = dist[np.arange(N), best]
    d2 = dist.copy()
    d2[np.arange(N), best] = MAX_DIST
    second = d2.min(axis=1)
    back = np.argmin(dist, axis=0)
    ok = (best_d <= max_dist) & (best_d.astype(np.float64) < ratio * second) & (back[best] == np.arange(N))
    return np.where(ok, best, -1)


def stereo_right_x(left: Features, right: Features, img_l: torch.Tensor, img_r: torch.Tensor, cam: dict,
                   mode: str = "f64") -> np.ndarray:
    """Each left keypoint's refined right-image x, -1 where it has none: f64[N]."""
    dt = dtype(mode)
    dev = img_l.device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    # the gates are decisions on float32 coordinates, evaluated as the program states them
    max_disp32 = f32(cam["bf"]) / torch.clamp(f32(cam["bf"] / cam["fx"]), min=1e-6)
    uvl32, uvr32 = left.uv, right.uv
    oct_l = torch.from_numpy(left.octave).to(dev)
    oct_r = torch.from_numpy(right.octave).to(dev)
    scale_l = torch.pow(f32(cam["scale_factor"]), oct_l.to(torch.float32))
    row_ok = torch.abs(uvl32[:, None, 1] - uvr32[None, :, 1]) <= 2.0 * scale_l[:, None]
    disp = uvl32[:, None, 0] - uvr32[None, :, 0]
    oct_ok = torch.abs(oct_l[:, None] - oct_r[None, :]) <= 1
    gate = (row_ok & (disp > 0.1) & (disp < max_disp32) & oct_ok).cpu().numpy()
    dist = np.where(gate, _hamming(left.desc, right.desc), MAX_DIST)
    max_disp = float(max_disp32)
    uvl, uvr = uvl32.double().cpu().numpy(), uvr32.double().cpu().numpy()
    match = mutual_best(dist, cam["th_high"], 1.0)
    ok = match >= 0
    out = np.full(len(match), -1.0)
    if not ok.any():
        return out
    H, W = img_l.shape
    P, WIDE = 2 * SAD_W + 1, 2 * SAD_W + 1 + 2 * SAD_L
    il, ir = img_l.to(dt), img_r.to(dt)
    if mode == "tf32":
        from .precision import to_tf32

        il, ir = to_tf32(il), to_tf32(ir)
    idx = np.nonzero(ok)[0]
    xl = np.rint(uvl[idx, 0]).astype(np.int64)
    yl = np.rint(uvl[idx, 1]).astype(np.int64)
    xr = np.rint(uvr[match[idx], 0]).astype(np.int64)
    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
    rows = torch.from_numpy(np.clip(yl - SAD_W, 0, H - P)).to(dev)[:, None] + ar(P)
    cols_l = torch.from_numpy(np.clip(xl - SAD_W, 0, W - P)).to(dev)[:, None] + ar(P)
    cols_r = torch.from_numpy(np.clip(xr - SAD_W - SAD_L, 0, W - WIDE)).to(dev)[:, None] + ar(WIDE)
    patch_l = il[rows[:, :, None], cols_l[:, None, :]]
    strip_r = ir[rows[:, :, None], cols_r[:, None, :]]
    sads = torch.abs(patch_l[:, :, None, :] - strip_r.unfold(-1, P, 1)).sum(dim=(-3, -1)).cpu().numpy()
    best = np.argmin(sads, axis=-1)
    edge = (best == 0) | (best == 2 * SAD_L)
    b = np.clip(best, 1, 2 * SAD_L - 1)
    s_m, s_0, s_p = (sads[np.arange(len(b)), b + k] for k in (-1, 0, 1))
    delta = np.clip(0.5 * (s_m - s_p) / np.maximum(s_m + s_p - 2.0 * s_0, 1e-6), -1.0, 1.0)
    uR = xr + (b - SAD_L) + delta
    d = uvl[idx, 0] - uR
    good = ~edge & (d > 0.1) & (d < max_disp)
    out[idx[good]] = uR[good]
    return out
