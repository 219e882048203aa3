"""Stereo and RGB-D frame construction (port of ``dialog_tpu/stereo.py``).

Reference: ``Frame::ComputeStereoMatches`` / ``ComputeStereoFromRGBD``. A left
feature's right-image match is the mutual-best descriptor match inside a
row band, a disparity range and an octave band (one gated [F, F] Hamming
matrix, the plain ``matching.hamming_distance_matrix`` as in the
reference), refined to sub-pixel by the SAD of 11x11 patches slid +-5 px
along the row and a parabola through the best three offsets.
"""

from __future__ import annotations

import torch

from . import matching
from .config import EngineConfig
from .containers import FrameArrays
from .instrument import span

SAD_W = 5       # half patch for SAD refinement (11x11, as the reference)
SAD_L = 5       # search slide +-5 px


def _sad_refine(img_l: torch.Tensor, img_r: torch.Tensor, uv_l: torch.Tensor, uR0: torch.Tensor,
                ok: torch.Tensor):
    """Sub-pixel right-x by SAD of 11x11 patches slid +-5 px on the row.

    Patches are plain gathers at the rounded keypoint, their windows clamped
    into the image as the reference clamps them. Returns (uR f32[N], ok
    bool[N]); a best offset at either end of the slide fails ``ok``. With a
    leading B on every argument (images [B, H, W]), on both results too."""
    with span("slam::sad_refine"):
        H, W = img_l.shape[-2:]
        P = 2 * SAD_W + 1
        WIDE = P + 2 * SAD_L
        dev = img_l.device
        xl = torch.round(uv_l[..., 0]).to(torch.int64)
        yl = torch.round(uv_l[..., 1]).to(torch.int64)
        xr = torch.round(uR0).to(torch.int64)
        rows = torch.clamp(yl - SAD_W, 0, H - P)[..., None] + torch.arange(P, device=dev)        # [N, P]
        cols_l = torch.clamp(xl - SAD_W, 0, W - P)[..., None] + torch.arange(P, device=dev)      # [N, P]
        cols_r = torch.clamp(xr - SAD_W - SAD_L, 0, W - WIDE)[..., None] + torch.arange(WIDE, device=dev)
        if img_l.dim() == 2:
            at = (rows[..., :, None],)
        else:
            at = (torch.arange(img_l.shape[0], device=dev)[:, None, None, None], rows[..., :, None])
        patch_l = img_l[at + (cols_l[..., None, :],)]                                            # [N, P, P]
        strip_r = img_r[at + (cols_r[..., None, :],)]                                            # [N, P, WIDE]
        windows = strip_r.unfold(-1, P, 1)                                                       # [N, P, 2L+1, P]
        sads = torch.abs(patch_l[..., :, None, :] - windows).sum(dim=(-3, -1))                  # [N, 2L+1]
        best = torch.argmin(sads, dim=-1)
        at_edge = (best == 0) | (best == 2 * SAD_L)
        b = torch.clamp(best, 1, 2 * SAD_L - 1)
        s_m = torch.gather(sads, -1, (b - 1)[..., None])[..., 0]
        s_0 = torch.gather(sads, -1, b[..., None])[..., 0]
        s_p = torch.gather(sads, -1, (b + 1)[..., None])[..., 0]
        denom = torch.clamp(s_m + s_p - 2.0 * s_0, min=1e-6)
        delta = torch.clamp(0.5 * (s_m - s_p) / denom, -1.0, 1.0)
        uR = xr.to(torch.float32) + (b - SAD_L).to(torch.float32) + delta
        return uR, ok & ~at_edge


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d f32 tensor: ``_f32(c) / t`` is a true f32 division,
    where torch computes ``c / t`` for a Python ``c`` as ``c * (1 / t)``."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def stereo_match_frames(left: FrameArrays, right: FrameArrays, cfg: EngineConfig,
                        img_left: torch.Tensor | None = None, img_right: torch.Tensor | None = None) -> FrameArrays:
    """Fill the left frame's u_right/depth from a right-image feature frame.

    Gates: octaves at most one apart, |row difference| <= 2 x the left
    feature's scale, disparity in (0.1, bf/baseline). With both images the
    matched right-x is refined to sub-pixel by row SAD. With a leading B on
    every leaf of both frames (and images [B, H, W]) it matches B pairs at once."""
    with span("slam::stereo_match"):
        # max disparity bf / minZ with minZ = baseline, in f32 as the reference
        max_disp = _f32(cfg.bf, left.uv) / torch.clamp(_f32(cfg.baseline, left.uv), min=1e-6)
        dist = matching.hamming_distance_matrix(left.desc, right.desc)
        scale_l = torch.pow(_f32(cfg.scale_factor, left.uv), left.octave.to(torch.float32))
        row_ok = torch.abs(left.uv[..., :, None, 1] - right.uv[..., None, :, 1]) <= 2.0 * scale_l[..., :, None]
        disp = left.uv[..., :, None, 0] - right.uv[..., None, :, 0]
        disp_ok = (disp > 0.1) & (disp < max_disp)
        oct_ok = torch.abs(left.octave[..., :, None] - right.octave[..., None, :]) <= 1
        gated = torch.where(row_ok & disp_ok & oct_ok, dist, matching.MAX_DIST)
        match_r, _ = matching.match_mutual(gated, left.valid, right.valid, max_dist=cfg.th_high, ratio=1.0)
        ok = match_r >= 0
        uR = torch.gather(right.uv[..., 0], -1, torch.clamp(match_r, 0, right.uv.shape[-2] - 1).long())
        if img_left is not None and img_right is not None:
            uR, ok = _sad_refine(img_left, img_right, left.uv_raw, uR, ok)
        d = left.uv[..., 0] - uR
        ok = ok & (d > 0.1) & (d < max_disp)
        depth = torch.where(ok, _f32(cfg.bf, d) / torch.clamp(d, min=0.1), -1.0)
        return left._replace(u_right=torch.where(ok, uR, -1.0), depth=depth)


def extract_and_match_stereo_batch(imgs_l: torch.Tensor, imgs_r: torch.Tensor, cfg: EngineConfig) -> FrameArrays:
    """Stereo frontend of B pairs: the 2B images go through the batched
    frontend as one stack (kernel A once), then all B pairs are row-matched
    and SAD-refined at once. f32[B, H, W] x 2 -> left FrameArrays with a
    leading B and ``u_right``/``depth`` filled."""
    from .frontend import extract_features_batch

    B = imgs_l.shape[0]
    feats = extract_features_batch(torch.cat([imgs_l, imgs_r], dim=0), cfg)
    fl = FrameArrays(*[x[:B] for x in feats])
    fr = FrameArrays(*[x[B:] for x in feats])
    return stereo_match_frames(fl, fr, cfg, img_left=imgs_l.to(torch.float32), img_right=imgs_r.to(torch.float32))


def depth_from_rgbd(frame: FrameArrays, depth_img: torch.Tensor, cfg: EngineConfig) -> FrameArrays:
    """Sample the depth map at the raw keypoints (truncated to integer pixels,
    as the reference's ``astype(int32)``); fake right-x uR = u - bf/z."""
    u = torch.clamp(frame.uv_raw[:, 0].to(torch.int32), 0, cfg.width - 1).long()
    v = torch.clamp(frame.uv_raw[:, 1].to(torch.int32), 0, cfg.height - 1).long()
    # the reference's compiled division by the constant factor is a product
    # with its f32 reciprocal; bf / z is a true division in both
    z = depth_img[v, u] * (1.0 / cfg.depth_map_factor)
    ok = frame.valid & (z > 0.05)
    uR = frame.uv[:, 0] - _f32(cfg.bf, z) / torch.clamp(z, min=0.05)
    uR = torch.where(ok, uR, -1.0) if cfg.bf > 0 else torch.full_like(uR, -1.0)
    return frame._replace(depth=torch.where(ok, z, -1.0), u_right=uR)
