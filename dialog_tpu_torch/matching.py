"""Descriptor matching policies (port of ``dialog_tpu/matching.py``).

256-bit Hamming matching with distance thresholds, Lowe ratio, mutual-best
checks, the rotation-consistency histogram and the projection/window-gated
search. Dense policies build an [N, M] distance matrix with masks doing the
gating; ``match_projected`` always goes through kernel B
(``kernels.hamming.mutual_match_fused``), which gives the same answer as
``match_mutual`` on the dense gated matrix without materializing it (on the
card in one pass over the gated pairs).
"""

from __future__ import annotations

import math

import torch

from . import ops
from .kernels.hamming import gate_d2, hamming_distance_matrix, mutual_match_fused

HIST_BINS = 30       # rotation histogram (reference: HISTO_LENGTH)
MAX_DIST = 257       # sentinel > any 256-bit Hamming distance


def rotation_consistency_mask(angle_a, angle_b, match_b, ok):
    """Keep matches whose angle difference falls in the top-3 histogram bins."""
    two_pi = 2.0 * math.pi
    safe = torch.clamp(match_b, 0, angle_b.shape[0] - 1).long()
    rot = torch.remainder(angle_a - angle_b[safe], two_pi)
    bin_ = torch.clamp((rot * HIST_BINS / two_pi).to(torch.int32), 0, HIST_BINS - 1)
    hist = ops.scatter_add(
        torch.zeros((HIST_BINS,), dtype=torch.int32, device=ok.device),
        torch.where(ok, bin_, 0),
        ok.to(torch.int32),
    )
    top3 = ops.top_k(hist, 3)[0]
    thresh = torch.maximum(top3[2], (top3[0] // 10) + 1)
    keep_bin = hist >= thresh
    return ok & keep_bin[bin_.long()]


def match_mutual(dist, valid_a, valid_b, max_dist: int = 50, ratio: float = 1.0):
    """Mutual-nearest match with an optional Lowe ratio on the query side.

    dist: i32[N, M]. Returns (match_b i32[N] (-1 = none), best_dist i32[N]).
    With leading batch dimensions on every argument, on every result too.
    """
    d = torch.where(valid_a[..., :, None] & valid_b[..., None, :], dist, MAX_DIST)
    best = torch.argmin(d, dim=-1)
    best_d = d.min(dim=-1).values
    ar = torch.arange(d.shape[-2], device=d.device)
    second_d = d.scatter(-1, best[..., None], MAX_DIST).min(dim=-1).values
    best_for_b = torch.argmin(d, dim=-2)
    mutual = torch.gather(best_for_b, -1, best) == ar
    ok = (
        valid_a
        & (best_d <= max_dist)
        & (best_d.to(torch.float32) < ratio * second_d.to(torch.float32))
        & mutual
    )
    return torch.where(ok, best, -1).to(torch.int32), best_d.to(torch.int32)


def match_window(desc_a, uv_a, valid_a, desc_b, uv_b, valid_b, radius: float,
                 max_dist: int = 50, ratio: float = 0.9, angle_a=None, angle_b=None):
    """Window-gated mutual match (reference: SearchForInitialization)."""
    dist = hamming_distance_matrix(desc_a, desc_b)
    near = gate_d2(uv_a, uv_b) <= radius * radius
    dist = torch.where(near, dist, MAX_DIST)
    match_b, best_d = match_mutual(dist, valid_a, valid_b, max_dist, ratio)
    if angle_a is not None:
        ok = rotation_consistency_mask(angle_a, angle_b, match_b, match_b >= 0)
        match_b = torch.where(ok, match_b, -1)
    return match_b, best_d


def match_projected(lm_desc, lm_uv, lm_valid, lm_octave, ft_desc, ft_uv, ft_valid,
                    ft_octave, radius: float, scale_factor: float, max_dist: int = 100,
                    ratio: float = 0.9, octave_band: int = 1):
    """Projection-guided landmark->feature match (reference: SearchByProjection).

    The radius scales with the landmark's predicted octave and candidates must
    lie within ``octave_band`` levels. Returns (match_ft i32[L], best_dist i32[L]).
    """
    r = radius * torch.pow(
        ops.scalar(scale_factor, torch.float32, lm_uv.device),
        lm_octave.to(torch.float32),
    )
    return mutual_match_fused(
        lm_desc, ft_desc, lm_valid, ft_valid,
        uv_a=lm_uv, uv_b=ft_uv, radius2=r * r,
        oct_a=lm_octave, oct_b=ft_octave, octave_band=octave_band,
        max_dist=max_dist, ratio=ratio,
    )
