"""Kernel B: gated Hamming best/second-best matcher (CUDA: ``csrc/hamming.cu``).

Port of ``dialog_tpu/kernels/hamming.py``. ``hamming_best2`` returns, per row of
A, the best and second-best 256-bit Hamming distance over B under validity,
row- or column-radius and octave-band gates (ties to the lowest column), and
``mutual_match_fused`` reproduces ``matching.match_mutual`` on the gated
matrix with no [N, M] matrix in device memory: on the card in one pass over
the gated pairs (each open pair also lowers its column's packed
(distance, row) key, which answers the transposed question), on the CPU as
two calls of the plain version, by rows and transposed.
``hamming_best2_plain`` is the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from . import common

MAX_DIST = 257
ROW_BITS = 23   # bits of the row index in a column's packed (distance, row) key (csrc/hamming.cu)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of int32 bit patterns (SWAR on int64), as int32."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def gate_d2(uv_a: torch.Tensor, uv_b: torch.Tensor) -> torch.Tensor:
    """[N, M] squared pixel distance dx*dx + dy*dy, one rounding per op."""
    dx = uv_a[:, None, 0] - uv_b[None, :, 0]
    dy = uv_a[:, None, 1] - uv_b[None, :, 1]
    return dx * dx + dy * dy


def hamming_best2_plain(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, r2_rows,
                        r2_cols, oct_a, oct_b, band: int):
    N, M = desc_a.shape[0], desc_b.shape[0]
    if M == 0:   # no column: no match, both distances at the sentinel
        none = torch.full((N,), MAX_DIST, dtype=torch.int32, device=desc_a.device)
        return torch.full_like(none, -1), none, none.clone()
    d = popcount32(desc_a[:, None, :] ^ desc_b[None, :, :]).sum(-1, dtype=torch.int32)
    d2s = gate_d2(uv_a, uv_b)
    r2 = torch.where(r2_rows[:, None] >= 0, r2_rows[:, None], r2_cols[None, :])
    sp_ok = (r2 < 0) | (d2s <= r2)
    if band < 0:
        oct_ok = torch.ones_like(sp_ok)
    else:
        oct_ok = torch.abs(oct_a[:, None] - oct_b[None, :]) <= band
    ok = valid_a[:, None] & valid_b[None, :] & sp_ok & oct_ok
    d = torch.where(ok, d, MAX_DIST)
    best = d.min(dim=1).values
    bidx = torch.argmin(d, dim=1)
    d2 = d.clone()
    d2[torch.arange(N, device=d.device), bidx] = MAX_DIST
    second = d2.min(dim=1).values
    idx = torch.where(best >= MAX_DIST, -1, bidx).to(torch.int32)
    return idx, best.to(torch.int32), second.to(torch.int32)


def _defaults(desc_a, desc_b, uv_a, uv_b, radius2, radius2_cols, oct_a, oct_b):
    N, M = desc_a.shape[0], desc_b.shape[0]
    dev = desc_a.device
    if uv_a is None:
        uv_a = torch.zeros((N, 2), dtype=torch.float32, device=dev)
        uv_b = torch.zeros((M, 2), dtype=torch.float32, device=dev)
    if radius2 is None:
        radius2 = torch.full((N,), -1.0, dtype=torch.float32, device=dev)
    if radius2_cols is None:
        radius2_cols = torch.full((M,), -1.0, dtype=torch.float32, device=dev)
    if oct_a is None:
        oct_a = torch.zeros((N,), dtype=torch.int32, device=dev)
        oct_b = torch.zeros((M,), dtype=torch.int32, device=dev)
    return uv_a, uv_b, radius2, radius2_cols, oct_a, oct_b


def _checked(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, radius2, radius2_cols, oct_a, oct_b):
    """Raise on what the kernel does not take; returns the pointers of the ten
    arguments in the kernel's order (None for an absent gate)."""
    N, M = desc_a.shape[0], desc_b.shape[0]
    dev = desc_a.device
    if (uv_a is None) != (uv_b is None) or (oct_a is None) != (oct_b is None):
        raise ValueError("uv_a and uv_b, and oct_a and oct_b, are given together or not at all")
    ptrs = []
    for name, x, dt, shape, align in [
        ("desc_a", desc_a, torch.int32, (N, 8), 16), ("desc_b", desc_b, torch.int32, (M, 8), 16),
        ("valid_a", valid_a, torch.bool, (N,), 1), ("valid_b", valid_b, torch.bool, (M,), 1),
        ("uv_a", uv_a, torch.float32, (N, 2), 8), ("uv_b", uv_b, torch.float32, (M, 2), 8),
        ("radius2", radius2, torch.float32, (N,), 4), ("radius2_cols", radius2_cols, torch.float32, (M,), 4),
        ("oct_a", oct_a, torch.int32, (N,), 4), ("oct_b", oct_b, torch.int32, (M,), 4),
    ]:
        if x is None:
            ptrs.append(None)
            continue
        common.require(x, name, dt, shape, dev)
        if x.data_ptr() % align:
            raise ValueError(f"{name}: expected a tensor aligned to {align} bytes")
        ptrs.append(x.data_ptr())
    return ptrs


def hamming_best2_filled(desc_a, desc_b, valid_a, valid_b, uv_a=None, uv_b=None, radius2=None,
                         radius2_cols=None, oct_a=None, oct_b=None, octave_band: int = -1):
    """``hamming_best2_plain`` with the absent gates filled in."""
    filled = _defaults(desc_a, desc_b, uv_a, uv_b, radius2, radius2_cols, oct_a, oct_b)
    return hamming_best2_plain(desc_a, desc_b, valid_a, valid_b, *filled, int(octave_band))


def hamming_best2(desc_a, desc_b, valid_a, valid_b, uv_a=None, uv_b=None,
                  radius2=None, radius2_cols=None, oct_a=None, oct_b=None,
                  octave_band: int = -1):
    """Best + second-best gated Hamming match per row of A.

    desc_*: i32[·, 8] (u32 bit-casts); returns (best_idx i32[N] (-1 = none),
    best_d i32[N], second_d i32[N]).
    """
    if common.route(desc_a) == "cpu":
        return hamming_best2_filled(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b,
                                    radius2, radius2_cols, oct_a, oct_b, octave_band)
    from .build import load

    lib = load("hamming")
    N, M = desc_a.shape[0], desc_b.shape[0]
    ptrs = _checked(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, radius2, radius2_cols, oct_a, oct_b)
    out = torch.empty((3, N), dtype=torch.int32, device=desc_a.device)
    idx, best, second = out.unbind(0)
    if N == 0:
        return idx, best, second
    at = out.data_ptr()
    err = lib.hamming_best2_launch(*ptrs, int(octave_band), N, M, at, at + 4 * N, at + 8 * N,
                                   common.stream_ptr(desc_a.device))
    common.launches["hamming_best2"] += 1
    common.check(err, "hamming_best2")
    return idx, best, second


def mutual_match_plain(desc_a, desc_b, valid_a, valid_b, uv_a=None, uv_b=None,
                       radius2=None, oct_a=None, oct_b=None, octave_band: int = -1,
                       max_dist: int = 50, ratio: float = 1.0):
    """``mutual_match_fused`` in plain PyTorch, as two calls of the plain
    best/second-best match: the forward pass gates by the A-side radius, the
    reverse pass applies the same per-A gate from the column side."""
    fwd_idx, best_d, second_d = hamming_best2_filled(
        desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, radius2,
        oct_a=oct_a, oct_b=oct_b, octave_band=octave_band,
    )
    rev_idx, _, _ = hamming_best2_filled(
        desc_b, desc_a, valid_b, valid_a, uv_b, uv_a,
        radius2=None, radius2_cols=radius2,
        oct_a=oct_b, oct_b=oct_a, octave_band=octave_band,
    )
    N = desc_a.shape[0]
    if desc_b.shape[0] == 0:
        return torch.full_like(fwd_idx, -1), best_d
    safe = torch.clamp(fwd_idx, 0, desc_b.shape[0] - 1).long()
    mutual = rev_idx[safe] == torch.arange(N, device=desc_a.device)
    ok = (
        (fwd_idx >= 0)
        & (best_d <= max_dist)
        & (best_d.to(torch.float32) < ratio * second_d.to(torch.float32))
        & mutual
    )
    return torch.where(ok, fwd_idx, -1).to(torch.int32), best_d


def mutual_match_fused(desc_a, desc_b, valid_a, valid_b, uv_a=None, uv_b=None,
                       radius2=None, oct_a=None, oct_b=None, octave_band: int = -1,
                       max_dist: int = 50, ratio: float = 1.0):
    """``matching.match_mutual`` semantics on the gated matrix.

    A pair is open where both sides are valid, within the A-side radius and
    within the octave band. Returns (match_b i32[N], best_d i32[N]). On the
    card: one launch over the gated pairs and one over the rows (counted
    together as one ``hamming_mutual``); on the CPU ``mutual_match_plain``.
    """
    if common.route(desc_a) == "cpu":
        return mutual_match_plain(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, radius2,
                                  oct_a, oct_b, octave_band, max_dist, ratio)
    from .build import load

    lib = load("hamming")
    N, M = desc_a.shape[0], desc_b.shape[0]
    if N >= 1 << ROW_BITS:
        raise ValueError(f"mutual_match_fused: at most {(1 << ROW_BITS) - 1} rows, got {N}")
    ptrs = _checked(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, radius2, None, oct_a, oct_b)
    del ptrs[7]   # no column radii in the mutual mode
    # one allocation: match [N], best [N], then the kernel's scratch (idx [N], second [N], column keys [M])
    buf = torch.empty((4 * N + M,), dtype=torch.int32, device=desc_a.device)
    match, best = buf[:N], buf[N:2 * N]
    if N == 0:
        return match, best
    at = buf.data_ptr()
    err = lib.hamming_mutual_launch(*ptrs, int(octave_band), N, M, int(max_dist), float(ratio),
                                    at + 8 * N, at + 4 * N, at + 12 * N, at + 16 * N, at,
                                    common.stream_ptr(desc_a.device))
    common.launches["hamming_mutual"] += 1
    common.check(err, "hamming_mutual")
    return match, best
