"""Kernel B: gated Hamming best/second-best matcher (CUDA: ``csrc/hamming.cu``).

Port of ``dialog_tpu/kernels/hamming.py``. ``hamming_best2`` returns, per row of
A, the best and second-best 256-bit Hamming distance over B under validity,
row- or column-radius and octave-band gates (ties to the lowest column), and
``mutual_match_fused`` reproduces ``matching.match_mutual`` on the gated
matrix with two launches and no [N, M] matrix in device memory.
``hamming_best2_plain`` is the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from . import common

MAX_DIST = 257


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
    N = d.shape[0]
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


def hamming_best2(desc_a, desc_b, valid_a, valid_b, uv_a=None, uv_b=None,
                  radius2=None, radius2_cols=None, oct_a=None, oct_b=None,
                  octave_band: int = -1):
    """Best + second-best gated Hamming match per row of A.

    desc_*: i32[·, 8] (u32 bit-casts); returns (best_idx i32[N] (-1 = none),
    best_d i32[N], second_d i32[N]).
    """
    uv_a, uv_b, radius2, radius2_cols, oct_a, oct_b = _defaults(
        desc_a, desc_b, uv_a, uv_b, radius2, radius2_cols, oct_a, oct_b
    )
    if common.route(desc_a) == "cpu":
        return hamming_best2_plain(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b,
                                   radius2, radius2_cols, oct_a, oct_b, int(octave_band))
    from .build import load

    lib = load("hamming")
    N, M = desc_a.shape[0], desc_b.shape[0]
    dev = desc_a.device
    args = [
        ("desc_a", desc_a, torch.int32, (N, 8)), ("desc_b", desc_b, torch.int32, (M, 8)),
        ("valid_a", valid_a, torch.bool, (N,)), ("valid_b", valid_b, torch.bool, (M,)),
        ("uv_a", uv_a, torch.float32, (N, 2)), ("uv_b", uv_b, torch.float32, (M, 2)),
        ("radius2", radius2, torch.float32, (N,)), ("radius2_cols", radius2_cols, torch.float32, (M,)),
        ("oct_a", oct_a, torch.int32, (N,)), ("oct_b", oct_b, torch.int32, (M,)),
    ]
    for name, x, dt, shape in args:
        common.require(x, name, dt, shape, dev)
    idx = torch.empty((N,), dtype=torch.int32, device=dev)
    best = torch.empty_like(idx)
    second = torch.empty_like(idx)
    if N == 0:
        return idx, best, second
    fn = lib.hamming_best2_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    err = fn(*[common.ptr(x) for _, x, _, _ in args], int(octave_band), N, M,
             common.ptr(idx), common.ptr(best), common.ptr(second), common.stream_ptr(dev))
    common.launches["hamming_best2"] += 1
    common.check(err, "hamming_best2")
    return idx, best, second


def mutual_match_fused(desc_a, desc_b, valid_a, valid_b, uv_a=None, uv_b=None,
                       radius2=None, oct_a=None, oct_b=None, octave_band: int = -1,
                       max_dist: int = 50, ratio: float = 1.0):
    """``matching.match_mutual`` semantics on the gated matrix, two launches.

    The forward pass gates by the A-side radius; the reverse pass applies the
    same per-A gate from the column side. Returns (match_b i32[N], best_d i32[N]).
    """
    fwd_idx, best_d, second_d = hamming_best2(
        desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, radius2,
        oct_a=oct_a, oct_b=oct_b, octave_band=octave_band,
    )
    rev_idx, _, _ = hamming_best2(
        desc_b, desc_a, valid_b, valid_a, uv_b, uv_a,
        radius2=None, radius2_cols=radius2,
        oct_a=oct_b, oct_b=oct_a, octave_band=octave_band,
    )
    N = desc_a.shape[0]
    safe = torch.clamp(fwd_idx, 0, max(desc_b.shape[0] - 1, 0)).long()
    mutual = rev_idx[safe] == torch.arange(N, device=desc_a.device)
    ok = (
        (fwd_idx >= 0)
        & (best_d <= max_dist)
        & (best_d.to(torch.float32) < ratio * second_d.to(torch.float32))
        & mutual
    )
    return torch.where(ok, fwd_idx, -1).to(torch.int32), best_d
