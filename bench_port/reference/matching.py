"""Plain reference of the gated mutual Hamming match (what kernel B answers).

A pair (row a, column b) is open where both are valid, the squared pixel
distance dx*dx + dy*dy (float32, one rounding per operation) is within row
a's squared radius (a radius below 0 opens every pair) and the octaves are at
most ``octave_band`` apart (a band below 0 opens every pair). Row a matches
its nearest open column (ties to the lower index) when that distance is at
most ``max_dist``, below ``ratio`` x the second nearest, and row a is also
that column's nearest open row. Distances are exact.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_DIST = 257


def popcount_table() -> np.ndarray:
    return np.array([bin(i).count("1") for i in range(256)], np.int64)


def hamming(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """i32[N, 8] x i32[M, 8] -> i64[N, M] Hamming distances, by bytes through a popcount table."""
    table = torch.from_numpy(popcount_table()).to(desc_a.device)
    a = desc_a.contiguous().view(torch.uint8).to(torch.int64)
    b = desc_b.contiguous().view(torch.uint8).to(torch.int64)
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64, device=desc_a.device)
    for k in range(a.shape[1]):
        out += table[a[:, None, k] ^ b[None, :, k]]
    return out


def mutual_match(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, radius2, oct_a, oct_b, octave_band,
                 max_dist, ratio, block: int = 2048) -> torch.Tensor:
    """match_b i64[N] (-1 = none), in blocks of ``block`` rows."""
    N, M = desc_a.shape[0], desc_b.shape[0]
    dev = desc_a.device
    if M == 0 or N == 0:
        return torch.full((N,), -1, dtype=torch.int64, device=dev)
    col_best_d = torch.full((M,), MAX_DIST, dtype=torch.int64, device=dev)
    col_best_r = torch.full((M,), N, dtype=torch.int64, device=dev)
    rows = []
    for s in range(0, N, block):
        e = min(s + block, N)
        d = hamming(desc_a[s:e], desc_b)
        ok = valid_a[s:e, None] & valid_b[None, :]
        if uv_a is not None:
            dx = uv_a[s:e, None, 0] - uv_b[None, :, 0]
            dy = uv_a[s:e, None, 1] - uv_b[None, :, 1]
            r2 = radius2[s:e, None]
            ok &= (r2 < 0) | (dx * dx + dy * dy <= r2)
        if oct_a is not None and octave_band >= 0:
            ok &= torch.abs(oct_a[s:e, None].long() - oct_b[None, :].long()) <= octave_band
        d = torch.where(ok, d, MAX_DIST)
        best_d, best = d.min(dim=1)   # ties: the lowest index
        d2 = d.clone()
        d2[torch.arange(e - s, device=dev), best] = MAX_DIST
        second = d2.min(dim=1).values
        # the column side: nearest row, ties to the lower row
        cd, cr = d.min(dim=0)
        better = cd < col_best_d
        col_best_r = torch.where(better, cr + s, col_best_r)
        col_best_d = torch.where(better, cd, col_best_d)
        rows.append((best, best_d, second))
    best = torch.cat([r[0] for r in rows])
    best_d = torch.cat([r[1] for r in rows])
    second = torch.cat([r[2] for r in rows])
    # the ratio test in float32, as the program states it
    ratio32 = torch.tensor(ratio, dtype=torch.float32, device=dev)
    ok = ((best_d < MAX_DIST) & (best_d <= max_dist) & (best_d.float() < ratio32 * second.float())
          & (col_best_r[best] == torch.arange(N, device=dev)))
    return torch.where(ok, best, -1)
