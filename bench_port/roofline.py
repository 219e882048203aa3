"""The least time the card needs for a kernel's work: peaks, and bytes and operations from the work's shapes.

Frozen here, so that any implementation of the same function is held to the
same count. Each input byte is read once and each output byte written once,
and where the work depends on the data the count is of what these inputs
need. Peaks: one NVIDIA H100 SXM (data sheet, 700 W): 3.35 TB/s of HBM, 67
TFLOP/s of float32 outside the tensor cores.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12


def least_seconds(nbytes: float, ops: float) -> tuple[float, str]:
    """(the larger of bytes / peak bandwidth and operations / peak rate, which bounds)."""
    tb, to = nbytes / PEAK_BYTES_S, ops / PEAK_FLOP_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def fast_work(levels: list[tuple]) -> tuple[float, float]:
    """Kernel A over one pyramid (or a batch of them): each level shape (H, W) or (B, H, W).
    Bytes: each pixel read once (f32) and its rank written once (f32). Operations: the 16
    differences of the FAST circle per pixel, the least any FAST-9 test needs."""
    pixels = 0
    for shape in levels:
        n = 1
        for d in shape:
            n *= int(d)
        pixels += n
    return 8.0 * pixels, 16.0 * pixels


def hamming_work(n_rows: int, n_cols: int) -> tuple[float, float]:
    """Kernel B, one gated mutual match of N landmark rows against M feature columns.
    Bytes: the 32-byte descriptors of both sides, each row's uv, squared radius, octave and
    validity (17 bytes), each column's uv, octave and validity (13), the match and its
    distance out (8 a row). Operations: the radius gate of every pair (two differences, a
    multiply-add and a compare: 4)."""
    return 32.0 * (n_rows + n_cols) + 17.0 * n_rows + 13.0 * n_cols + 8.0 * n_rows, 4.0 * n_rows * n_cols


def schur_work(n_cams: int, n_points: int, n_obs: int, n_pairs: int, stereo: bool) -> tuple[float, float]:
    """Kernel C, one reduction over the window's live observations.

    ``n_points``: landmarks with at least one live observation; ``n_obs``: live observations;
    ``n_pairs``: sum over landmarks of n(n+1)/2 for their n live observations (the camera-pair
    blocks S_pair needs). Bytes: per observation its camera, pixel and weight (16, 20 with a
    right-x) in and its Y block (72) out; per landmark its point (12) in and Hll^-1 and g_l (48)
    out; per camera its pose and flag (49) in and Hcc, g_c, g_red (192) out; S_pair (144 a
    camera pair) out. Operations (two rows per observation, the fewest it has): the
    Jacobians' products per observation (Hcc 72, Y 72, Hll 24, g_c 24, g_l 12, Y Hll^-1 108,
    g_red 36), and per pair of observations of one landmark its 6x6 block (216)."""
    per_obs_in = 20.0 if stereo else 16.0
    nbytes = (n_obs * (per_obs_in + 72.0) + n_points * 60.0 + n_cams * (49.0 + 192.0)
              + 144.0 * n_cams * n_cams)
    ops = 348.0 * n_obs + 216.0 * n_pairs
    return nbytes, ops
