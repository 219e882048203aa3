"""The frozen bytes and operations of kernels A, B and C, worked by hand at small shapes."""

from __future__ import annotations

import pytest

from bench_port import roofline


def test_fast_work_counts_each_pixel_once():
    # two levels of a batch of 2: 2*(4*6) + 2*(3*5) = 78 pixels, 8 bytes and 16 operations each
    assert roofline.fast_work([(2, 4, 6), (2, 3, 5)]) == (8.0 * 78, 16.0 * 78)
    assert roofline.fast_work([(4, 6)]) == (8.0 * 24, 16.0 * 24)


def test_hamming_work():
    # 3 rows, 5 columns: descriptors 32*(3+5) = 256; rows 17*3 = 51; columns 13*5 = 65; out 8*3 = 24
    assert roofline.hamming_work(3, 5) == (256.0 + 51.0 + 65.0 + 24.0, 4.0 * 15)


def test_schur_work():
    # 2 cameras, 3 landmarks, 4 observations (one landmark seen twice: pairs 3 + 1 + 1 = 5), mono
    nbytes, ops = roofline.schur_work(n_cams=2, n_points=3, n_obs=4, n_pairs=5, stereo=False)
    assert nbytes == 4 * (16 + 72) + 3 * 60 + 2 * (49 + 192) + 144 * 4
    assert ops == 348 * 4 + 216 * 5
    stereo_bytes, _ = roofline.schur_work(n_cams=2, n_points=3, n_obs=4, n_pairs=5, stereo=True)
    assert stereo_bytes == nbytes + 4 * 4


def test_least_seconds_takes_the_larger_bound():
    t, by = roofline.least_seconds(3.35e12, 0.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = roofline.least_seconds(0.0, 67e12 * 2)
    assert t == pytest.approx(2.0) and by == "operations"
