"""The port's PNG reader and writer against cv2 (libpng), which the port
does not use: the machine with the card has no cv2.

Tolerance: exact. ``read_gray`` equals ``cv2.imread(IMREAD_GRAYSCALE)`` and
``read_unchanged`` equals ``cv2.imread(IMREAD_UNCHANGED)`` bit for bit, in
value, shape and dtype: on files cv2 writes (8-bit gray, 8-bit RGB random
and rendered, 16-bit depth), on files this test encodes itself with the
filter types 0-4 cycling by row at odd widths (gray, RGB, gray with alpha,
RGBA; 8 and 16 bits), and with a gAMA or sRGB chunk (libpng's gamma-correct
grey conversion). The native unfilter equals the numpy one. ``write_png``
output reads back through cv2 unchanged.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.datasets import png, synth

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _encode(a, ctype, depth, extra=b"", filters=(0, 1, 2, 3, 4), interlace=0):
    """A PNG of ``a`` whose row y has filter type filters[y % len(filters)]."""
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a).reshape(h, -1).view(np.uint8).astype(np.int64)
    bpp = CHANNELS[ctype] * depth // 8
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        kind, x = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        pred = {0: 0, 1: left, 2: prev, 3: (left + prev) >> 1,
                4: np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))}[kind]
        out.append(bytes([kind]) + ((x - pred) & 255).astype(np.uint8).tobytes())
        prev = x
    head = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (png.SIGNATURE + _chunk(b"IHDR", head) + extra + _chunk(b"IDAT", zlib.compress(b"".join(out)))
            + _chunk(b"IEND", b""))


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _rendered(w=320, h=240):
    cfg = EngineConfig(width=w, height=h, fx=260.0, fy=260.0, cx=w / 2, cy=h / 2)
    scene = synth.make_scene(seed=11, n_points=500, n_frames=2, cfg=cfg)
    return scene, synth.render_image(scene, 1).clip(0, 255).astype(np.uint8)


def _cv2_files():
    rng = np.random.default_rng(0)
    scene, img = _rendered()
    rgb = rng.integers(0, 256, (61, 97, 3), dtype=np.uint8)
    shaded = np.stack([img, np.roll(img, 3, 1), 255 - img], -1)
    depth = np.clip(synth.render_depth(scene, 1) * 5000, 0, 65535).astype(np.uint16)
    return {"gray8": img, "gray8-random": rng.integers(0, 256, (33, 47), dtype=np.uint8),
            "bgr8-random": rgb, "bgr8-rendered": shaded, "depth16": depth,
            "gray16-random": rng.integers(0, 65536, (29, 31), dtype=np.uint16)}


@pytest.mark.parametrize("name", sorted(_cv2_files()))
def test_reads_what_cv2_writes_as_cv2_reads_it(tmp_path, name):
    a = _cv2_files()[name]
    p = str(tmp_path / f"{name}.png")
    assert cv2.imwrite(p, a)
    _same(png.read_gray(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    _same(png.read_unchanged(p), cv2.imread(p, cv2.IMREAD_UNCHANGED))


FILTERED = [(ctype, depth, w) for ctype in (0, 2, 4, 6) for depth in (8, 16) for w in (1, 37, 101)]


@pytest.mark.parametrize("ctype,depth,w", FILTERED, ids=[f"type{c}-{d}bit-w{w}" for c, d, w in FILTERED])
def test_every_filter_type_reads_as_cv2_reads_it(tmp_path, ctype, depth, w):
    rng = np.random.default_rng(ctype * 100 + depth + w)
    shape = (23, w, CHANNELS[ctype]) if CHANNELS[ctype] > 1 else (23, w)
    a = rng.integers(0, 2**depth, shape).astype(np.uint16 if depth == 16 else np.uint8)
    if ctype in (2, 6):
        a[:5, :, 1] = a[:5, :, 0]   # rows of equal channels keep their value
        a[:5, :, 2] = a[:5, :, 0]
    p = str(tmp_path / "f.png")
    with open(p, "wb") as f:
        f.write(_encode(a, ctype, depth))
    _same(png.read_gray(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    _same(png.read_unchanged(p), cv2.imread(p, cv2.IMREAD_UNCHANGED))
    raw, bpp = png.inflate(p)[:2]
    np.testing.assert_array_equal(png.unfilter(raw, bpp), png.unfilter_plain(raw, bpp))


GAMMA = {"gAMA-2.2": _chunk(b"gAMA", struct.pack(">I", 45455)), "gAMA-1.8": _chunk(b"gAMA", struct.pack(">I", 55556)),
         "gAMA-1.0": _chunk(b"gAMA", struct.pack(">I", 100000)), "gAMA-near-1": _chunk(b"gAMA", struct.pack(">I", 96000)),
         "sRGB": _chunk(b"sRGB", b"\x00")}


@pytest.mark.parametrize("chunk", sorted(GAMMA))
@pytest.mark.parametrize("ctype", [0, 2, 6])
def test_gamma_chunks_read_as_cv2_reads_them(tmp_path, chunk, ctype):
    """A file gamma off 1 changes libpng's grey conversion of 8-bit colour
    (gray stays as stored); the port follows it."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (40, 53, CHANNELS[ctype]) if ctype else (40, 53)).astype(np.uint8)
    p = str(tmp_path / "g.png")
    with open(p, "wb") as f:
        f.write(_encode(a, ctype, 8, extra=GAMMA[chunk]))
    _same(png.read_gray(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))


def test_sixteen_bit_colour_with_a_gamma_raises(tmp_path):
    p = str(tmp_path / "g16.png")
    with open(p, "wb") as f:
        f.write(_encode(np.zeros((4, 5, 3), np.uint16), 2, 16, extra=GAMMA["sRGB"]))
    with pytest.raises(ValueError, match="g16.png"):
        png.read_gray(p)
    _same(png.read_unchanged(p), cv2.imread(p, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_equals_numpy(bpp):
    rng = np.random.default_rng(bpp)
    rows, rowbytes = 40, bpp * 29
    raw = rng.integers(0, 256, (rows, rowbytes + 1), dtype=np.uint8)
    raw[:, 0] = np.arange(rows) % 5
    want = png.unfilter_plain(raw, bpp)
    np.testing.assert_array_equal(png.unfilter(raw, bpp), want)
    raw[17, 0] = 9   # an unknown filter type: both report the row
    assert png.unfilter(raw, bpp) == 17 and png.unfilter_plain(raw, bpp) == 17


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_write_png_reads_back_through_cv2(tmp_path, kind):
    rng = np.random.default_rng(3)
    a = {"gray8": rng.integers(0, 256, (31, 45), dtype=np.uint8),
         "rgb8": rng.integers(0, 256, (31, 45, 3), dtype=np.uint8),
         "gray16": rng.integers(0, 65536, (31, 45), dtype=np.uint16)}[kind]
    p = str(tmp_path / "w.png")
    png.write_png(p, a)
    _same(cv2.imread(p, cv2.IMREAD_UNCHANGED), a[..., ::-1] if a.ndim == 3 else a)
    _same(png.read_unchanged(p), a[..., ::-1] if a.ndim == 3 else a)
    if kind == "rgb8":
        _same(png.read_gray(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    with pytest.raises(ValueError):
        png.write_png(p, a.astype(np.float32))


def _raw(depth, ctype, stream, interlace=0, extra=b""):
    head = struct.pack(">IIBBBBB", 7, 6, depth, ctype, 0, 0, interlace)
    return (png.SIGNATURE + _chunk(b"IHDR", head) + extra + _chunk(b"IDAT", zlib.compress(stream))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["palette", "interlaced", "depth4", "bad-crc", "short-stream", "not-png", "bad-filter"])
def test_files_it_does_not_read_raise_naming_the_file(tmp_path, case):
    good = _encode(np.zeros((6, 7), np.uint8), 0, 8)
    data = {
        "palette": lambda: _raw(8, 3, b"\0" * 48, extra=_chunk(b"PLTE", b"\0\0\0")),
        "interlaced": lambda: _raw(8, 0, b"\0" * 48, interlace=1),
        "depth4": lambda: _raw(4, 0, b"\0" * 30),
        "bad-crc": lambda: good[:-16] + bytes([good[-16] ^ 1]) + good[-15:],
        "short-stream": lambda: _raw(8, 0, b"\0" * 20),
        "not-png": lambda: b"GIF89a" + b"\0" * 40,
        "bad-filter": lambda: _raw(8, 0, b"\0" * 8 + b"\7" + b"\0" * 39),
    }[case]()
    p = str(tmp_path / f"{case}.png")
    with open(p, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=f"{case}.png"):
        png.read_gray(p)
    with pytest.raises(FileNotFoundError):
        png.read_gray(str(tmp_path / "missing.png"))
