"""PNG files without cv2: the reader behind the sequence loaders, and a writer.

The reference's loaders decode with ``cv2.imread`` (libpng underneath);
the machine with the card has no cv2, so the port reads PNG itself. Its two
entry points give cv2's bits:

* ``read_gray(path)``: ``cv2.IMREAD_GRAYSCALE``, uint8 [H, W]. What libpng
  does under OpenCV's settings (``png_set_strip_alpha``,
  ``png_set_rgb_to_gray(1, 0.299, 0.587)``, ``png_set_strip_16``):

  - gray: as stored; 16-bit gray: the high byte;
  - alpha (colour types 4 and 6): dropped;
  - 8-bit colour: ``(9797 R + 19234 G + 3737 B) >> 15``, truncated (a pixel
    whose three channels are equal keeps its value);
  - 8-bit colour in a file whose gAMA or sRGB chunk gives a gamma g off 1 by
    more than libpng's threshold (0.05): the weighted sum is taken on
    libpng's linearized bytes and re-encoded, ``from1[(9797 to1[R] + 19234
    to1[G] + 3737 to1[B] + 16384) >> 15]`` with the 8-bit tables
    ``to1[v] = floor(255 (v/255)^(1/g) + .5)`` and ``from1[v] = floor(255
    (v/255)^g + .5)`` (``_gamma_tables``); equal channels keep their value;
  - 16-bit colour: ``(9797 R + 19234 G + 3737 B + 16384) >> 15`` on the
    16-bit samples, rounded, then the high byte; with a gamma off 1 it
    raises (libpng's 16-bit gamma tables are not reproduced here).

* ``read_unchanged(path)``: ``cv2.IMREAD_UNCHANGED``: gray as uint8 or
  uint16 [H, W] (TUM's depth maps: 16-bit big-endian in the file, native
  ``uint16`` out), colour as BGR(A) [H, W, 3 or 4], gray with alpha as BGRA.

A palette (colour type 3), an interlaced file, a bit depth other than 8 or
16, a bad chunk CRC or a short image stream raises ``ValueError`` naming the
file. The row unfilter runs in C++ (``native/png.cpp``); ``unfilter_plain``
is the same in numpy, kept as the tests' reference.

``write_png(path, array)`` writes 8-bit gray (uint8 [H, W]), 8-bit RGB
(uint8 [H, W, 3], R first) and 16-bit gray (uint16 [H, W]), every row with
filter 0, deflated by zlib, with no ancillary chunk.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples per pixel
SRGB_GAMMA = 45455                     # libpng's file gamma for an sRGB chunk (1 / 2.2, x 1e5)
GAMMA_THRESHOLD = 5000                 # libpng: a gamma within 0.05 of 1 is not corrected


def _chunks(path: str, data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    at = 8
    while at + 12 <= len(data):
        (n,) = struct.unpack(">I", data[at : at + 4])
        kind, body = data[at + 4 : at + 8], data[at + 8 : at + 8 + n]
        (crc,) = struct.unpack(">I", data[at + 8 + n : at + 12 + n] or b"\0\0\0\0")
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: chunk {kind!r} is cut short or fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        at += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def inflate(path: str):
    """The file's filtered image stream, uint8 [H, 1 + rowbytes] (each row
    its filter type, then its bytes), its bytes per pixel, its IHDR fields
    (width, height, bit depth, colour type) and the file gamma of a gAMA or
    sRGB chunk before the image data (x 1e5; 0: none)."""
    with open(path, "rb") as f:
        data = f.read()
    head, idat, gamma, srgb = None, [], 0, False
    for kind, body in _chunks(path, data):
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"gAMA" and not idat:
            gamma = struct.unpack(">I", body)[0]
        elif kind == b"sRGB" and not idat:
            srgb = True
    if head is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, ctype, _, _, interlace = head
    if ctype not in CHANNELS:
        raise ValueError(f"{path}: colour type {ctype} (palette or unknown) is not read")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not read")
    if depth not in (8, 16):
        raise ValueError(f"{path}: bit depth {depth} is not read (8 or 16)")
    bpp = CHANNELS[ctype] * depth // 8
    rowbytes = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (rowbytes + 1):
        raise ValueError(f"{path}: image stream holds {len(raw)} bytes, {h * (rowbytes + 1)} expected")
    raw = np.frombuffer(raw, np.uint8, h * (rowbytes + 1)).reshape(h, rowbytes + 1)
    return raw, bpp, (w, h, depth, ctype), SRGB_GAMMA if srgb else gamma


def _decode(path: str):
    """The file's samples, uint8 or uint16 [H, W, channels], its colour type
    and its file gamma (``inflate``)."""
    raw, bpp, (w, h, depth, ctype), gamma = inflate(path)
    rows = unfilter(raw, bpp)
    if isinstance(rows, int):
        raise ValueError(f"{path}: row {rows} has an unknown filter type {raw[rows, 0]}")
    px = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    return px.reshape(h, w, CHANNELS[ctype]), ctype, gamma


def unfilter(raw: np.ndarray, bpp: int):
    """Rows uint8 [H, rowbytes] from the filtered stream [H, 1 + rowbytes]
    (native ``png_unfilter``), or the index of the first row whose filter
    type is not 0-4."""
    from .. import native

    raw = np.ascontiguousarray(raw)
    h, n = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, n), np.uint8)
    bad = native.load("png").png_unfilter(raw.ctypes.data, h, n, bpp, out.ctypes.data)
    return bad - 1 if bad else out


def unfilter_plain(raw: np.ndarray, bpp: int):
    """``unfilter`` in numpy and Python: None, Sub and Up a row at a time,
    Average and Paeth byte by byte."""
    h, n = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((h, n), np.uint8)
    prior = np.zeros(n, np.uint8)
    for y in range(h):
        kind, f = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            out[y] = f
        elif kind == 1:
            out[y] = np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[y] = f + prior
        elif kind in (3, 4):
            x, b = [0] * (n + bpp), [0] * bpp + prior.tolist()
            for i, v in enumerate(f.tolist()):
                left, up, ul = x[i], b[i + bpp], b[i]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - ul
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                    pred = left if pa <= pb and pa <= pc else up if pb <= pc else ul
                x[i + bpp] = (v + pred) & 0xFF
            out[y] = x[bpp:]
        else:
            return y
        prior = out[y]
    return out


def _gamma_tables(gamma: int):
    """libpng's 8-bit ``gamma_to_1`` and ``gamma_from_1`` tables for a file
    gamma (x 1e5) under OpenCV's read, where the screen gamma defaults to its
    reciprocal (``png_build_gamma_table``, ``png_gamma_8bit_correct``)."""
    def recip(a):
        return int(math.floor(1e10 / a + 0.5))

    def table(g):
        if abs(g - 100000) <= GAMMA_THRESHOLD:
            return np.arange(256, dtype=np.int64)
        return np.array([v if v in (0, 255) else int(math.floor(255 * math.pow(v / 255.0, g * 0.00001) + 0.5))
                         for v in range(256)], np.int64)

    return table(recip(gamma)), table(recip(recip(gamma)))


def _to_gray(path: str, px: np.ndarray, ctype: int, gamma: int) -> np.ndarray:
    if ctype in (0, 4):
        g = px[..., 0]
        return (g >> 8).astype(np.uint8) if g.dtype == np.uint16 else g.copy()
    # the weights sum to 32768, so equal channels keep their value in the two
    # plain rules (libpng tests for them and skips the sum)
    wide = np.int64 if px.dtype == np.uint16 else np.int32
    r, gr, b = (px[..., i].astype(wide) for i in range(3))
    corrected = gamma > 0 and abs(gamma - 100000) > GAMMA_THRESHOLD
    if px.dtype == np.uint16:
        if corrected:
            raise ValueError(f"{path}: 16-bit colour with a file gamma of {gamma / 1e5} is not read")
        return (((9797 * r + 19234 * gr + 3737 * b + 16384) >> 15) >> 8).astype(np.uint8)
    if corrected:
        to1, from1 = _gamma_tables(gamma)
        g = from1[(9797 * to1[r] + 19234 * to1[gr] + 3737 * to1[b] + 16384) >> 15]
        return np.where((r == gr) & (r == b), r, g).astype(np.uint8)
    return ((9797 * r + 19234 * gr + 3737 * b) >> 15).astype(np.uint8)


def read_gray(path: str) -> np.ndarray:
    """cv2's ``IMREAD_GRAYSCALE`` bits of a PNG file, uint8 [H, W]."""
    px, ctype, gamma = _decode(path)
    return _to_gray(path, px, ctype, gamma)


def read_unchanged(path: str) -> np.ndarray:
    """cv2's ``IMREAD_UNCHANGED`` array of a PNG file: gray [H, W] as
    stored (uint8 or uint16), colour as BGR or BGRA, gray with alpha as BGRA."""
    px, ctype, _ = _decode(path)
    if ctype == 0:
        return px[..., 0].copy()
    if ctype == 4:
        return np.ascontiguousarray(px[..., [0, 0, 0, 1]])
    return np.ascontiguousarray(px[..., [2, 1, 0, 3][: px.shape[-1]]])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, array: np.ndarray) -> None:
    """Write uint8 [H, W] (gray), uint8 [H, W, 3] (RGB) or uint16 [H, W]
    (16-bit gray) as a PNG file: filter 0 on every row, zlib level 6."""
    a = np.asarray(array)
    if a.dtype == np.uint8 and a.ndim == 2:
        ctype, depth = 0, 8
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        ctype, depth = 2, 8
    elif a.dtype == np.uint16 and a.ndim == 2:
        ctype, depth = 0, 16
    else:
        raise ValueError(f"write_png: uint8 [H, W], uint8 [H, W, 3] or uint16 [H, W], got {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))
