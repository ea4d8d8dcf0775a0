"""The port's TIFF, BMP and interlaced PNG decoding against bem_tpu's
``imfrombytes`` (``cv2.imdecode``), bit for bit, under each of the three
read flags, on files the port's writers (``utils/image_writers.py``) and
cv2 build here:

- TIFF: II and MM; strips and tiles; compression none, LZW, Deflate (8 and
  32946) and PackBits; predictor 2 (libtiff applies it to LZW and Deflate
  only); planar configuration 1 and 2; photometric 0 / 1 at 1, 8, 16 bits,
  2 at 8 and 16 bits with and without alpha (unassociated alpha
  premultiplied), 3 at 1, 4, 8 bits with 16-bit and 8-bit colormaps; every
  Orientation tag; the rules pinned: 16-bit RGB to round(v * 255 / 65535),
  16-bit grey to v >> 8; cv2's own TIFF writer. Refused: JPEG-in-TIFF,
  CCITT, float samples, 4-bit grey (cv2 refuses it too).
- BMP: 1 / 4 / 8-bit palette (colour and grey palettes), RLE8 and RLE4 on
  every stream of up to four escapes over a 3x2 and a 2x3 image (runs,
  absolute runs, end of line, end of bitmap, deltas; accepted and refused
  alike), 16-bit 5-5-5 and BI_BITFIELDS 5-6-5, 24- and 32-bit (bit masks in
  headers of 56 bytes and more), bottom-up and top-down, info headers of
  12, 40, 52, 56, 108 and 124 bytes; cv2's own BMP writer.
- PNG Adam7: every colour type and bit depth, with and without tRNS, at
  sizes with empty passes (1x1, 1x9, 5x7).
"""

import itertools
import struct

import cv2
import numpy as np
import pytest

from bem_tpu.utils.img_util import imfrombytes as bem_imfrombytes
from bem_tpu_torch.utils.image_writers import (bmp_rows, encode_bmp, encode_bmp_palette,
                                               encode_png_samples, encode_tiff)
from bem_tpu_torch.utils.img_util import imfrombytes

FLAGS = ("color", "grayscale", "unchanged")
CV2_FLAGS = {"color": cv2.IMREAD_COLOR, "grayscale": cv2.IMREAD_GRAYSCALE,
             "unchanged": cv2.IMREAD_UNCHANGED}


def _rgb(img):
    """bem_tpu's BGR(A) -> the port's RGB(A)."""
    if img is not None and img.ndim == 3:
        return img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def bem(data, flag):
    """bem_tpu's read, None where cv2 refuses the file."""
    if cv2.imdecode(np.frombuffer(data, np.uint8), CV2_FLAGS[flag]) is None:
        return None
    return _rgb(bem_imfrombytes(data, flag))


def same(data, flags=FLAGS, name="x.img"):
    """Every flag's port read equals bem_tpu's; returns the colour read."""
    out = {}
    for flag in flags:
        want = bem(data, flag)
        assert want is not None, f"cv2 refuses the file under {flag}"
        got = imfrombytes(data, flag, name=name)
        assert got.shape == want.shape and got.dtype == want.dtype, (flag, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=flag)
        out[flag] = got
    return out


def refused(data, match, flags=FLAGS):
    """The port raises a ValueError naming the file under each flag."""
    for flag in flags:
        with pytest.raises(ValueError, match=match):
            imfrombytes(data, flag, name="refused.tif")


# ---------------------------------------------------------------------- TIFF

SIZES = [(1, 1), (5, 7), (37, 53)]
LAYOUTS = {"strips": dict(rows_per_strip=3), "tiles": dict(tile=(16, 16)),
           "planar strips": dict(planar=2, rows_per_strip=4),
           "planar tiles": dict(planar=2, tile=(16, 32))}


# cv2's libtiff refuses uncompressed tiles (test_tiff_refused)
CASES = [(c, layout) for c in (1, 5, 8, 32946, 32773) for layout in LAYOUTS
         if not (c == 1 and "tiles" in layout)]


@pytest.mark.parametrize("compression,layout", CASES)
@pytest.mark.parametrize("byteorder", ["<", ">"])
def test_tiff_rgb_and_grey(compression, layout, byteorder):
    rng = np.random.default_rng(compression + len(layout))
    for h, w in SIZES:
        for predictor in (1, 2):
            kw = dict(compression=compression, predictor=predictor, byteorder=byteorder,
                      **LAYOUTS[layout])
            s8 = rng.integers(0, 256, (h, w, 3))
            got = same(encode_tiff(s8, 2, 8, **kw))
            np.testing.assert_array_equal(got["color"], s8)
            s16 = rng.integers(0, 65536, (h, w, 3))
            flags = FLAGS[:2] if "planar" in layout else FLAGS  # cv2 misreads 16-bit planes
            got = same(encode_tiff(s16, 2, 16, **kw), flags)
            np.testing.assert_array_equal(got["color"], (s16 * 255 + 32767) // 65535)
            if "unchanged" in got:
                np.testing.assert_array_equal(got["unchanged"], s16)
            for extra in (0, 1, 2):
                same(encode_tiff(rng.integers(0, 256, (h, w, 4)), 2, 8, extra_samples=(extra,),
                                 **kw))
            if "planar" not in layout:
                same(encode_tiff(rng.integers(0, 65536, (h, w, 4)), 2, 16, extra_samples=(2,),
                                 **kw))
            for photometric in (0, 1):
                for bits in ((8, 16) if predictor == 2 else (1, 8, 16)):
                    g = rng.integers(0, 1 << bits, (h, w, 1))
                    if bits == 16 and "tiles" in layout:  # libtiff misreads these (refused)
                        same(encode_tiff(g, photometric, bits, **kw), ("unchanged",))
                        continue
                    got = same(encode_tiff(g, photometric, bits, **kw))
                    if bits == 16:
                        want = g[..., 0] >> 8
                        np.testing.assert_array_equal(
                            got["grayscale"], 255 - want if photometric == 0 else want)
                if "tiles" not in layout:
                    for extra in (0, 2):
                        same(encode_tiff(rng.integers(0, 256, (h, w, 2)), photometric, 8,
                                         extra_samples=(extra,), **kw))


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_tiff_palette(bits):
    rng = np.random.default_rng(bits)
    for h, w in SIZES:
        for wide in (True, False):  # a 16-bit colormap, or one libtiff takes as 8-bit
            cmap = rng.integers(0, 65536 if wide else 256, (3, 1 << bits))
            idx = rng.integers(0, 1 << bits, (h, w, 1))
            for compression in (5, 32773):
                got = same(encode_tiff(idx, 3, bits, compression, colormap=cmap))
                want = (cmap >> (8 if wide else 0)).T[idx[..., 0]]
                np.testing.assert_array_equal(got["color"], want)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation(orientation):
    rng = np.random.default_rng(orientation)
    same(encode_tiff(rng.integers(0, 256, (5, 7, 3)), 2, 8, 8, orientation=orientation))
    got = same(encode_tiff(rng.integers(0, 65536, (5, 7, 3)), 2, 16, 8,
                           orientation=orientation))
    assert got["unchanged"].shape == ((7, 5, 3) if orientation >= 5 else (5, 7, 3))


def test_tiff_cv2_writer():
    rng = np.random.default_rng(3)
    for shape, dtype in (((37, 53, 3), np.uint8), ((37, 53), np.uint8), ((9, 11, 4), np.uint8),
                         ((37, 53, 3), np.uint16), ((8, 8), np.uint16)):
        img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
        ok, buf = cv2.imencode(".tif", img)
        assert ok
        same(buf.tobytes())


def test_tiff_refused():
    rng = np.random.default_rng(4)
    s = rng.integers(0, 256, (5, 7, 3))
    base = encode_tiff(s, 2, 8, 8)
    for comp, what in ((7, "JPEG"), (6, "old-style JPEG"), (3, "CCITT"), (4, "CCITT")):
        data = bytearray(base)
        at = data.index(struct.pack("<HHI", 259, 3, 1))
        data[at + 8:at + 10] = struct.pack("<H", comp)
        refused(bytes(data), f"refused.tif: a {what}")
    refused(_with_tag(base, 339, 3), "float or signed")
    refused(encode_tiff(rng.integers(0, 16, (5, 7, 1)), 1, 4, 8), "photometric 1 at 4 bits")
    refused(encode_tiff(s, 2, 8, 1, tile=(16, 16)), "uncompressed tiled")
    refused(encode_tiff(rng.integers(0, 65536, (5, 7, 1)), 1, 16, 8, tile=(16, 16)),
            "tiled 16-bit grey", FLAGS[:2])
    refused(encode_tiff(rng.integers(0, 256, (5, 7, 2)), 1, 8, 8, tile=(16, 16),
                        extra_samples=(0,)), "tiled 8-bit grey \\+ alpha")
    refused(encode_tiff(rng.integers(0, 65536, (5, 7, 3)), 2, 16, 8, planar=2), "16-bit planar",
            ("unchanged",))
    for data in (_with_tag(base, 339, 3), encode_tiff(rng.integers(0, 16, (5, 7, 1)), 1, 4, 8),
                 encode_tiff(s, 2, 8, 1, tile=(16, 16))):
        assert bem(data, "color") is None  # cv2 refuses these too


def _with_tag(data, tag, value):
    """A little-endian TIFF from encode_tiff with one SHORT tag added to its
    IFD (rewritten at the end of the file)."""
    (at,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[at:at + 2])
    entries = [data[at + 2 + 12 * i:at + 14 + 12 * i] for i in range(n)]
    entries.append(struct.pack("<HHIHH", tag, 3, 1, value, 0))
    entries.sort(key=lambda e: struct.unpack("<H", e[:2])[0])
    ifd = struct.pack("<H", n + 1) + b"".join(entries) + b"\0\0\0\0"
    return data[:4] + struct.pack("<I", len(data)) + data[8:] + ifd


# ----------------------------------------------------------------------- BMP

HEADERS = (12, 40, 52, 56, 108, 124)


@pytest.mark.parametrize("bpp", [1, 4, 8])
@pytest.mark.parametrize("grey", [False, True])
def test_bmp_palette(bpp, grey):
    rng = np.random.default_rng(bpp + grey)
    n = 1 << bpp
    for h, w in ((1, 1), (3, 5), (16, 9)):
        pal = ([(v, v, v) for v in rng.integers(0, 256, n).tolist()] if grey else
               [tuple(rng.integers(0, 256, 3).tolist()) for _ in range(n)])
        idx = rng.integers(0, n, (h, w))
        for header in HEADERS:
            got = same(encode_bmp_palette(idx, pal, bpp, header=header))
            np.testing.assert_array_equal(got["color"], np.array(pal)[idx][..., ::-1])
            if bpp >= 4 and header != 12:
                same(encode_bmp_palette(idx, pal, bpp, rle=True, header=header))


@pytest.mark.parametrize("header", HEADERS)
def test_bmp_16_24_32(header):
    rng = np.random.default_rng(header)
    for h, w in ((1, 1), (3, 5), (7, 13)):
        p = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        for top_down in ((False, True) if header != 12 else (False,)):
            rows = p if top_down else p[::-1]
            got = same(encode_bmp(bmp_rows([r[:, :3].tobytes() for r in rows]), w, h, 24,
                                  header=header, top_down=top_down))
            np.testing.assert_array_equal(got["color"], p[..., 2::-1])
            same(encode_bmp(bmp_rows([r.tobytes() for r in rows]), w, h, 32, header=header,
                            top_down=top_down))
        if header == 12:
            continue
        for masks in ((0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF, 0xFF00, 0xFF0000, 0),
                      (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000), (0, 0, 0, 0),
                      (0xF800, 0x7E0, 0x1F, 0xFFFF0000)):
            same(encode_bmp(bmp_rows([r.tobytes() for r in p[::-1]]), w, h, 32, 3,
                            header=header, masks=masks))
        v = rng.integers(0, 1 << 16, (h, w)).astype("<u2")
        pixels = bmp_rows([r.tobytes() for r in v[::-1]])
        got = same(encode_bmp(pixels, w, h, 16, header=header))
        t = v.astype(np.int64)
        np.testing.assert_array_equal(
            got["color"], np.stack([(t >> 7) & 0xF8, (t >> 2) & 0xF8, (t << 3) & 0xF8], -1))
        if header == 40:
            for masks in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)):
                same(encode_bmp(pixels, w, h, 16, 3, header=header, masks=masks))
        else:  # cv2 reads 16-bit masks after the header: here, pixel data
            data = encode_bmp(pixels, w, h, 16, 3, header=header, masks=(0xF800, 0x7E0, 0x1F))
            assert bem(data, "color") is None
            refused(data, "16-bit BMP with bit masks")


_RLE_TOKENS = {
    4: {"R1": [1, 0x33], "R2": [2, 0x45], "EOL": [0, 0], "EOB": [0, 1], "D10": [0, 2, 1, 0],
        "D01": [0, 2, 0, 1], "D21": [0, 2, 2, 1], "A3": [0, 3, 0x67, 0x80]},
    8: {"R1": [1, 0x33], "R2": [2, 0x45], "R3": [3, 9], "EOL": [0, 0], "EOB": [0, 1],
        "D10": [0, 2, 1, 0], "D01": [0, 2, 0, 1], "D21": [0, 2, 2, 1],
        "A3": [0, 3, 7, 8, 9, 0]}}


@pytest.mark.parametrize("bpp", [4, 8])
@pytest.mark.parametrize("wh", [(3, 2), (2, 3)])
def test_bmp_rle_escapes(bpp, wh):
    """Every RLE stream of one to three tokens: the port reads what cv2
    reads and refuses what cv2 refuses (RLE4's end of bitmap ends the row
    only, as cv2's does)."""
    w, h = wh
    tokens = _RLE_TOKENS[bpp]
    pal = [(i * 10 % 256, i * 3 % 256, 255 - i * 5 % 256) for i in range(1 << bpp)]
    accepted = 0
    for n in range(1, 4):
        for toks in itertools.product(tokens, repeat=n):
            data = encode_bmp(bytes(sum((tokens[t] for t in toks), [])), w, h, bpp,
                              2 if bpp == 4 else 1, 40, pal)
            for flag in FLAGS:
                want = bem(data, flag)
                if want is None:
                    with pytest.raises(ValueError):
                        imfrombytes(data, flag)
                    continue
                accepted += 1
                np.testing.assert_array_equal(imfrombytes(data, flag), want, err_msg=str(toks))
    assert accepted > 0


def test_bmp_cv2_writer():
    rng = np.random.default_rng(5)
    for shape in ((9, 5, 3), (4, 1, 3), (16, 32, 4), (7, 13), (1, 1)):
        ok, buf = cv2.imencode(".bmp", rng.integers(0, 256, shape).astype(np.uint8))
        assert ok
        same(buf.tobytes())


# ----------------------------------------------------------------- PNG Adam7

PNG_KINDS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


@pytest.mark.parametrize("color", list(PNG_KINDS))
def test_png_adam7(color):
    rng = np.random.default_rng(color)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    for h, w in ((1, 1), (1, 9), (5, 7), (33, 31)):
        for bits in PNG_KINDS[color]:
            s = rng.integers(0, 1 << bits, (h, w, channels))
            pal = rng.integers(0, 256, (1 << bits, 3)) if color == 3 else None
            trns = [None]
            if color == 0:
                trns.append(struct.pack(">H", int(s[0, 0, 0])))
            elif color == 2:
                trns.append(struct.pack(">HHH", *map(int, s[0, 0])))
            elif color == 3:
                trns.append(bytes(rng.integers(0, 256, min(1 << bits, 5)).astype(np.uint8)))
            for t in trns:
                laced = same(encode_png_samples(s, color, bits, True, pal, t))
                flat = same(encode_png_samples(s, color, bits, False, pal, t))
                for flag in FLAGS:
                    np.testing.assert_array_equal(laced[flag], flat[flag])


def test_png_exif_orientation():
    """cv2 applies a PNG's eXIf orientation under color and grayscale."""
    rng = np.random.default_rng(6)
    for orientation in (3, 6, 8):
        exif = (b"MM\0*\0\0\0\x08" + struct.pack(">H", 1)
                + struct.pack(">HHIHH", 0x112, 3, 1, orientation, 0) + b"\0\0\0\0")
        got = same(encode_png_samples(rng.integers(0, 256, (5, 7, 3)), 2, 8,
                                      chunks=[(b"eXIf", exif)]))
        assert got["unchanged"].shape == (5, 7, 3)
