"""PNG, BMP, TIFF and JPEG decoders on zlib and numpy (the card's machine
has no cv2 / PIL), each equal to ``cv2.imdecode`` for the three read
flags bem_tpu uses, in the port's channel order (RGB / RGBA where cv2
gives BGR / BGRA):

- ``"color"`` (IMREAD_COLOR): (H, W, 3) uint8, the EXIF / TIFF
  orientation applied.
- ``"grayscale"`` (IMREAD_GRAYSCALE): (H, W) uint8, the orientation
  applied. Each codec converts as cv2's does: JPEG hands out the Y plane
  (libjpeg's JCS_GRAYSCALE; an RGB JPEG through libjpeg's RGB -> Y, a
  CMYK one through cv2's fixed point), PNG through libpng's rgb-to-gray
  (15-bit coefficients, truncated at 8 bits, rounded at 16), BMP and TIFF
  through cvtColor's 14-bit fixed point (a BMP read through its bit masks
  in float32).
- ``"unchanged"`` (IMREAD_UNCHANGED): the file's own channels and depth
  (2-D grey, RGB, RGBA; uint16 kept), no EXIF orientation (a TIFF's
  Orientation tag still applies, as in cv2).

What is read:
- PNG: colour types 0, 2, 3, 4, 6 at every bit depth the standard allows,
  all five row filters, Adam7 interlace, tRNS (as alpha, ``unchanged``),
  the eXIf orientation.
- BMP: 1- / 4- / 8-bit palette, RLE8 and RLE4 (delta and end-of-line
  escapes; skipped pixels take palette entry 0, as cv2 fills them), 16-bit
  5-5-5 and BI_BITFIELDS 5-6-5 (masks after a 40-byte header), 24-bit,
  32-bit (BI_BITFIELDS masks read from headers of 56 bytes and more),
  bottom-up and top-down, info headers of 12, 40, 52, 56, 108 and 124 bytes.
- TIFF: II and MM, the first IFD, strips or tiles, compression none, LZW,
  Deflate (8 and 32946) and PackBits, predictor 2, planar configuration 1
  and 2, photometric 0 / 1 (1, 8, 16 bits), 2 (8, 16 bits, extra samples
  as alpha) and 3 (1, 4, 8 bits), converted for 8-bit output as libtiff's
  TIFFRGBAImage does (16-bit RGB to round(v * 255 / 65535), 16-bit grey to
  v >> 8, unassociated alpha premultiplied, colormaps >> 8 unless every
  entry is under 256).
- JPEG: ``decode_jpeg`` below.

Anything else raises a ``ValueError`` naming the file and what it is:
among others arithmetic-coded, 12-bit, lossless and hierarchical JPEG, a
progressive JPEG whose scans leave coefficient bits unrefined (libjpeg
would smooth its blocks), JPEG-in-TIFF, CCITT, float and 4-bit grey TIFF
(cv2 refuses the last too), a greyscale read of a colour PNG that carries
gAMA or sRGB (libpng's gamma-corrected conversion). Nothing falls back to
another decoder. ``encode_png`` writes 8-bit RGB.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
FLAGS = ("color", "grayscale", "unchanged")
# colour type -> (samples per pixel, allowed bit depths)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}
_ORIENT = {  # EXIF / TIFF Orientation -> cv2's transform of the decoded image
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: a.swapaxes(0, 1), 6: lambda a: a.swapaxes(0, 1)[:, ::-1],
    7: lambda a: a.swapaxes(0, 1)[::-1, ::-1], 8: lambda a: a.swapaxes(0, 1)[::-1]}


def _check_flag(flag):
    if flag not in FLAGS:
        raise ValueError(f"unknown read flag {flag!r} (one of {FLAGS})")


def _orient(img, orientation):
    return np.ascontiguousarray(_ORIENT[orientation](img)) if orientation in _ORIENT else img


def gray_fixed(rgb) -> np.ndarray:
    """cvtColor's RGB -> grey on 8-bit samples: 14-bit coefficients, rounded."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14).astype(np.uint8)


def _unpack(rows: np.ndarray, n: int, bits: int) -> np.ndarray:
    """(H, row bytes) packed MSB-first samples -> (H, n) integers."""
    if bits == 8:
        return rows[:, :n]
    if bits == 16:
        return rows[:, :2 * n].reshape(rows.shape[0], n, 2).astype(np.uint16) @ np.array(
            [256, 1], np.uint16)
    packed = np.unpackbits(rows, axis=1)[:, :n * bits].reshape(rows.shape[0], n, bits)
    return (packed << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)


# ------------------------------------------------------------------------ PNG


def _chunks(data: bytes, name: str):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"{name}: truncated PNG chunk {ctype!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{name}: bad CRC in PNG chunk {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG ends without IEND")


def _unfilter_average(line: bytes, prev: bytes, bpp: int) -> bytes:
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF
    return bytes(cur)


def _unfilter_paeth(line: bytes, prev: bytes, bpp: int) -> bytes:
    cur = bytearray(line)
    for i in range(len(cur)):
        if i >= bpp:
            a, c = cur[i - bpp], prev[i - bpp]
        else:
            a = c = 0
        b = prev[i]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return bytes(cur)


def _unfilter(rows: np.ndarray, bpp: int, name: str) -> np.ndarray:
    """Undo the per-row filters of (H, 1 + row bytes) scanlines."""
    h, n = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, n), np.uint8)
    prev = np.zeros(n, np.uint8)
    pad = (-n) % bpp
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum over pixels, per byte of a pixel
            ext = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = (np.cumsum(ext, axis=0, dtype=np.int64) & 0xFF).astype(np.uint8).reshape(-1)[:n]
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype == 3:  # Average: sequential along the row
            cur = np.frombuffer(_unfilter_average(line.tobytes(), prev.tobytes(), bpp), np.uint8)
        elif ftype == 4:  # Paeth: sequential along the row
            cur = np.frombuffer(_unfilter_paeth(line.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"{name}: PNG row {y} has unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))


def _png_samples(raw, w, h, channels, depth, interlace, name):
    """The decompressed image data -> (H, W, channels) samples (uint8, or
    uint16 at 16 bits; sub-8-bit values unscaled)."""
    bits = channels * depth
    bpp = max(1, bits // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for y0, x0, dy, dx in passes:
        ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
        if ph <= 0 or pw <= 0:
            continue
        row_bytes = (pw * bits + 7) // 8
        size = ph * (row_bytes + 1)
        if pos + size > len(raw):
            raise ValueError(f"{name}: PNG image data is truncated")
        rows = np.frombuffer(raw, np.uint8, count=size, offset=pos).reshape(ph, row_bytes + 1)
        pos += size
        s = _unpack(_unfilter(rows, bpp, name), pw * channels, depth)
        out[y0::dy, x0::dx] = s.reshape(ph, pw, channels)
    return out


def decode_png(data: bytes, name: str = "<png>", flag: str = "color") -> np.ndarray:
    """PNG bytes -> what cv2.imdecode gives with ``flag``, RGB(A) order."""
    _check_flag(flag)
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    header, palette, trns, idat, gamma, orient = None, None, None, [], False, 1
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"gAMA":
            gamma = gamma or struct.unpack(">I", body[:4])[0] != 100000
        elif ctype == b"sRGB":
            gamma = True
        elif ctype == b"eXIf":
            orient = _exif_orientation(b"Exif\0\0" + body)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, color, comp, filt, interlace = header
    if color not in _PNG_TYPES or depth not in _PNG_TYPES[color][1] or comp or filt or (
            interlace not in (0, 1)):
        raise ValueError(f"{name}: unsupported PNG (colour type {color}, bit depth {depth}, "
                         f"compression {comp}, filter method {filt}, interlace {interlace})")
    channels = _PNG_TYPES[color][0]
    s = _png_samples(zlib.decompress(b"".join(idat)), w, h, channels, depth, interlace, name)
    if color == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        idx = s[..., 0]
        if idx.max() >= len(palette):
            raise ValueError(f"{name}: palette index beyond the PLTE entries")
        rgb = palette[idx]
        if flag == "unchanged":
            if trns is None:
                return rgb
            alpha = np.full(256, 255, np.uint8)
            alpha[:len(trns)] = np.frombuffer(trns[:256], np.uint8)
            return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
        s, depth = rgb, 8
    elif color == 0 and depth < 8:  # grey below 8 bits scales to 0..255
        s = s * np.uint8(255 // (2 ** depth - 1))
        depth = 8
    if flag == "unchanged":
        if color == 0:
            return s[..., 0]
        if color == 4:
            return np.concatenate([np.repeat(s[..., :1], 3, axis=2), s[..., 1:]], axis=-1)
        if color == 2 and trns is not None:
            key = np.array(struct.unpack(">HHH", trns[:6]), np.uint16)
            alpha = np.where((s == key).all(-1), 0, 65535 if depth == 16 else 255)
            return np.concatenate([s, alpha[..., None].astype(s.dtype)], axis=-1)
        return s
    if flag == "grayscale":
        if color in (0, 4):
            out = s[..., 0] >> 8 if depth == 16 else s[..., 0]
        else:
            if gamma:
                raise ValueError(f"{name}: a greyscale read of a colour PNG with gAMA / sRGB "
                                 f"(libpng's gamma-corrected rgb-to-grey is not ported)")
            r, g, b = (s[..., i].astype(np.int64) for i in range(3))
            y = 9797 * r + 19234 * g + 3737 * b  # libpng's coefficients of 0.299, 0.587
            out = ((y + 16384) >> 15) >> 8 if depth == 16 else y >> 15
        return _orient(out.astype(np.uint8), orient)
    s = s >> 8 if depth == 16 else s
    rgb = np.repeat(s[..., :1], 3, axis=2) if color in (0, 4) else s[..., :3]
    return _orient(np.ascontiguousarray(rgb.astype(np.uint8)), orient)


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(
        ">I", zlib.crc32(ctype + body))


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB or (H, W) uint8 grey -> PNG bytes (8-bit RGB or
    grey, filter 0 on every row)."""
    rgb = np.asarray(rgb)
    grey = rgb.ndim == 2
    if rgb.dtype != np.uint8 or not (grey or rgb.ndim == 3 and rgb.shape[2] == 3):
        raise ValueError(f"encode_png: want (H, W, 3) or (H, W) uint8, got {rgb.shape} "
                         f"{rgb.dtype}")
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)], axis=1)
    return (PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0 if grey else 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


# ------------------------------------------------------------------------ BMP
#
# cv2's BmpDecoder: the info header's fields, the palette read after the
# header (clrUsed entries, else 1 << bpp), 16-bit BI_BITFIELDS masks read
# after the header and taken only as exactly 5-5-5 or 5-6-5, 32-bit masks
# honoured from headers of 56 bytes and more (alpha 255 where its mask is
# 0, all-zero colour masks meaning plain BGRA), a 12-byte (OS/2) header or
# a grey palette read as one channel under IMREAD_UNCHANGED.


def _bmp_rle(data, pos, w, h, bpp, name):
    """cv2's RLE8 / RLE4 loops: (h, w) palette indices in stored row order.
    Runs may not pass a row's end; a delta or an end of line fills what it
    skips with index 0; end of bitmap fills the rest with it."""
    out = np.zeros((h, w), np.int64)
    flat = out.reshape(-1)
    n = len(data)
    x = y = 0

    def fill(count, value):
        """FillUniColor: ``count`` pixels from (x, y), wrapping to the next
        row at each row's end."""
        nonlocal x, y
        while True:
            end = min(x + count, w)
            count -= end - x
            if y < h:
                flat[y * w + x:y * w + end] = value
            x = end
            if x >= w:
                x = 0
                y += 1
                if y >= h:
                    break
            if count <= 0:
                break

    def get(k):
        nonlocal pos
        if pos + k > n:
            raise ValueError(f"{name}: the BMP's RLE data ends before its end-of-bitmap")
        b = data[pos:pos + k]
        pos += k
        return b

    line_end_flag = 0
    while True:
        length, code = get(2)
        if length:  # encoded run
            if x + length > w:
                raise ValueError(f"{name}: a BMP RLE run passes its row's end")
            if bpp == 8:
                prev_y = y
                fill(length, code)
                line_end_flag = y - prev_y
                if y >= h:
                    break
            else:
                pair = np.array([code >> 4, code & 15])
                flat[y * w + x:y * w + x + length] = pair[np.arange(length) & 1]
                x += length
        elif code > 2:  # absolute run
            if x + code > w:
                raise ValueError(f"{name}: a BMP RLE run passes its row's end")
            if bpp == 8:
                raw = np.frombuffer(get((code + 1) & ~1), np.uint8)[:code]
            else:
                b = np.frombuffer(get((((code + 1) >> 1) + 1) & ~1), np.uint8)
                raw = np.stack([b >> 4, b & 15], -1).reshape(-1)[:code]
            prev_y = y
            flat[y * w + x:y * w + x + code] = raw
            x += code
            line_end_flag = y - prev_y
        else:  # 0: end of line, 1: end of bitmap, 2: delta
            x_shift, y_shift = w - x, h - y
            if bpp == 4 or code or not line_end_flag or x_shift < w:
                if code == 2:
                    x_shift, y_shift = get(2)
                # RLE8 moves down y_shift rows for a delta or the end of the
                # bitmap; cv2's RLE4 drops the rows (its end of bitmap ends
                # the row, a delta moves right only)
                count = x_shift + (y_shift * w if code and bpp == 8 else 0)
                if bpp == 8 and y >= h:
                    break
                fill(count, 0)
                if y >= h:
                    break
            line_end_flag = 0
            if y >= h:
                break
    return out


def decode_bmp(data: bytes, name: str = "<bmp>", flag: str = "color") -> np.ndarray:
    """BMP bytes -> what cv2.imdecode gives with ``flag``, RGB(A) order."""
    _check_flag(flag)
    if data[:2] != b"BM" or len(data) < 26:
        raise ValueError(f"{name}: not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (size,) = struct.unpack("<I", data[14:18])
    masks = None
    if size >= 36:
        if len(data) < 14 + size:
            raise ValueError(f"{name}: truncated BMP header")
        w, h, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
        (clr_used,) = struct.unpack("<I", data[46:50])
        ok = w > 0 and h != 0 and (
            (bpp in (1, 4, 8, 24, 32) and comp == 0) or (bpp in (16, 32) and comp in (0, 3))
            or (bpp == 4 and comp == 2) or (bpp == 8 and comp == 1))
        color = True
        pal_at = 14 + size
        if ok and bpp <= 8:
            if clr_used > 256:
                raise ValueError(f"{name}: BMP palette of {clr_used} entries")
            count = clr_used or 1 << bpp
            pal = np.zeros((256, 4), np.uint8)
            raw = np.frombuffer(data[pal_at:pal_at + 4 * count], np.uint8)
            pal[:len(raw) // 4] = raw[:len(raw) // 4 * 4].reshape(-1, 4)
            head = pal[:1 << bpp]
            color = bool((head[:, 0] != head[:, 1]).any() or (head[:, 0] != head[:, 2]).any())
            pal = pal[:, :3]
        elif ok and bpp == 16 and comp == 3:
            m = struct.unpack("<III", data[pal_at:pal_at + 12].ljust(12, b"\0"))
            if m == (0x7C00, 0x3E0, 0x1F):
                comp = 0  # 5-5-5, as BI_RGB
            elif m != (0xF800, 0x7E0, 0x1F):
                raise ValueError(f"{name}: a 16-bit BMP with bit masks {tuple(map(hex, m))} "
                                 f"(5-5-5 and 5-6-5 are read)")
        elif ok and bpp == 32 and comp == 3 and size >= 56:
            masks = struct.unpack("<IIII", data[54:70])
            if not any(masks[:3]):
                masks = None
            elif not all(masks[:3]):
                raise ValueError(f"{name}: a 32-bit BMP with a zero colour mask")
        if not ok:
            raise ValueError(f"{name}: unsupported BMP ({bpp} bits, compression {comp}, "
                             f"header {size} bytes)")
    elif size == 12:
        w, h, _, bpp = struct.unpack("<HHHH", data[18:26])
        comp, color = 0, False
        if not (w > 0 and h != 0 and bpp in (1, 4, 8, 24, 32)):
            raise ValueError(f"{name}: unsupported OS/2 BMP ({bpp} bits)")
        if bpp <= 8:
            pal = np.zeros((256, 3), np.uint8)
            raw = np.frombuffer(data[26:26 + 3 * (1 << bpp)], np.uint8)
            pal[:len(raw) // 3] = raw[:len(raw) // 3 * 3].reshape(-1, 3)
    else:
        raise ValueError(f"{name}: a BMP info header of {size} bytes")
    bottom_up = h > 0
    h = abs(h)
    if bpp <= 8 and comp in (1, 2):
        px = _bmp_rle(data, offset, w, h, bpp, name)
    else:
        pitch = ((w * bpp + 7) // 8 + 3) & ~3
        if offset + pitch * h > len(data):
            raise ValueError(f"{name}: BMP pixel data is truncated")
        rows = np.frombuffer(data, np.uint8, count=pitch * h, offset=offset).reshape(h, pitch)
        if bpp <= 8:
            px = _unpack(rows, w, bpp)
        elif bpp == 16:
            px = rows[:, :2 * w].reshape(h, w, 2).astype(np.int64) @ np.array([1, 256])
        else:
            px = rows[:, :w * bpp // 8].reshape(h, w, bpp // 8)
    if bottom_up:
        px = px[::-1]
    # px -> BGR(A) samples and the grey cv2 makes of them
    alpha = None
    if bpp <= 8:
        if flag == "grayscale" or (flag == "unchanged" and not color):
            return gray_fixed(pal[:, ::-1])[px]
        return np.ascontiguousarray(pal[px][..., ::-1])
    if bpp == 16:
        t = px
        if comp == 3:  # 5-6-5
            bgr = np.stack([(t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8], -1)
        else:
            bgr = np.stack([(t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8], -1)
        bgr = bgr.astype(np.uint8)
    elif masks is not None:  # 32-bit through its masks, in float32
        v = px.astype(np.int64) @ np.array([1, 256, 65536, 16777216], np.int64)

        def field(m):
            shift = (m & -m).bit_length() - 1
            top = m >> shift
            x = ((v & m) >> shift).astype(np.float32)
            return np.floor(x * np.float32(255.0 / top)).astype(np.uint8)

        r, g, b = field(masks[0]), field(masks[1]), field(masks[2])
        alpha = field(masks[3]) if masks[3] else np.full(v.shape, 255, np.uint8)
        if flag == "grayscale":
            f = (r.astype(np.float32) * np.float32(0.299) + g.astype(np.float32) * np.float32(0.587)
                 + b.astype(np.float32) * np.float32(0.114))
            return np.floor(f).astype(np.uint8)
        bgr = np.stack([b, g, r], -1)
    else:
        bgr = px[..., :3]
        if bpp == 32 and comp == 3:
            alpha = px[..., 3]
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    if flag == "grayscale" or (flag == "unchanged" and not color):
        return gray_fixed(rgb)
    if flag == "unchanged" and alpha is not None:
        return np.concatenate([rgb, alpha[..., None]], axis=-1)
    return rgb


# ----------------------------------------------------------------------- TIFF

_TIFF_TYPES = {1: "B", 3: "H", 4: "I"}
_TIFF_COMPRESSION = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                     5: "LZW", 6: "old-style JPEG", 7: "JPEG", 8: "Deflate",
                     32773: "PackBits", 32946: "Deflate", 34712: "JPEG 2000",
                     34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}


def _lzw_decode(data: bytes, expect: int, name: str) -> bytes:
    """TIFF LZW: MSB-first codes of 9-12 bits, widened one code early."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        raise ValueError(f"{name}: old-style (LSB-first) TIFF LZW")
    b = np.frombuffer(data + b"\0\0\0", np.uint8).astype(np.int64)
    win = ((b[:-2] << 16) | (b[1:-1] << 8) | b[2:]).tolist()
    limit = len(data) * 8
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    append = table.append
    parts = []
    nbits, p, prev, size, grow = 9, 0, None, 0, 511
    while p + nbits <= limit and size < expect:
        code = (win[p >> 3] >> (24 - (p & 7) - nbits)) & ((1 << nbits) - 1)
        p += nbits
        if code == 257:
            break
        if code == 256:
            del table[258:]
            nbits, prev, grow = 9, None, 511
            continue
        n = len(table)
        if code < n:
            entry = table[code]
            if prev is not None:
                append(prev + entry[:1])
                n += 1
        elif code == n and prev is not None:
            entry = prev + prev[:1]
            append(entry)
            n += 1
        else:
            raise ValueError(f"{name}: corrupt TIFF LZW data")
        if prev is None and code > 255:
            raise ValueError(f"{name}: corrupt TIFF LZW data")
        parts.append(entry)
        size += len(entry)
        prev = entry
        if n >= grow and nbits < 12:
            nbits += 1
            grow = (1 << nbits) - 1
    return b"".join(parts)


def _packbits_decode(data: bytes, expect: int, name: str) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expect:
        c = data[i]
        i += 1
        if c < 128:
            out += data[i:i + c + 1]
            i += c + 1
        elif c > 128:
            out += data[i:i + 1] * (257 - c)
            i += 1
    return bytes(out)


def _tiff_ifd(data, name):
    e = {b"II": "<", b"MM": ">"}.get(data[:2])
    if e is None or len(data) < 8:
        raise ValueError(f"{name}: not a TIFF file")
    (magic, at) = struct.unpack(e + "HI", data[2:8])
    if magic != 42:
        raise ValueError(f"{name}: a BigTIFF or unknown TIFF (magic {magic})")
    if at + 2 > len(data):
        raise ValueError(f"{name}: truncated TIFF directory")
    (n,) = struct.unpack(e + "H", data[at:at + 2])
    tags = {}
    for i in range(n):
        tag, typ, count, value = struct.unpack(e + "HHI4s", data[at + 2 + 12 * i:at + 14 + 12 * i])
        if typ not in _TIFF_TYPES:
            continue
        fmt = _TIFF_TYPES[typ]
        size = struct.calcsize(fmt) * count
        body = value if size <= 4 else data[struct.unpack(e + "I", value)[0]:][:size]
        if len(body) < size:
            raise ValueError(f"{name}: truncated TIFF tag {tag}")
        tags[tag] = list(struct.unpack(e + fmt * count, body[:size]))
    return e, tags


def _tiff_samples(data, e, tags, name):
    """The first IFD's samples, (H, W, spp) in the file's bit depth (uint8
    or uint16), every strip / tile decompressed and un-predicted."""
    w, h = tags[256][0], tags[257][0]
    spp = tags.get(277, [1])[0]
    bits = tags.get(258, [1])
    if len(set(bits)) != 1:
        raise ValueError(f"{name}: a TIFF with unequal bits per sample {bits}")
    bits = bits[0]
    comp = tags.get(259, [1])[0]
    planar = tags.get(284, [1])[0] if spp > 1 else 1
    predictor = tags.get(317, [1])[0]
    if comp not in (1, 5, 8, 32773, 32946):
        raise ValueError(f"{name}: a {_TIFF_COMPRESSION.get(comp, f'compression {comp}')} "
                         f"TIFF (none, LZW, Deflate and PackBits are read)")
    if tags.get(339, [1])[0] != 1:
        raise ValueError(f"{name}: a TIFF of float or signed samples (sample format "
                         f"{tags[339][0]})")
    if tags.get(266, [1])[0] != 1:
        raise ValueError(f"{name}: a TIFF with fill order {tags[266][0]}")
    if comp in (5, 8, 32946) and predictor == 2 and bits not in (8, 16):
        raise ValueError(f"{name}: TIFF predictor 2 on {bits}-bit samples")
    if comp in (5, 8, 32946) and predictor not in (1, 2):
        raise ValueError(f"{name}: TIFF predictor {predictor}")
    if 322 in tags:
        if comp == 1:
            raise ValueError(f"{name}: an uncompressed tiled TIFF (cv2's libtiff refuses its "
                             f"tile byte counts)")
        tw, th = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags[325]
        boxes = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        rps = min(tags.get(278, [h])[0], h) or h
        tw, th = w, rps
        offsets, counts = tags[273], tags.get(279)
        boxes = [(y, 0) for y in range(0, h, rps)]
    nplanes = spp if planar == 2 else 1
    per = spp // nplanes
    if len(offsets) < len(boxes) * nplanes:
        raise ValueError(f"{name}: a TIFF with {len(offsets)} strips / tiles for "
                         f"{len(boxes) * nplanes}")
    row_bytes = (tw * per * bits + 7) // 8
    out = np.zeros((h, w, spp), np.uint16 if bits == 16 else np.uint8)
    for i, (y, x) in enumerate(boxes * nplanes):
        plane = i // len(boxes)
        rows = th if 322 in tags else min(th, h - y)
        expect = row_bytes * rows
        off = offsets[i]
        raw = data[off:off + counts[i]] if counts else data[off:off + expect]
        if comp == 5:
            raw = _lzw_decode(raw, expect, name)
        elif comp in (8, 32946):
            try:
                raw = zlib.decompressobj().decompress(raw, expect)
            except zlib.error as err:
                raise ValueError(f"{name}: corrupt TIFF Deflate data ({err})") from None
        elif comp == 32773:
            raw = _packbits_decode(raw, expect, name)
        if len(raw) < expect:
            raise ValueError(f"{name}: TIFF strip / tile {i} is truncated")
        block = np.frombuffer(raw, np.uint8, count=expect).reshape(rows, row_bytes)
        if bits == 16:
            s = block.view(e + "u2").reshape(rows, tw, per).astype(np.uint16)
        else:
            s = _unpack(block, tw * per, bits).reshape(rows, tw, per)
        if comp in (5, 8, 32946) and predictor == 2:
            mod = np.uint16 if bits == 16 else np.uint8
            s = np.cumsum(s, axis=1, dtype=np.int64).astype(mod)
        part = s[:min(rows, h - y), :min(tw, w - x)]
        out[y:y + part.shape[0], x:x + part.shape[1], plane * per:(plane + 1) * per] = part
    return out, bits, planar


def decode_tiff(data: bytes, name: str = "<tiff>", flag: str = "color") -> np.ndarray:
    """TIFF bytes (the first IFD) -> what cv2.imdecode gives with ``flag``,
    RGB(A) order."""
    _check_flag(flag)
    e, tags = _tiff_ifd(data, name)
    photometric = tags.get(262, [None])[0]
    spp = tags.get(277, [1])[0]
    nbits = tags.get(258, [1])[0]
    kinds = {0: (1, 8, 16), 1: (1, 8, 16), 2: (8, 16), 3: (1, 4, 8)}
    # samples past the colour channels without an ExtraSamples tag: libtiff
    # takes them as unspecified extra samples
    extra = tags.get(338) or [0] * max(0, spp - (3 if photometric == 2 else 1))
    colour_ch = spp - len(extra)
    if photometric not in kinds or nbits not in kinds[photometric]:
        raise ValueError(f"{name}: a TIFF of photometric {photometric} at {nbits} bits (grey 1 /"
                         f" 8 / 16, RGB 8 / 16 and palette 1 / 4 / 8 bits are read)")
    if colour_ch != (3 if photometric == 2 else 1) or spp > 4:
        raise ValueError(f"{name}: a TIFF of photometric {photometric} with {spp} samples and "
                         f"{len(extra)} extra")
    if photometric in (0, 1) and 322 in tags and (spp == 2 or (nbits == 16 and flag != "unchanged")):
        raise ValueError(f"{name}: a tiled {nbits}-bit grey{' + alpha' if spp == 2 else ''} TIFF "
                         f"(cv2's libtiff misreads its partial tiles)")
    s, bits, planar = _tiff_samples(data, e, tags, name)
    orient = tags.get(274, [1])[0]
    if flag == "unchanged" and bits == 16:
        if planar == 2:
            raise ValueError(f"{name}: a 16-bit planar TIFF read unchanged (cv2 misreads it)")
        if spp == 2:
            raise ValueError(f"{name}: a 16-bit grey + alpha TIFF read unchanged")
        return _orient(s[..., 0] if spp == 1 else s, orient)
    # libtiff's TIFFRGBAImage: the RGBA raster cv2 reads 8-bit output from
    alpha = None
    if photometric in (0, 1) and planar == 2:
        # libtiff's separate-planes path: the grey as stored (no
        # min-is-white inversion), premultiplied by unassociated alpha
        if bits != 8:
            raise ValueError(f"{name}: a {bits}-bit grey + alpha TIFF in separate planes")
        g = s[..., 0].astype(np.int64)
        if extra and extra[0] == 2:
            g = (g * s[..., 1] + 127) // 255
        rgb = np.repeat(g.astype(np.uint8)[..., None], 3, axis=2)
    elif photometric in (0, 1):
        g = s[..., 0] >> 8 if bits == 16 else s[..., 0].astype(np.int64) * (255 // (2 ** bits - 1))
        g = (255 - g if photometric == 0 else g).astype(np.uint8)
        rgb = np.repeat(g[..., None], 3, axis=2)
    elif photometric == 3:
        cmap = np.asarray(tags.get(320, []), np.int64)
        if len(cmap) != 3 << bits:
            raise ValueError(f"{name}: a palette TIFF without its colormap")
        cmap = cmap.reshape(3, 1 << bits)
        if cmap.max() >= 256:  # a 16-bit colormap, else libtiff assumes an 8-bit one
            cmap = cmap >> 8
        rgb = cmap.T.astype(np.uint8)[s[..., 0]]
    else:
        if bits == 16:
            rgb = ((s.astype(np.int64) * 255 + 32767) // 65535).astype(np.uint8)
        else:
            rgb = s
        if spp == 4:
            alpha = rgb[..., 3]
            if extra and extra[0] == 2:  # unassociated alpha: premultiplied
                rgb = (rgb[..., :3].astype(np.int64) * alpha[..., None] + 127) // 255
        rgb = np.ascontiguousarray(rgb[..., :3]).astype(np.uint8)
    if flag == "grayscale" or (flag == "unchanged" and (photometric in (0, 1) or (
            photometric == 3 and bits == 1))):
        return _orient(gray_fixed(rgb), orient)
    if flag == "unchanged" and alpha is not None:
        return _orient(np.concatenate([rgb, alpha[..., None]], axis=-1), orient)
    return _orient(rgb, orient)


# ----------------------------------------------------------------------- JPEG
#
# Baseline, extended-sequential and progressive Huffman JPEG (SOF0 / SOF1 /
# SOF2, 8-bit), one, three or four components, any sampling factors,
# restart intervals, and the EXIF Orientation tag, decoded as
# cv2.imdecode decodes them with libjpeg-turbo's defaults: the
# ``jidctint.c`` integer IDCT, "fancy" upsampling (``jdsample.c``) and the
# integer colour tables of ``jdcolor.c``. All three are integer arithmetic,
# so the result is exact. A progressive file's scans fill a coefficient
# buffer as ``jdphuff.c`` does (DC first and refine, AC first with EOB runs,
# AC refine with correction bits); libjpeg smooths the blocks of a file
# whose scans leave any of the first ten coefficients unrefined
# (``jdcoefct.c``), so such a file raises. Four components are Adobe CMYK
# (transform 0, stored inverted) or YCCK (transform 2), turned into RGB by
# cv2's own CMYK -> BGR. The Huffman decoding is a Python loop over a
# 16-bit lookup table; the IDCT, the upsampling and the colour conversion
# are numpy over all blocks.

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
    44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# libjpeg's natural order carries 16 extra entries at 63, so a corrupt run
# past the block's end lands on its last coefficient
_NATURAL = _ZIGZAG.tolist() + [63] * 16
_JPEG_UNSUPPORTED = {
    0xC3: "lossless", 0xC5: "hierarchical (differential sequential)",
    0xC6: "hierarchical (differential progressive)", 0xC7: "hierarchical (differential lossless)",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCC: "arithmetic-coded",
    0xCD: "arithmetic-coded hierarchical", 0xCE: "arithmetic-coded hierarchical",
    0xCF: "arithmetic-coded hierarchical"}
_SMOOTHED = 10  # libjpeg-turbo's SAVED_COEFS: block smoothing looks at these
_M32 = 0xFFFFFFFF


def _jpeg_fail(name, what):
    raise ValueError(f"{name}: {what} (baseline, extended-sequential and progressive Huffman "
                     f"JPEG, 8-bit, 1, 3 or 4 components, are supported)")


def _huffman_lut(counts, symbols, name):
    """A 16-bit lookup: the next 16 bits -> (code length << 8) | symbol, 0 for
    no code."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                _jpeg_fail(name, "a bad Huffman table")
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    return lut.tolist()


def _exif_orientation(payload: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 in an APP1 Exif payload, 1 if absent."""
    tiff = payload[6:]
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (n,) = struct.unpack(e + "H", tiff[ifd:ifd + 2])
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        tag, typ, _ = struct.unpack(e + "HHI", tiff[at:at + 8])
        if tag == 0x0112:
            if typ == 3:
                return struct.unpack(e + "H", tiff[at + 8:at + 10])[0]
            return 1
    return 1


def _scan_segments(data: bytes, pos: int):
    """The entropy-coded data from ``pos``: its restart-interval segments (the
    stuffed zero bytes removed) and the offset of the marker that ends it."""
    arr = np.frombuffer(data, np.uint8, offset=pos)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    ends = ff[(nxt != 0) & ~rst]
    end = int(ends[0]) if len(ends) else len(arr)
    cuts = ff[rst & (ff < end)]
    segs, start = [], 0
    for c in list(cuts) + [end]:
        seg = arr[start:c]
        stuffed = np.flatnonzero(seg[:-1] == 0xFF) + 1
        segs.append(np.delete(seg, stuffed[seg[stuffed] == 0]) if len(stuffed) else seg)
        start = int(c) + 2
    return segs, pos + end


def _windows(seg: np.ndarray):
    """Per byte offset i, the 40 bits from byte i (zeros past the end)."""
    b = np.concatenate([seg, np.zeros(8, np.uint8)]).astype(np.int64)
    n = len(seg) + 4
    w = np.zeros(n, np.int64)
    for j in range(5):
        w = (w << 8) | b[j:j + n]
    return w.tolist()


class _Bits:
    """A restart interval's bits: ``win`` (40-bit windows per byte), the
    position ``p`` and its limit; ``next`` moves to the next interval."""

    def __init__(self, segs, name):
        self.segs, self.i, self.name = segs, 0, name
        self.load()

    def load(self):
        seg = self.segs[self.i]
        self.win, self.p, self.limit = _windows(seg), 0, len(seg) * 8

    def next(self):
        self.i += 1
        if self.i >= len(self.segs):
            _jpeg_fail(self.name, "a missing restart marker")
        self.load()

    def check(self):
        if self.p > self.limit + 64:
            _jpeg_fail(self.name, "truncated entropy-coded data")


def _decode_scan(segs, blocks, ri_blocks, coefs, luts, name):
    """Huffman-decode a sequential scan's blocks: ``blocks`` is a list of
    (component, flat offset into the component's list in ``coefs``), in scan
    order; the DC predictions reset and a new segment starts every
    ``ri_blocks`` blocks (0: no restarts)."""
    natural = _NATURAL
    mask32 = _M32
    seg_i, win, p, limit = 0, _windows(segs[0]), 0, len(segs[0]) * 8
    pred = {}
    for bi, (c, base) in enumerate(blocks):
        if ri_blocks and bi and bi % ri_blocks == 0:
            seg_i += 1
            if seg_i >= len(segs):
                _jpeg_fail(name, "a missing restart marker")
            win, p, limit, pred = _windows(segs[seg_i]), 0, len(segs[seg_i]) * 8, {}
        dc, ac = luts[c]
        coef = coefs[c]
        w = ((win[p >> 3] << (p & 7)) >> 8) & mask32
        e = dc[w >> 16]
        n = e >> 8
        if not n:
            _jpeg_fail(name, "a bad Huffman code")
        s = e & 255
        v = 0
        if s:
            v = (w >> (32 - n - s)) & ((1 << s) - 1)
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
        p += n + s
        v += pred.get(c, 0)
        pred[c] = v
        coef[base] = v
        k = 1
        while k < 64:
            w = ((win[p >> 3] << (p & 7)) >> 8) & mask32
            e = ac[w >> 16]
            n = e >> 8
            if not n:
                _jpeg_fail(name, "a bad Huffman code")
            s = e & 15
            r = (e >> 4) & 15
            if s:
                k += r
                v = (w >> (32 - n - s)) & ((1 << s) - 1)
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                p += n + s
                coef[base + natural[k]] = v
                k += 1
            else:
                p += n
                if r != 15:
                    break
                k += 16
        if p > limit + 64:
            _jpeg_fail(name, "truncated entropy-coded data")


def _decode_dc_prog(segs, blocks, ri_blocks, coefs, luts, al, refine, name):
    """A progressive DC scan (jdphuff.c decode_mcu_DC_first / _refine)."""
    bits = _Bits(segs, name)
    pred = {}
    p1 = 1 << al
    for bi, (c, base) in enumerate(blocks):
        if ri_blocks and bi and bi % ri_blocks == 0:
            bits.next()
            pred = {}
        win, p = bits.win, bits.p
        coef = coefs[c]
        if refine:
            if (win[p >> 3] >> (39 - (p & 7))) & 1:
                coef[base] |= p1
            bits.p = p + 1
            continue
        w = ((win[p >> 3] << (p & 7)) >> 8) & _M32
        e = luts[c][0][w >> 16]
        n = e >> 8
        if not n:
            _jpeg_fail(name, "a bad Huffman code")
        s = e & 255
        v = 0
        if s:
            v = (w >> (32 - n - s)) & ((1 << s) - 1)
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
        bits.p = p + n + s
        v += pred.get(c, 0)
        pred[c] = v
        coef[base] = v << al
    bits.check()


def _decode_ac_first(segs, offs, ri_blocks, coef, ac, ss, se, al, name):
    """A progressive AC first scan of one component (decode_mcu_AC_first):
    spectral band ss..se, values scaled by 2^al, EOB runs over blocks."""
    natural = _NATURAL
    bits = _Bits(segs, name)
    win, p = bits.win, 0
    eobrun = 0
    for bi, base in enumerate(offs):
        if ri_blocks and bi and bi % ri_blocks == 0:
            bits.p = p
            bits.next()
            win, p, eobrun = bits.win, 0, 0
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            w = ((win[p >> 3] << (p & 7)) >> 8) & _M32
            e = ac[w >> 16]
            n = e >> 8
            if not n:
                _jpeg_fail(name, "a bad Huffman code")
            s = e & 15
            r = (e >> 4) & 15
            if s:
                k += r
                v = (w >> (32 - n - s)) & ((1 << s) - 1)
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                p += n + s
                coef[base + natural[k]] = v << al
                k += 1
            else:
                p += n
                if r == 15:
                    k += 16
                    continue
                eobrun = 1 << r
                if r:
                    w = ((win[p >> 3] << (p & 7)) >> 8) & _M32
                    eobrun += w >> (32 - r)
                    p += r
                eobrun -= 1
                break
    bits.p = p
    bits.check()


def _decode_ac_refine(segs, offs, ri_blocks, coef, ac, ss, se, al, name):
    """A progressive AC refinement scan of one component
    (decode_mcu_AC_refine): correction bits for the coefficients already
    nonzero, new coefficients of +-2^al, EOB runs."""
    natural = _NATURAL
    bits = _Bits(segs, name)
    win, p = bits.win, 0
    eobrun = 0
    p1, m1 = 1 << al, -1 << al
    for bi, base in enumerate(offs):
        if ri_blocks and bi and bi % ri_blocks == 0:
            bits.p = p
            bits.next()
            win, p, eobrun = bits.win, 0, 0
        k = ss
        if not eobrun:
            while k <= se:
                w = ((win[p >> 3] << (p & 7)) >> 8) & _M32
                e = ac[w >> 16]
                n = e >> 8
                if not n:
                    _jpeg_fail(name, "a bad Huffman code")
                s = e & 15
                r = (e >> 4) & 15
                p += n
                if s:
                    s = p1 if (win[p >> 3] >> (39 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        w = ((win[p >> 3] << (p & 7)) >> 8) & _M32
                        eobrun += w >> (32 - r)
                        p += r
                    break
                while k <= se:  # past the nonzero coefficients and r zero ones
                    pos = base + natural[k]
                    c = coef[pos]
                    if c:
                        if (win[p >> 3] >> (39 - (p & 7))) & 1 and not c & p1:
                            coef[pos] = c + p1 if c >= 0 else c + m1
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    coef[base + natural[k]] = s
                k += 1
        if eobrun:
            while k <= se:  # the band's rest: correction bits only
                pos = base + natural[k]
                c = coef[pos]
                if c:
                    if (win[p >> 3] >> (39 - (p & 7))) & 1 and not c & p1:
                        coef[pos] = c + p1 if c >= 0 else c + m1
                    p += 1
                k += 1
            eobrun -= 1
    bits.p = p
    bits.check()


def _idct_1d(x, k):
    """jidctint.c's 1-D pass on x[..., 0:8] along axis k (int64): the eight
    sums before the descale, in output order."""
    c = [np.take(x, i, axis=k) for i in range(8)]
    z1 = (c[2] + c[6]) * 4433
    tmp2 = z1 + c[6] * -15137
    tmp3 = z1 + c[2] * 6270
    tmp0 = (c[0] + c[4]) << 13
    tmp1 = (c[0] - c[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * 9633
    o0, o1, o2, o3 = o0 * 2446, o1 * 16819, o2 * 25172, o3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    return np.stack([t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                     t13 - o0, t12 - o1, t11 - o2, t10 - o3], axis=k)


def _idct_range_table():
    """jdmaster.c's post-IDCT range limit, indexed by (value & 1023)."""
    v = np.arange(1024)
    v = np.where(v < 512, v, v - 1024)
    return np.clip(v + 128, 0, 255).astype(np.uint8)


def _idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(..., 8, 8) quantized coefficients (natural order) -> uint8 samples."""
    x = coef.astype(np.int64) * q.astype(np.int64)
    ws = (_idct_1d(x, -2) + (1 << 10)) >> 11       # columns: CONST_BITS - PASS1_BITS
    out = (_idct_1d(ws, -1) + (1 << 17)) >> 18     # rows: CONST_BITS + PASS1_BITS + 3
    return _idct_range_table()[out & 1023]


def _upsample(plane: np.ndarray, hf: int, vf: int) -> np.ndarray:
    """jdsample.c's upsampling of one component by (hf, vf) with fancy
    upsampling on: h2v1 / h2v2 triangle filters where the component is wider
    than 2 samples, h1v2's, else pixel replication."""
    p = plane.astype(np.int64)
    w = p.shape[1]
    if (hf, vf) == (1, 1):
        return plane
    if (hf, vf) == (2, 1) and w > 2:
        e = np.pad(p, ((0, 0), (1, 1)), mode="edge")
        out = np.empty((p.shape[0], 2 * w), np.int64)
        out[:, 0::2] = (3 * p + e[:, :-2] + 1) >> 2
        out[:, 1::2] = (3 * p + e[:, 2:] + 2) >> 2
        return out.astype(np.uint8)
    if (hf, vf) == (1, 2):
        e = np.pad(p, ((1, 1), (0, 0)), mode="edge")
        out = np.empty((2 * p.shape[0], w), np.int64)
        out[0::2] = (3 * p + e[:-2] + 1) >> 2
        out[1::2] = (3 * p + e[2:] + 2) >> 2
        return out.astype(np.uint8)
    if (hf, vf) == (2, 2) and w > 2:
        e = np.pad(p, ((1, 1), (0, 0)), mode="edge")
        out = np.empty((2 * p.shape[0], 2 * w), np.int64)
        for v, near in ((0, e[:-2]), (1, e[2:])):
            col = 3 * p + near                       # the vertical triangle
            ce = np.pad(col, ((0, 0), (1, 1)), mode="edge")
            out[v::2, 0::2] = (3 * col + ce[:, :-2] + 8) >> 4
            out[v::2, 1::2] = (3 * col + ce[:, 2:] + 7) >> 4
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, vf, axis=0), hf, axis=1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's integer YCbCr -> RGB."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (int(1.40200 * 65536 + 0.5) * x + one_half) >> 16
    cb_b = (int(1.77200 * 65536 + 0.5) * x + one_half) >> 16
    cr_g = -int(0.71414 * 65536 + 0.5) * x
    cb_g = -int(0.34414 * 65536 + 0.5) * x + one_half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _cmyk_to_rgb(c, m, y, k) -> np.ndarray:
    """cv2's CMYK -> BGR on libjpeg's (Adobe, inverted) CMYK, in RGB order."""
    k = k.astype(np.int64)
    conv = [k - (((255 - v.astype(np.int64)) * k) >> 8) for v in (c, m, y)]
    return np.stack(conv, axis=-1).astype(np.uint8)


def _jpeg_space(frame, jfif, adobe):
    """libjpeg's guess of the stored colour space (jdapimin.c)."""
    nf = len(frame["comps"])
    if nf == 1:
        return "grey"
    if nf == 3:
        ids = [c[0] for c in frame["comps"]]
        if jfif:
            return "ycc"
        if adobe is not None:
            return "rgb" if adobe == 0 else "ycc"
        return "rgb" if ids == [82, 71, 66] else "ycc"
    return "cmyk" if adobe in (None, 0) else "ycck"


def _scan_blocks(frame, planes, sc):
    """The (component, offset) of a scan's blocks in order: a
    non-interleaved scan walks its component's own block grid, ceil(cw / 8)
    x ceil(ch / 8); an interleaved one the MCUs. Also the blocks an MCU."""
    if len(sc) == 1:
        ci = sc[0][0]
        pl = planes[ci]
        nbx, nby = -(-pl["cw"] // 8), -(-pl["ch"] // 8)
        r, c = np.mgrid[0:nby, 0:nbx]
        return [(ci, o) for o in ((r * pl["bw"] + c) * 64).ravel().tolist()], 1
    unit = []  # (component, row, col) of one MCU's blocks
    for ci, _, _ in sc:
        _, hs, vs, _ = frame["comps"][ci]
        unit += [(ci, v, u, hs, vs) for v in range(vs) for u in range(hs)]
    blocks = []
    for my_ in range(frame["my"]):
        for mx_ in range(frame["mx"]):
            for ci, v, u, hs, vs in unit:
                blocks.append((ci, ((my_ * vs + v) * planes[ci]["bw"] + mx_ * hs + u) * 64))
    return blocks, len(unit)


def decode_jpeg(data: bytes, name: str = "<jpeg>", flag: str = "color") -> np.ndarray:
    """Baseline / extended-sequential / progressive Huffman JPEG bytes ->
    what cv2.imdecode gives with ``flag``, RGB order, the EXIF Orientation
    applied (not under ``unchanged``). Other kinds raise a ValueError
    naming the file."""
    _check_flag(flag)
    if data[:2] != b"\xff\xd8":
        _jpeg_fail(name, "not a JPEG file")
    qt, huff, frame = {}, {}, None
    restart, jfif, adobe, orient = 0, False, None, 1
    planes, progressive = None, False
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1  # garbage between markers, as libjpeg skips it
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if pos + 2 > len(data):
            _jpeg_fail(name, "truncated markers")
        (ln,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + ln]
        pos += ln
        if m in _JPEG_UNSUPPORTED:
            _jpeg_fail(name, f"a {_JPEG_UNSUPPORTED[m]} JPEG")
        if m in (0xC0, 0xC1, 0xC2):
            progressive = m == 0xC2
            prec, hh, ww, nf = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                _jpeg_fail(name, f"a {prec}-bit JPEG")
            if hh == 0 or ww == 0:
                _jpeg_fail(name, "a JPEG without its size (DNL)")
            comps = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                     for i in range(nf)]
            if nf not in (1, 3, 4):
                _jpeg_fail(name, f"a {nf}-component JPEG")
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            if any(hmax % c[1] or vmax % c[2] for c in comps):
                _jpeg_fail(name, "fractional sampling factors")
            mx, my = -(-ww // (8 * hmax)), -(-hh // (8 * vmax))
            frame = dict(h=hh, w=ww, comps=comps, hmax=hmax, vmax=vmax, mx=mx, my=my)
            # per component: its block grid (the MCU grid's), its coefficient
            # list and, progressive, the Al its coefficients are known to
            planes = [dict(bw=mx * c[1], bh=my * c[2],
                           cw=-(-ww * c[1] // hmax), ch=-(-hh * c[2] // vmax), coef=None,
                           q=None, known=[-1] * 64) for c in comps]
            for pl in planes:
                pl["coef"] = [0] * (pl["bw"] * pl["bh"] * 64)
        elif m == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                n = sum(counts)
                huff[(tc, th)] = _huffman_lut(counts, list(seg[i + 17:i + 17 + n]), name)
                i += 17 + n
        elif m == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = np.frombuffer(seg[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    vals = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = vals
                qt[tq] = table.reshape(8, 8)
        elif m == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif m == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xE1 and seg[:6] == b"Exif\x00\x00" and orient == 1:
            orient = _exif_orientation(seg)
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif m == 0xDA:
            if frame is None:
                _jpeg_fail(name, "a scan before its frame header")
            ns = seg[0]
            ids = [c[0] for c in frame["comps"]]
            if any(seg[1 + 2 * i] not in ids for i in range(ns)):
                _jpeg_fail(name, "a scan of an unknown component")
            sc = [(ids.index(seg[1 + 2 * i]), seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15)
                  for i in range(ns)]
            ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, \
                seg[3 + 2 * ns] & 15
            if progressive and (se < ss or se > 63 or (ss == 0) != (se == 0) or (
                    ss and ns != 1) or al > 13):
                _jpeg_fail(name, f"a bad progressive scan (Ss {ss}, Se {se}, {ns} components)")
            dc_needed = not progressive or (ss == 0 and ah == 0)
            ac_needed = not progressive or ss > 0
            luts = {}
            for ci, td, ta in sc:
                if (dc_needed and (0, td) not in huff) or (ac_needed and (1, ta) not in huff):
                    _jpeg_fail(name, "a scan without its Huffman tables")
                luts[ci] = (huff.get((0, td)), huff.get((1, ta)))
                if planes[ci]["q"] is None:  # latched at the component's first scan
                    if frame["comps"][ci][3] not in qt:
                        _jpeg_fail(name, "a scan without its quantization table")
                    planes[ci]["q"] = qt[frame["comps"][ci][3]]
            blocks, per_mcu = _scan_blocks(frame, planes, sc)
            segs, pos = _scan_segments(data, pos)
            coefs = {ci: planes[ci]["coef"] for ci, _, _ in sc}
            ri = restart * per_mcu
            if not progressive:
                _decode_scan(segs, blocks, ri, coefs, luts, name)
                continue
            if ss == 0:
                _decode_dc_prog(segs, blocks, ri, coefs, luts, al, ah != 0, name)
            else:
                ci = sc[0][0]
                run = _decode_ac_refine if ah else _decode_ac_first
                run(segs, [o for _, o in blocks], ri, coefs[ci], luts[ci][1], ss, se, al, name)
            for ci, _, _ in sc:
                planes[ci]["known"][ss:se + 1] = [al] * (se - ss + 1)
        # other markers (APPn, COM, ...) are skipped
    if frame is None or any(pl["q"] is None for pl in planes):
        _jpeg_fail(name, "a JPEG without image data")
    if progressive and any(any(pl["known"][:_SMOOTHED]) for pl in planes):
        _jpeg_fail(name, "a progressive JPEG whose scans leave coefficient bits unknown "
                         "(libjpeg smooths such blocks)")
    space = _jpeg_space(frame, jfif, adobe)
    # JCS_GRAYSCALE from YCbCr (or grey) decodes the first component alone
    need = 1 if space in ("grey", "ycc") and flag == "grayscale" else len(planes)
    full = []
    hh, ww = frame["h"], frame["w"]
    for pl, c in list(zip(planes, frame["comps"]))[:need]:
        coef = np.array(pl["coef"], np.int64).reshape(pl["bh"], pl["bw"], 8, 8)
        px = _idct_islow(coef, pl["q"]).transpose(0, 2, 1, 3).reshape(pl["bh"] * 8, pl["bw"] * 8)
        full.append(_upsample(px[:pl["ch"], :pl["cw"]], frame["hmax"] // c[1],
                              frame["vmax"] // c[2])[:hh, :ww])
    if space == "grey" or (space == "ycc" and flag == "grayscale"):
        out = full[0] if flag != "color" else np.repeat(full[0][..., None], 3, axis=2)
    elif space == "ycc":
        out = _ycc_to_rgb(*full)
    elif space == "rgb":
        rgb = np.stack(full, axis=-1)
        if flag == "grayscale":  # libjpeg's rgb_gray_convert
            r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
            out = ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).astype(np.uint8)
        else:
            out = rgb
    else:
        if space == "ycck":  # jdcolor.c ycck_cmyk_convert
            full[:3] = list(np.moveaxis(255 - _ycc_to_rgb(*full[:3]), -1, 0))
        rgb = _cmyk_to_rgb(*full)
        out = gray_fixed(rgb) if flag == "grayscale" else rgb
    if flag == "unchanged":
        return np.ascontiguousarray(out)
    return _orient(np.ascontiguousarray(out), orient)
