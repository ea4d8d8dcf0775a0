"""Small writers of the image files the port reads: TIFF (strips or tiles,
none / LZW / Deflate / PackBits, predictor 2, planar 1 or 2), BMP (palette,
16- / 24- / 32-bit, RLE8 / RLE4, every info header size) and PNG (any
colour type and bit depth, Adam7). numpy and zlib only, so they run on a
machine without cv2 or Pillow: the CPU tests hold cv2's decodes of their
output to the arrays they were given, and ``chip_smoke.py`` writes its
inputs with them.

Each takes samples as (H, W, C) integers in the file's own order (RGB for
TIFF and PNG, BGR for BMP's pixel bytes and palette entries).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .image_codec import PNG_SIGNATURE, _png_chunk

# ----------------------------------------------------------------- helpers


def _pack_bits(samples: np.ndarray, bits: int) -> np.ndarray:
    """(rows, n) integers of ``bits`` bits -> (rows, ceil(n * bits / 8))
    bytes, MSB first; 16-bit samples big-endian unless the caller swaps."""
    rows = samples.reshape(samples.shape[0], -1).astype(np.int64)
    if bits == 8:
        return rows.astype(np.uint8)
    if bits == 16:
        return rows.astype(">u2").view(np.uint8).reshape(rows.shape[0], -1)
    shifts = np.arange(bits - 1, -1, -1)
    bitmap = ((rows[..., None] >> shifts) & 1).reshape(rows.shape[0], -1).astype(np.uint8)
    return np.packbits(bitmap, axis=1)


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes of 9-12 bits, clear 256, end 257), the code
    width growing and the table clearing where libtiff's encoder does."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    put(256)
    table, free = {}, 258
    prefix = None
    for c in data:
        if prefix is None:
            prefix = c
            continue
        key = (prefix, c)
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        put(prefix)
        prefix = c
        table[key] = free
        free += 1
        if free == 4094:  # table full: clear at the current width
            put(256)
            table, free, nbits = {}, 258, 9
        elif free > (1 << nbits) - 1:
            nbits += 1
    if prefix is not None:
        put(prefix)
        free += 1
        if free > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes as (1 - n, byte), the rest as
    literal groups of up to 128 (n - 1, bytes)."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([(257 - (j - i)) & 0xFF, data[i]])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


# -------------------------------------------------------------------- TIFF

_TIFF_COMPRESS = {1: lambda b: b, 5: lzw_encode, 8: lambda b: zlib.compress(b, 6),
                  32946: lambda b: zlib.compress(b, 6), 32773: packbits_encode}


def _predict(block: np.ndarray, bits: int) -> np.ndarray:
    """Predictor 2 on (rows, cols, spp) samples: each sample less its left
    neighbour's, modulo 2^bits."""
    d = block.astype(np.int64).copy()
    d[:, 1:] -= block[:, :-1].astype(np.int64)
    return d & ((1 << bits) - 1)


def encode_tiff(samples, photometric: int, bits: int = 8, compression: int = 1,
                predictor: int = 1, planar: int = 1, tile=None, rows_per_strip=None,
                colormap=None, extra_samples=(), byteorder: str = "<",
                orientation=None) -> bytes:
    """(H, W, spp) samples -> TIFF bytes, one IFD. ``tile`` = (th, tw)
    writes tiles (multiples of 16), else strips of ``rows_per_strip`` rows;
    ``colormap`` is (3, 2^bits) 16-bit entries for photometric 3."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, spp = s.shape
    e = byteorder
    planes = [s] if planar == 1 else [s[..., i:i + 1] for i in range(spp)]
    chunks = []
    if tile is None:
        rps = rows_per_strip or h
        boxes = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
    else:
        th, tw = tile
        boxes = [(y, x, th, tw) for y in range(0, h, th) for x in range(0, w, tw)]
    for p in planes:
        for y, x, bh, bw in boxes:
            block = np.zeros((bh, bw, p.shape[2]), np.int64)
            part = p[y:y + bh, x:x + bw]
            block[:part.shape[0], :part.shape[1]] = part
            if predictor == 2 and compression in (5, 8, 32946):  # libtiff's rule
                block = _predict(block, bits)
            raw = _pack_bits(block.reshape(bh, -1), bits)
            if bits == 16 and e == "<":
                raw = raw.reshape(bh, -1, 2)[..., ::-1].reshape(bh, -1)
            chunks.append(_TIFF_COMPRESS[compression](raw.tobytes()))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if colormap is not None:
        tags[320] = (3, [int(v) for v in np.asarray(colormap).reshape(-1)])
    if extra_samples:
        tags[338] = (3, list(extra_samples))
    if orientation is not None:
        tags[274] = (3, [orientation])
    if tile is None:
        tags[278] = (4, [rows_per_strip or h])
        off_tag, cnt_tag = 273, 279
    else:
        tags[322], tags[323] = (4, [tile[1]]), (4, [tile[0]])
        off_tag, cnt_tag = 324, 325
    data_at = 8
    offsets = []
    for c in chunks:
        offsets.append(data_at)
        data_at += len(c) + (len(c) & 1)
    tags[off_tag] = (4, offsets)
    tags[cnt_tag] = (4, [len(c) for c in chunks])
    ifd_at = data_at
    n = len(tags)
    extra_at = ifd_at + 2 + 12 * n + 4
    ifd, extra = b"", b""
    for tag in sorted(tags):
        typ, vals = tags[tag]
        fmt = "H" if typ == 3 else "I"
        body = struct.pack(e + fmt * len(vals), *vals)
        if len(body) <= 4:
            ifd += struct.pack(e + "HHI", tag, typ, len(vals)) + body.ljust(4, b"\0")
        else:
            ifd += struct.pack(e + "HHII", tag, typ, len(vals), extra_at + len(extra))
            extra += body + b"\0" * (len(body) & 1)
    head = (b"II*\0" if e == "<" else b"MM\0*") + struct.pack(e + "I", ifd_at)
    data = b"".join(c + b"\0" * (len(c) & 1) for c in chunks)
    return head + data + struct.pack(e + "H", n) + ifd + b"\0\0\0\0" + extra


# --------------------------------------------------------------------- BMP


def rle8_encode(rows) -> bytes:
    """BMP RLE8 of rows of palette indices (top row last, as stored): runs
    of 2+ equal bytes encoded, the rest absolute (3+ bytes, word-aligned)
    or single runs, an end of line after each row, the end of bitmap."""
    out = bytearray()
    for r in rows:
        r = bytes(np.asarray(r, np.uint8))
        i, n = 0, len(r)
        while i < n:
            j = i + 1
            while j < n and j - i < 255 and r[j] == r[i]:
                j += 1
            if j - i >= 2:
                out += bytes([j - i, r[i]])
                i = j
                continue
            j = i + 1
            while j < n and j - i < 255 and not (j + 1 < n and r[j] == r[j + 1]):
                j += 1
            if j - i >= 3:
                out += bytes([0, j - i]) + r[i:j] + b"\0" * ((j - i) & 1)
            else:
                out += b"".join(bytes([1, c]) for c in r[i:j])
            i = j
        out += b"\0\0"
    return bytes(out[:-2]) + b"\0\1"


def rle4_encode(rows) -> bytes:
    """BMP RLE4 of rows of 4-bit indices: runs of one index as encoded
    pairs, an end of line after each row, the end of bitmap."""
    out = bytearray()
    for r in rows:
        r = [int(v) for v in r]
        i, n = 0, len(r)
        while i < n:
            j = i + 1
            while j < n and j - i < 255 and r[j] == r[i]:
                j += 1
            out += bytes([j - i, (r[i] << 4) | r[i]])
            i = j
        out += b"\0\0"
    return bytes(out[:-2]) + b"\0\1"


def encode_bmp(pixels: bytes, w: int, h: int, bpp: int, compression: int = 0,
               header: int = 40, palette=None, masks=None, top_down: bool = False,
               clr_used=None) -> bytes:
    """A BMP around ``pixels`` (the pixel array as stored: rows padded to 4
    bytes, bottom-up unless ``top_down``, or an RLE stream). ``palette`` is
    a list of (b, g, r); ``masks`` (r, g, b[, a]) go after a 40-byte header
    or inside a larger one."""
    pal = b""
    if palette is not None:
        pal = b"".join(bytes(int(v) for v in entry) + (b"" if header == 12 else b"\0")
                       for entry in palette)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        used = clr_used if clr_used is not None else (0 if palette is None else len(palette))
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bpp,
                           compression, len(pixels), 2835, 2835, used, 0)
        m = list(masks or ()) + [0] * 4
        if header >= 52:
            info += struct.pack("<III", *m[:3]) + (struct.pack("<I", m[3]) if header >= 56
                                                  else b"")
        info = info.ljust(header, b"\0")
        if masks is not None and header == 40:
            info += struct.pack("<III", *m[:3])
    offset = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + pal
            + pixels)


def bmp_rows(rows) -> bytes:
    """Rows of bytes, each padded to a multiple of 4."""
    return b"".join(bytes(r) + b"\0" * (-len(bytes(r)) % 4) for r in rows)


def encode_bmp_palette(index: np.ndarray, palette, bpp: int = 8, rle: bool = False,
                       header: int = 40) -> bytes:
    """(H, W) palette indices -> a 1 / 4 / 8-bit palette BMP, bottom-up;
    RLE8 (8-bit) or RLE4 (4-bit) where ``rle``."""
    h, w = index.shape
    rows = index[::-1]
    if rle:
        stream = rle8_encode(rows) if bpp == 8 else rle4_encode(rows)
        return encode_bmp(stream, w, h, bpp, 1 if bpp == 8 else 2, header, palette)
    return encode_bmp(bmp_rows(_pack_bits(rows, bpp)), w, h, bpp, 0, header, palette)


# --------------------------------------------------------------------- PNG

_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))


def encode_png_samples(samples, color_type: int, bits: int = 8, interlace: bool = False,
                       palette=None, trns: bytes = None, chunks=()) -> bytes:
    """(H, W, C) samples -> PNG of ``color_type`` at ``bits`` bits, filter 0
    on every row, Adam7 where ``interlace``; ``chunks`` are (type, body)
    pairs placed before PLTE."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w = s.shape[:2]

    def scanlines(sub):
        packed = _pack_bits(sub.reshape(sub.shape[0], -1), bits)
        return np.concatenate([np.zeros((packed.shape[0], 1), np.uint8), packed], 1).tobytes()

    if interlace:
        raw = b"".join(scanlines(s[y0::dy, x0::dx]) for y0, x0, dy, dx in _ADAM7
                       if s[y0::dy, x0::dx].size)
    else:
        raw = scanlines(s)
    out = PNG_SIGNATURE + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, color_type,
                                                          0, 0, int(interlace)))
    for ctype, body in chunks:
        out += _png_chunk(ctype, body)
    if palette is not None:
        out += _png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _png_chunk(b"tRNS", trns)
    return out + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b"")
