"""Small writers of the image files the port reads: TIFF (strips or tiles,
none / LZW / Deflate / PackBits, predictor 2, planar 1 or 2), BMP (palette,
16- / 24- / 32-bit, RLE8 / RLE4, every info header size), PNG (any
colour type and bit depth, Adam7) and baseline JPEG (``encode_jpeg``, the
coefficients cv2.imencode computes). numpy and zlib only, so they run on a
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

from .image_codec import _ZIGZAG, PNG_SIGNATURE, _png_chunk

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


# -------------------------------------------------------------------- JPEG
# libjpeg's baseline encoder as cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY,
# q]) runs it (libjpeg-turbo: jcparam.c, jccolor.c, jcsample.c, jfdctint.c,
# jcdctmgr.c, jccoefct.c, jchuff.c): the standard tables, 4:2:0, islow DCT.

_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.full(64, 99)
_STD_CHROMA_Q.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                                       [47, 66, 99, 99]]
_AC_TAIL = [r << 4 | z for r in range(16) for z in range(1, 11)]  # (run, size) in order


def _ac_vals(head):
    return head + [v for v in _AC_TAIL if v not in head]


# (code-length counts, symbols) of the four tables in the standard's Annex K.3
_STD_HUFF = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], _ac_vals([
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
        0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
        0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18,
        0x19, 0x1A, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
        0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57,
        0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
        0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A])),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _ac_vals([
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
        0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09,
        0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25,
        0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56,
        0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
        0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
        0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA,
        0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6,
        0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA])),
}


def jpeg_quant_tables(quality: int):
    """jpeg_set_quality(quality, force_baseline=TRUE): the standard tables
    scaled by 5000 / q (q < 50) or 200 - 2 q percent, rounded, held in
    [1, 255]; (luma, chroma), natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_STD_LUMA_Q, _STD_CHROMA_Q))


def _rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c's rgb_ycc_convert: 16-bit fixed-point tables, Cb / Cr with
    the 0.5 - epsilon rounding."""
    def fix(x):
        return int(x * (1 << 16) + 0.5)

    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half - 1) >> 16
    return y, cb, cr


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jfdctint.c's jpeg_fdct_islow over (n, 8, 8) level-shifted samples:
    output scaled up by 8, as libjpeg leaves it."""
    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def pass_(d, last):
        # ``d``: (..., 8) along the transformed axis
        sh = 13 + 2 if last else 13 - 2
        t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
        t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
        t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
        t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        out = [None] * 8
        if last:
            out[0], out[4] = descale(t10 + t11, 2), descale(t10 - t11, 2)
        else:
            out[0], out[4] = (t10 + t11) << 2, (t10 - t11) << 2
        z1 = (t12 + t13) * 4433
        out[2] = descale(z1 + t13 * 6270, sh)
        out[6] = descale(z1 - t12 * 15137, sh)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * 9633
        t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
        z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
        out[7] = descale(t4 + z1 + z3, sh)
        out[5] = descale(t5 + z2 + z4, sh)
        out[3] = descale(t6 + z2 + z3, sh)
        out[1] = descale(t7 + z1 + z4, sh)
        return np.stack(out, -1)

    rows = pass_(blocks.astype(np.int64), False)
    return pass_(rows.swapaxes(-1, -2), True).swapaxes(-1, -2)


def _quantize(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """jcdctmgr.c's quantize with compute_reciprocal's divisor (the table
    entry << 3): ((|c| + corr) * recip) >> r, the sign put back."""
    d = qtable.reshape(8, 8).astype(np.int64) << 3
    b = np.floor(np.log2(d)).astype(np.int64)
    r = 16 + b
    fq, fr = (1 << r) // d, (1 << r) % d
    c = d // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr <= d // 2, fq, fq + 1))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= d // 2), c + 1, c)
    q = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -q, q)


def _blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """(bh * 8, bw * 8) -> (bh, bw, 8, 8)."""
    return plane[:bh * 8, :bw * 8].reshape(bh, 8, bw, 8).swapaxes(1, 2)


def _huff_codes(bits, vals) -> np.ndarray:
    """(256, 2) (code, length) per symbol of a table given by its length
    counts (length 0 where the table has no such symbol)."""
    out = np.zeros((256, 2), np.int64)
    code, k = 0, 0
    for n, count in enumerate(bits, 1):
        for _ in range(count):
            out[vals[k]] = code, n
            code += 1
            k += 1
        code <<= 1
    return out


def _huffman_scan(coefs: np.ndarray, comp_of: np.ndarray, dc: np.ndarray,
                  ac: np.ndarray) -> bytes:
    """Entropy-coded bytes of one interleaved baseline scan. ``coefs``:
    (n, 64) quantized blocks in zigzag order, in the scan's block order;
    ``comp_of``: each block's component; ``dc`` / ``ac``: (components, 256,
    2) code tables. Each block's DC item, each nonzero AC's item (its
    ZRLs folded in) and EOB become (value, length) pairs, packed MSB
    first, padded with 1 bits, 0xFF stuffed."""
    n = coefs.shape[0]
    diff = coefs[:, 0].copy()
    for comp in np.unique(comp_of):
        sel = np.flatnonzero(comp_of == comp)
        diff[sel] = np.diff(coefs[sel, 0], prepend=0)

    def size_of(v):
        return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)

    def extra(v, sz):
        return np.where(v < 0, v + (1 << sz) - 1, v) & ((1 << sz) - 1)

    blk = np.arange(n)
    sz = size_of(diff)
    code, ln = dc[comp_of, sz].T
    keys, vals, lens = [blk * 65], [(code << sz) | extra(diff, sz)], [ln + sz]
    bi, ki = np.nonzero(coefs[:, 1:])
    v = coefs[bi, ki + 1]
    prev_k = np.r_[-1, ki[:-1]]
    prev_k[np.r_[True, bi[1:] != bi[:-1]]] = -1
    run = ki - prev_k - 1
    sz = size_of(v)
    comp = comp_of[bi]
    code, ln = ac[comp, ((run % 16) << 4) | sz].T
    zc, zl = ac[comp, 0xF0].T
    head, head_len = np.zeros_like(code), np.zeros_like(code)
    for i in range(3):  # at most three ZRLs before a coefficient
        more = run // 16 > i
        head = np.where(more, (head << zl) | zc, head)
        head_len = head_len + np.where(more, zl, 0)
    keys.append(bi * 65 + ki + 1)
    vals.append((((head << ln) | code) << sz) | extra(v, sz))
    lens.append(head_len + ln + sz)
    last = np.full(n, -1, np.int64)
    last[bi] = ki  # ascending within a block: the last write is the last nonzero
    eob = np.flatnonzero(last < 62)
    code, ln = ac[comp_of[eob], 0x00].T
    keys.append(eob * 65 + 64)
    vals.append(code)
    lens.append(ln)
    order = np.argsort(np.concatenate(keys), kind="stable")
    val, ln = np.concatenate(vals)[order], np.concatenate(lens)[order]
    pad = -int(ln.sum()) % 8
    val, ln = np.r_[val, (1 << pad) - 1], np.r_[ln, pad]
    owner = np.repeat(np.arange(val.size), ln)
    pos = np.arange(owner.size) - np.repeat(np.cumsum(ln) - ln, ln)
    data = np.packbits(((val[owner] >> (ln[owner] - 1 - pos)) & 1).astype(np.uint8))
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB -> baseline JFIF JPEG bytes with the quantized
    coefficients ``cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY,
    int(quality)])`` writes: quality scaling of the standard tables (held in
    1..255), fixed-point RGB -> YCbCr, 4:2:0 (h2v2 downsampling with the
    alternating 1 / 2 bias, edges replicated to whole blocks), islow FDCT,
    libjpeg-turbo's reciprocal quantization, dummy blocks past the image's
    MCUs (zero AC, the previous DC), the standard Huffman tables. The
    bytes may differ from cv2's (header segments), the decoded pixels do
    not."""
    img = np.asarray(rgb)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg: (H, W, 3) uint8, not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    qy, qc = jpeg_quant_tables(quality)
    y, cb, cr = _rgb_to_ycc(img)
    mh, mw = -(-h // 16), -(-w // 16)  # MCUs
    # full-resolution planes: rows to even (the conversion buffer's row
    # group), the luma's columns to whole blocks, the chroma's to 2 x the
    # chroma blocks, each by replicating the edge
    he = h + h % 2
    ybh, ybw = -(-h // 8), -(-w // 8)
    yp = np.pad(y, ((0, ybh * 8 - h), (0, ybw * 8 - w)), mode="edge")
    planes = {0: yp}
    for ci, c in ((1, cb), (2, cr)):
        c = np.pad(c, ((0, he - h), (0, mw * 16 - w)), mode="edge")
        bias = np.tile([1, 2], mw * 4)
        c = (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2] + bias) >> 2
        planes[ci] = np.pad(c, ((0, mh * 8 - c.shape[0]), (0, 0)), mode="edge")
    coefs, quants = {}, {0: qy, 1: qc, 2: qc}
    for ci, plane in planes.items():
        bh, bw = (ybh, ybw) if ci == 0 else (mh, mw)
        blocks = _blocks(plane - 128, bh, bw)
        q = _quantize(_fdct_islow(blocks), quants[ci])
        coefs[ci] = q.reshape(bh, bw, 64)[..., _ZIGZAG]
    # luma blocks of the MCU grid; dummies past the image's blocks take the
    # previous block's DC (right edge: the block on the left; bottom row:
    # the MCU's last block above)
    yg = np.zeros((mh * 2, mw * 2, 64), np.int64)
    yg[:ybh, :ybw] = coefs[0]
    for bx in range(ybw, mw * 2):
        yg[:ybh, bx, 0] = yg[:ybh, bx - 1, 0]
    if ybh < mh * 2:
        yg[ybh, :, 0] = yg[ybh - 1, 1::2, 0].repeat(2)
    ymcu = yg.reshape(mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mh, mw, 4, 64)
    scan = np.concatenate([ymcu, coefs[1][:, :, None], coefs[2][:, :, None]], 2).reshape(-1, 64)
    comp_of = np.tile([0, 0, 0, 0, 1, 2], mh * mw)
    dc, ac = (np.stack([_huff_codes(*_STD_HUFF[(tc, th)]) for th in (0, 1, 1)]) for tc in (0, 1))
    entropy = _huffman_scan(scan, comp_of, dc, ac)

    def seg(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tq, t in enumerate((qy, qc)):
        out += seg(0xDB, bytes([tq]) + bytes(t[_ZIGZAG].astype(np.uint8)))
    out += seg(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1,
                                                               3, 0x11, 1]))
    for (tc, th), (bits, vals) in sorted(_STD_HUFF.items()):
        out += seg(0xC4, bytes([tc << 4 | th]) + bytes(bits) + bytes(vals))
    out += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out + entropy + b"\xff\xd9"
