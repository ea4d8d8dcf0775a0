"""PNG, BMP and JPEG codecs on zlib and numpy (the card's machine has no cv2 /
PIL).

``decode_png`` / ``decode_bmp`` return what ``cv2.imread(path,
cv2.IMREAD_COLOR)`` gives, in RGB order: (H, W, 3) uint8, grey expanded to
three channels, alpha dropped, 16-bit samples cut to their high byte
(``>> 8``), palette indices looked up. PNG: bit depths 1-16 as the
standard allows them per colour type (0, 2, 3, 4, 6), all five row
filters, non-interlaced. BMP: uncompressed 24-bit. JPEG: ``decode_jpeg``
below. Anything else raises a ``ValueError`` naming the file; nothing
falls back to another decoder.
``encode_png`` writes 8-bit RGB.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, allowed bit depths)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}


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


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, converted as IMREAD_COLOR does."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, color, comp, filt, interlace = header
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not supported")
    if color not in _PNG_TYPES or depth not in _PNG_TYPES[color][1] or comp or filt:
        raise ValueError(f"{name}: unsupported PNG (colour type {color}, bit depth {depth}, "
                         f"compression {comp}, filter method {filt})")
    channels = _PNG_TYPES[color][0]
    bits = channels * depth
    row_bytes = (w * bits + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (row_bytes + 1):
        raise ValueError(f"{name}: PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, count=h * (row_bytes + 1)).reshape(h, row_bytes + 1)
    out = _unfilter(rows, max(1, bits // 8), name)
    if depth == 16:
        s = out.reshape(h, w, channels, 2)[..., 0]  # big-endian: the high byte
    elif depth == 8:
        s = out.reshape(h, w, channels)
    else:
        packed = np.unpackbits(out, axis=1)[:, :w * depth].reshape(h, w, depth)
        s = (packed.astype(np.uint16) << np.arange(depth - 1, -1, -1, dtype=np.uint16)
             ).sum(-1, dtype=np.uint16)
        if color == 0:  # grey below 8 bits scales to 0..255
            s = s * (255 // (2 ** depth - 1))
        s = s.astype(np.uint8)[..., None]
    if color == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        idx = s[..., 0]
        if idx.max() >= len(palette):
            raise ValueError(f"{name}: palette index beyond the PLTE entries")
        return palette[idx]
    if color in (0, 4):
        return np.repeat(s[..., :1], 3, axis=2)
    return np.ascontiguousarray(s[..., :3])


def decode_bmp(data: bytes, name: str = "<bmp>") -> np.ndarray:
    """Uncompressed 24-bit BMP bytes -> (H, W, 3) uint8 RGB."""
    if data[:2] != b"BM" or len(data) < 54:
        raise ValueError(f"{name}: not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (hdr_size,) = struct.unpack("<I", data[14:18])
    w, h, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
    if hdr_size < 40 or bpp != 24 or comp != 0 or w <= 0 or h == 0:
        raise ValueError(f"{name}: only uncompressed 24-bit BMP is supported "
                         f"(header {hdr_size} bytes, {bpp} bits, compression {comp})")
    stride = (w * 3 + 3) & ~3
    if offset + stride * abs(h) > len(data):
        raise ValueError(f"{name}: BMP pixel data is truncated")
    px = np.frombuffer(data, np.uint8, count=stride * abs(h), offset=offset)
    px = px.reshape(abs(h), stride)[:, :w * 3].reshape(abs(h), w, 3)
    if h > 0:  # bottom-up rows
        px = px[::-1]
    return np.ascontiguousarray(px[..., ::-1])  # BGR -> RGB


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(
        ">I", zlib.crc32(ctype + body))


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes (8-bit RGB, filter 0 on every row)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png: want (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    return (PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


# ----------------------------------------------------------------------- JPEG
#
# Baseline and extended-sequential Huffman JPEG (SOF0 / SOF1, 8-bit), one or
# three components, any sampling factors, restart intervals, and the EXIF
# Orientation tag, decoded as cv2.imdecode(..., IMREAD_COLOR) decodes them
# with libjpeg-turbo's defaults: the ``jidctint.c`` integer IDCT, "fancy"
# upsampling (``jdsample.c``) and the integer YCbCr -> RGB tables of
# ``jdcolor.c``. All three are integer arithmetic, so the result is exact.
# The Huffman decoding is a Python loop over a 16-bit lookup table; the
# IDCT, the upsampling and the colour conversion are numpy over all blocks.

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
    44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# libjpeg's natural order carries 16 extra entries at 63, so a corrupt run
# past the block's end lands on its last coefficient
_NATURAL = _ZIGZAG.tolist() + [63] * 16
_JPEG_UNSUPPORTED = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical (differential sequential)",
    0xC6: "hierarchical (differential progressive)", 0xC7: "hierarchical (differential lossless)",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCC: "arithmetic-coded",
    0xCD: "arithmetic-coded hierarchical", 0xCE: "arithmetic-coded hierarchical",
    0xCF: "arithmetic-coded hierarchical"}
_EXIF_ORIENT = {  # tag value -> cv2's transform of the decoded image
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: a.transpose(1, 0, 2), 6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
    7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1], 8: lambda a: a.transpose(1, 0, 2)[::-1]}


def _jpeg_fail(name, what):
    raise ValueError(f"{name}: {what} (baseline and extended-sequential Huffman JPEG, "
                     f"8-bit, 1 or 3 components, are supported)")


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


def _decode_scan(segs, blocks, ri_blocks, coefs, luts, name):
    """Huffman-decode a scan's blocks: ``blocks`` is a list of (component,
    flat offset into the component's list in ``coefs``), in scan order; the
    DC predictions reset and a new segment starts every ``ri_blocks``
    blocks (0: no restarts)."""
    natural = _NATURAL
    mask32 = 0xFFFFFFFF
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


def decode_jpeg(data: bytes, name: str = "<jpeg>") -> np.ndarray:
    """Baseline / extended-sequential Huffman JPEG bytes -> (H, W, 3) uint8
    RGB, as cv2.imdecode(..., IMREAD_COLOR) gives it (in BGR), the EXIF
    Orientation applied. Other kinds raise a ValueError naming the file."""
    if data[:2] != b"\xff\xd8":
        _jpeg_fail(name, "not a JPEG file")
    qt, huff, frame = {}, {}, None
    restart, jfif, adobe, orient = 0, False, None, 1
    planes = None
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
        if m in (0xC0, 0xC1):
            prec, hh, ww, nf = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                _jpeg_fail(name, f"a {prec}-bit JPEG")
            if hh == 0 or ww == 0:
                _jpeg_fail(name, "a JPEG without its size (DNL)")
            comps = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                     for i in range(nf)]
            if nf not in (1, 3):
                _jpeg_fail(name, f"a {nf}-component (e.g. CMYK) JPEG")
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            if any(hmax % c[1] or vmax % c[2] for c in comps):
                _jpeg_fail(name, "fractional sampling factors")
            mx, my = -(-ww // (8 * hmax)), -(-hh // (8 * vmax))
            frame = dict(h=hh, w=ww, comps=comps, hmax=hmax, vmax=vmax, mx=mx, my=my)
            # per component: its block grid (the MCU grid's) and coefficient list
            planes = [dict(bw=mx * c[1], bh=my * c[2],
                           cw=-(-ww * c[1] // hmax), ch=-(-hh * c[2] // vmax), coef=None,
                           q=None) for c in comps]
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
            sc = [(ids.index(seg[1 + 2 * i]), seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15)
                  for i in range(ns)]
            luts, blocks = {}, []
            for ci, td, ta in sc:
                if (0, td) not in huff or (1, ta) not in huff:
                    _jpeg_fail(name, "a scan without its Huffman tables")
                luts[ci] = (huff[(0, td)], huff[(1, ta)])
                if planes[ci]["q"] is None:  # latched at the component's first scan
                    planes[ci]["q"] = qt[frame["comps"][ci][3]]
            if ns == 1:  # non-interleaved: the component's own blocks, raster order
                ci = sc[0][0]
                pl = planes[ci]
                nbx, nby = -(-pl["cw"] // 8), -(-pl["ch"] // 8)
                r, c = np.mgrid[0:nby, 0:nbx]
                offs = ((r * pl["bw"] + c) * 64).ravel().tolist()
                blocks = [(ci, o) for o in offs]
                per_mcu = 1
            else:
                per_mcu = 0
                unit = []  # (component, row, col) of one MCU's blocks
                for ci, _, _ in sc:
                    _, hs, vs, _ = frame["comps"][ci]
                    unit += [(ci, v, u) for v in range(vs) for u in range(hs)]
                    per_mcu += hs * vs
                for my_ in range(frame["my"]):
                    for mx_ in range(frame["mx"]):
                        for ci, v, u in unit:
                            _, hs, vs, _ = frame["comps"][ci]
                            row, col = my_ * vs + v, mx_ * hs + u
                            blocks.append((ci, (row * planes[ci]["bw"] + col) * 64))
            segs, pos = _scan_segments(data, pos)
            coefs = {ci: planes[ci]["coef"] for ci, _, _ in sc}
            _decode_scan(segs, blocks, restart * per_mcu, coefs, luts, name)
        # other markers (APPn, COM, ...) are skipped
    if frame is None or any(pl["q"] is None for pl in planes):
        _jpeg_fail(name, "a JPEG without image data")
    samples = []
    for pl in planes:
        coef = np.array(pl["coef"], np.int64).reshape(pl["bh"], pl["bw"], 8, 8)
        px = _idct_islow(coef, pl["q"]).transpose(0, 2, 1, 3).reshape(
            pl["bh"] * 8, pl["bw"] * 8)
        samples.append(px[:pl["ch"], :pl["cw"]])
    hh, ww = frame["h"], frame["w"]
    full = [_upsample(s, frame["hmax"] // c[1], frame["vmax"] // c[2])[:hh, :ww]
            for s, c in zip(samples, frame["comps"])]
    if len(full) == 1:
        rgb = np.repeat(full[0][..., None], 3, axis=2)
    else:
        ids = [c[0] for c in frame["comps"]]
        is_rgb = (adobe == 0) if (not jfif and adobe is not None) else (
            not jfif and adobe is None and ids == [82, 71, 66])
        rgb = np.stack(full, axis=-1) if is_rgb else _ycc_to_rgb(*full)
    if orient in _EXIF_ORIENT:
        rgb = _EXIF_ORIENT[orient](rgb)
    return np.ascontiguousarray(rgb)
