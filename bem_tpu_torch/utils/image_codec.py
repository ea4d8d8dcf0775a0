"""PNG and BMP codecs on zlib and numpy (the card's machine has no cv2 / PIL).

``decode_png`` / ``decode_bmp`` return what ``cv2.imread(path,
cv2.IMREAD_COLOR)`` gives, in RGB order: (H, W, 3) uint8, grey expanded to
three channels, alpha dropped, 16-bit samples cut to their high byte
(``>> 8``), palette indices looked up. PNG: bit depths 1-16 as the
standard allows them per colour type (0, 2, 3, 4, 6), all five row
filters, non-interlaced. BMP: uncompressed 24-bit. Anything else raises
a ``ValueError`` naming the file; nothing falls back to another decoder.
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
