"""WebP decoding on the host, in numpy: what cv2.imdecode gives (libwebp's
simple decoding API, then cv2's conversions), RGB(A) order.

- **Container.** A RIFF ``WEBP`` file holds one ``VP8`` (lossy) or ``VP8L``
  (lossless) chunk, or a ``VP8X`` header followed by an optional ``ALPH``
  chunk and one of those. ICC, XMP and EXIF chunks are skipped, an EXIF
  orientation other than 1 is refused; animations (``ANIM`` / ``ANMF``)
  are refused, where cv2 reads their first frame composited on the canvas.
- **VP8L** (WebP lossless bitstream): prefix codes (simple ones and
  length-coded ones, the code-length code in its fixed order), LZ77
  backward references with the 120 short distance codes, the colour cache,
  meta prefix codes per tile, and the inverse transforms in reverse order
  of reading: predictor (14 modes), cross-colour, subtract-green and colour
  indexing with pixel bundling.
- **VP8** (RFC 6386 key frames, libwebp's decoder): the boolean decoder,
  segment, filter, quantizer and token-probability headers, the intra
  modes (16x16, 4x4 with their contexts, chroma), tokens from up to eight
  partitions, dequantization, the inverse WHT and DCT, the simple and
  normal loop filters, then libwebp's "fancy" 4:2:0 upsampler and its
  fixed-point YUV -> RGB.
- **Alpha** (``ALPH``): raw or VP8L-compressed (the green channel), then
  the horizontal, vertical or gradient unfilter.

cv2 decodes BGRA where the file has alpha, else BGR; ``color`` drops the
alpha, ``grayscale`` takes cvtColor's fixed-point BGR -> grey (15-bit
coefficients, where cv2's other decoders use 14-bit ones), and
``unchanged`` keeps what was decoded. Anything else raises a
``ValueError`` naming the file and the feature.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_codec import _check_flag, _exif_orientation
from .webp_tables import (AC_TABLE, BMODES_PROBA, CODE_TO_PLANE, COEFF_PROBA0,
                          COEFF_UPDATE_PROBA, DC_TABLE)


def _fail(name, what):
    raise ValueError(f"{name}: {what}")


# ------------------------------------------------------------------ container


def _chunks(data: bytes, name: str):
    """[(fourcc, payload)] of a RIFF WEBP file, each padded to even size."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        _fail(name, "not a RIFF WEBP file")
    end = min(len(data), 8 + struct.unpack("<I", data[4:8])[0])
    out, pos = [], 12
    while pos + 8 <= end:
        tag, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if pos + 8 + size > len(data):
            _fail(name, f"a truncated {tag.decode('latin-1')!r} chunk")
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def decode_webp(data: bytes, name: str = "<webp>", flag: str = "color") -> np.ndarray:
    """WebP bytes -> what cv2.imdecode gives with ``flag``, RGB(A) order."""
    _check_flag(flag)
    try:
        return _decode(data, name, flag)
    except (IndexError, KeyError, struct.error) as e:  # a code or index past its table
        raise ValueError(f"{name}: a corrupt WebP bitstream ({type(e).__name__})") from e


def _decode(data: bytes, name: str, flag: str) -> np.ndarray:
    chunks = _chunks(data, name)
    tags = [t for t, _ in chunks]
    if b"ANIM" in tags or b"ANMF" in tags:
        _fail(name, "an animated WebP (ANIM / ANMF) is not decoded")
    body = {t: p for t, p in reversed(chunks)}  # the first of each tag
    if b"EXIF" in body:
        if _exif_orientation(b"Exif\0\0" + body[b"EXIF"]) not in (0, 1):
            _fail(name, "a WebP with an EXIF orientation is not decoded")
    has_alpha = False
    if b"VP8X" in body:
        vp8x = body[b"VP8X"]
        if len(vp8x) < 10:
            _fail(name, "a short VP8X chunk")
        if vp8x[0] & 0x02:
            _fail(name, "an animated WebP (VP8X animation flag) is not decoded")
        has_alpha = bool(vp8x[0] & 0x10)
    if b"VP8L" in body:
        argb, alpha_bit = _decode_vp8l(body[b"VP8L"], name)
        has_alpha = has_alpha or alpha_bit
        rgba = np.stack([(argb >> s & 0xff).astype(np.uint8) for s in (16, 8, 0, 24)], -1)
    elif b"VP8 " in body:
        rgb = _decode_vp8(body[b"VP8 "], name)
        h, w = rgb.shape[:2]
        if b"ALPH" in body:
            has_alpha = True
            alpha = _decode_alpha(body[b"ALPH"], w, h, name)
        else:
            alpha = np.full((h, w), 255, np.uint8)
        rgba = np.concatenate([rgb, alpha[..., None]], -1)
    else:
        _fail(name, "a WebP without a VP8 or VP8L image chunk")
    if flag == "unchanged":
        return np.ascontiguousarray(rgba if has_alpha else rgba[..., :3])
    if flag == "grayscale":  # cvtColor's BGR -> grey on 8-bit samples: 15-bit coefficients
        r, g, b = (rgba[..., i].astype(np.int64) for i in range(3))
        return ((r * 9798 + g * 19235 + b * 3735 + 16384) >> 15).astype(np.uint8)
    return np.ascontiguousarray(rgba[..., :3])


# --------------------------------------------------------------- VP8L (lossless)


class _LBits:
    """The lossless format's bit reader: least significant bit first."""

    def __init__(self, data: bytes, name: str):
        self.data, self.name = bytes(data) + bytes(8), name
        self.pos, self.end = 0, 8 * len(data)

    def read(self, n: int) -> int:
        p = self.pos
        v = int.from_bytes(self.data[p >> 3:(p >> 3) + 8], "little") >> (p & 7)
        self.pos = p + n
        return v & ((1 << n) - 1)

    def check(self):
        if self.pos > self.end:
            _fail(self.name, "a truncated VP8L bitstream")


_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_ALPHABET = (256 + 24, 256, 256, 256, 40)  # green + lengths (+ cache), red, blue, alpha, dist


def _huffman(lengths, name):
    """(table, bits): table[next ``bits`` bits] = symbol | (length << 16),
    the canonical code of ``lengths``; a single symbol reads 0 bits."""
    lengths = [int(v) for v in lengths]
    used = [s for s, n in enumerate(lengths) if n]
    if not used:
        _fail(name, "a VP8L prefix code without symbols")
    if len(used) == 1:
        return [used[0]], 0
    bits = max(lengths)
    count = [0] * (bits + 1)
    for n in lengths:
        count[n] += 1
    count[0] = 0
    code, next_code = 0, [0] * (bits + 1)
    for n in range(1, bits + 1):
        code = (code + count[n - 1]) << 1
        next_code[n] = code
    if code + count[bits] != 1 << bits:  # only complete codes are valid
        _fail(name, "an incomplete or oversubscribed VP8L prefix code")
    table = np.zeros(1 << bits, np.int64)
    for s in used:
        n = lengths[s]
        c = next_code[n]
        next_code[n] += 1
        rev = int(format(c, f"0{n}b")[::-1], 2)
        table[rev::1 << n] = s | (n << 16)
    return table.tolist(), bits


def _read_symbol(br, code):
    table, bits = code
    if not bits:
        return table[0]
    e = table[_peek(br, bits)]
    br.pos += e >> 16
    return e & 0xffff


def _peek(br, n):
    p = br.pos
    return (int.from_bytes(br.data[p >> 3:(p >> 3) + 8], "little") >> (p & 7)) & ((1 << n) - 1)


def _read_code(br, alphabet, name):
    """One prefix code of ``alphabet`` symbols (simple or length-coded)."""
    lengths = [0] * alphabet
    if br.read(1):  # simple: one or two symbols, the first of 1 or 8 bits
        n = br.read(1) + 1
        for bits in ((8 if br.read(1) else 1), 8)[:n]:
            s = br.read(bits)
            if s >= alphabet:
                _fail(name, "a VP8L simple code symbol beyond its alphabet")
            lengths[s] = 1
    else:
        cl = [0] * 19
        for i in range(br.read(4) + 4):
            cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
        cl_code = _huffman(cl, name)
        max_symbol = 2 + br.read(2 + 2 * br.read(3)) if br.read(1) else alphabet
        if max_symbol > alphabet:
            _fail(name, "a VP8L code-length count beyond the alphabet")
        s, prev = 0, 8
        while s < alphabet:
            if max_symbol == 0:
                break
            max_symbol -= 1
            c = _read_symbol(br, cl_code)
            if c < 16:
                lengths[s] = c
                s += 1
                if c:
                    prev = c
            else:
                extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
                rep = br.read(extra) + offset
                if s + rep > alphabet:
                    _fail(name, "a VP8L code-length repeat past the alphabet")
                lengths[s:s + rep] = [prev if c == 16 else 0] * rep
                s += rep
    br.check()
    return _huffman(lengths, name)


def _subsample(size, bits):
    return (size + (1 << bits) - 1) >> bits


def _prefix_value(sym, br):
    """A length or distance from its prefix symbol and extra bits."""
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _plane_distance(xsize, code):
    if code > 120:
        return code - 120
    d = CODE_TO_PLANE[code - 1]
    return max((d >> 4) * xsize + 8 - (d & 0xf), 1)


def _decode_pixels(br, w, h, groups, meta, meta_bits, cache_bits, name):
    """The entropy-coded ARGB pixels (a list of w * h ints)."""
    n = w * h
    out = [0] * n
    cache = [0] * (1 << cache_bits) if cache_bits else None
    cache_shift = 32 - cache_bits
    cached = 0
    meta_w = _subsample(w, meta_bits) if meta is not None else 0
    data = br.data
    i = 0
    while i < n:
        if meta is None:
            g = groups[0]
        else:
            y, x = divmod(i, w)
            g = groups[meta[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        green = g[0]
        if green[1]:
            p = br.pos
            e = green[0][(int.from_bytes(data[p >> 3:(p >> 3) + 8], "little") >> (p & 7))
                         & ((1 << green[1]) - 1)]
            br.pos = p + (e >> 16)
            code = e & 0xffff
        else:
            code = green[0][0]
        if code < 256:
            red, blue, alpha = (_read_symbol(br, g[k]) for k in (1, 2, 3))
            out[i] = (alpha << 24) | (red << 16) | (code << 8) | blue
            i += 1
        elif code < 256 + 24:
            length = _prefix_value(code - 256, br)
            dist = _plane_distance(w, _prefix_value(_read_symbol(br, g[4]), br))
            if dist > i or length > n - i:
                br.check()
                _fail(name, "a VP8L backward reference outside the image")
            if dist >= length:
                out[i:i + length] = out[i - dist:i - dist + length]
            else:
                for k in range(i, i + length):
                    out[k] = out[k - dist]
            i += length
        else:
            if cache is None or code - 280 >= len(cache):
                _fail(name, "a VP8L colour-cache code without the cache")
            while cached < i:
                v = out[cached]
                cache[((0x1e35a7bd * v) & 0xffffffff) >> cache_shift] = v
                cached += 1
            out[i] = cache[code - 280]
            i += 1
        if br.pos > br.end:
            br.check()
    return out


def _image_stream(br, w, h, level0, name):
    """One VP8L image stream of w x h: (h, w) uint32 ARGB, the transforms of
    the main image (``level0``) inverted."""
    transforms = []
    xsize = w
    if level0:
        seen = set()
        while br.read(1):
            kind = br.read(2)
            if kind in seen:
                _fail(name, "a VP8L transform repeated")
            seen.add(kind)
            if kind in (0, 1):  # predictor / cross-colour: a sub-sampled image
                bits = br.read(3) + 2
                sub = _image_stream(br, _subsample(xsize, bits), _subsample(h, bits), False, name)
                transforms.append((kind, xsize, bits, sub))
            elif kind == 3:  # colour indexing
                num = br.read(8) + 1
                bits = 0 if num > 16 else 1 if num > 4 else 2 if num > 2 else 3
                pal = _image_stream(br, num, 1, False, name)[0]
                transforms.append((kind, xsize, bits, _palette(pal, bits)))
                xsize = _subsample(xsize, bits)
            else:
                transforms.append((kind, xsize, 0, None))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            _fail(name, f"a VP8L colour cache of {cache_bits} bits")
    meta, meta_bits, num_groups = None, 0, 1
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        img = _image_stream(br, _subsample(xsize, meta_bits), _subsample(h, meta_bits), False,
                            name)
        meta = ((img >> 8) & 0xffff).ravel().tolist()
        num_groups = max(meta) + 1
    groups = []
    for _ in range(num_groups):
        sizes = list(_ALPHABET)
        sizes[0] += (1 << cache_bits) if cache_bits else 0
        groups.append([_read_code(br, a, name) for a in sizes])
    pixels = _decode_pixels(br, xsize, h, groups, meta, meta_bits, cache_bits, name)
    br.check()
    argb = np.array(pixels, np.uint32).reshape(h, xsize)
    for kind, tw, bits, extra in reversed(transforms):
        argb = _INVERSE[kind](argb, tw, bits, extra)
    return argb


def _palette(pal, bits):
    """The colour-indexing palette, delta-coded per byte, padded with
    transparent black to 2^(8 >> bits) entries."""
    b = pal.view(np.uint8).reshape(-1, 4).astype(np.int64)
    b = (np.cumsum(b, axis=0) & 0xff).astype(np.uint8)
    full = np.zeros((1 << (8 >> bits), 4), np.uint8)
    full[:len(b)] = b[:len(full)]
    return full.view(np.uint32).ravel()


def _inv_color_indexing(argb, w, bits, pal):
    h = argb.shape[0]
    idx = (argb >> 8) & 0xff
    if bits:
        per, ib = 1 << bits, 8 >> bits
        x = np.arange(w)
        idx = (idx[:, x >> bits] >> ((x & (per - 1)) * ib)) & ((1 << ib) - 1)
    return pal[idx.reshape(h, w)]


def _inv_subtract_green(argb, w, bits, extra):
    g = (argb >> 8) & 0xff
    r = (((argb >> 16) & 0xff) + g) & 0xff
    b = ((argb & 0xff) + g) & 0xff
    return (argb & 0xff00ff00) | (r << 16) | b


def _int8(v):
    return ((v.astype(np.int64) & 0xff) ^ 0x80) - 0x80


def _inv_cross_color(argb, w, bits, sub):
    h = argb.shape[0]
    m = sub[np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits]
    g2r, g2b, r2b = _int8(m), _int8(m >> 8), _int8(m >> 16)
    green = _int8(argb >> 8)
    red = ((argb >> 16).astype(np.int64) + ((g2r * green) >> 5)) & 0xff
    blue = (argb.astype(np.int64) & 0xff) + ((g2b * green) >> 5)
    blue = (blue + ((r2b * _int8(red)) >> 5)) & 0xff
    return ((argb & 0xff00ff00) | (red << 16).astype(np.uint32) | blue.astype(np.uint32))


def _add(a, b):
    return (((a & 0xff00ff00) + (b & 0xff00ff00)) & 0xff00ff00) | (
        ((a & 0x00ff00ff) + (b & 0x00ff00ff)) & 0x00ff00ff)


def _avg2(a, b):
    return (((a ^ b) & 0xfefefefe) >> 1) + (a & b)


def _select(t, l, tl):
    """The predictor-11 pick: t where sum |l - tl| <= sum |t - tl| over the
    four bytes, else l."""
    ta, tr, tg, tb = t >> 24, (t >> 16) & 0xff, (t >> 8) & 0xff, t & 0xff
    la, lr, lg, lb = l >> 24, (l >> 16) & 0xff, (l >> 8) & 0xff, l & 0xff
    ca, cr, cg, cb = tl >> 24, (tl >> 16) & 0xff, (tl >> 8) & 0xff, tl & 0xff
    d = (abs(la - ca) + abs(lr - cr) + abs(lg - cg) + abs(lb - cb)
         - abs(ta - ca) - abs(tr - cr) - abs(tg - cg) - abs(tb - cb))
    return t if d <= 0 else l


def _clip255(v):
    return 0 if v < 0 else 255 if v > 255 else v


def _add_sub_full(a, b, c):
    out = 0
    for s in (24, 16, 8, 0):
        out |= _clip255((a >> s & 0xff) + (b >> s & 0xff) - (c >> s & 0xff)) << s
    return out


def _add_sub_half(a, b):
    out = 0
    for s in (24, 16, 8, 0):
        x, y = a >> s & 0xff, b >> s & 0xff
        out |= _clip255(x + int((x - y) / 2)) << s
    return out


_PREDICTORS = (
    lambda L, T, TR, TL: 0xff000000,
    lambda L, T, TR, TL: L,
    lambda L, T, TR, TL: T,
    lambda L, T, TR, TL: TR,
    lambda L, T, TR, TL: TL,
    lambda L, T, TR, TL: _avg2(_avg2(L, TR), T),
    lambda L, T, TR, TL: _avg2(L, TL),
    lambda L, T, TR, TL: _avg2(L, T),
    lambda L, T, TR, TL: _avg2(TL, T),
    lambda L, T, TR, TL: _avg2(T, TR),
    lambda L, T, TR, TL: _avg2(_avg2(L, TL), _avg2(T, TR)),
    lambda L, T, TR, TL: _select(T, L, TL),
    lambda L, T, TR, TL: _add_sub_full(L, T, TL),
    lambda L, T, TR, TL: _add_sub_half(_avg2(L, T), TL),
    lambda L, T, TR, TL: 0xff000000,  # 14 and 15 act as 0
    lambda L, T, TR, TL: 0xff000000,
)


def _inv_predictor(argb, w, bits, sub):
    """Row by row: the top-left pixel adds black, the rest of the first row
    its left neighbour, the first column its top one, every other pixel its
    tile's predictor; the top-right of the last column is the current row's
    first pixel."""
    h = argb.shape[0]
    res = argb.tolist()
    modes = ((sub >> 8) & 0xf).tolist()
    out = [[0] * w for _ in range(h)]
    row = out[0]
    row[0] = _add(res[0][0], 0xff000000)
    for x in range(1, w):
        row[x] = _add(res[0][x], row[x - 1])
    for y in range(1, h):
        top, row, r = out[y - 1], out[y], res[y]
        tile = modes[y >> bits]
        row[0] = _add(r[0], top[0])
        for x in range(1, w):
            tr = top[x + 1] if x + 1 < w else row[0]
            m = tile[x >> bits]
            row[x] = _add(r[x], _PREDICTORS[m](row[x - 1], top[x], tr, top[x - 1]))
    return np.array(out, np.uint32).reshape(h, w)


_INVERSE = {0: _inv_predictor, 1: _inv_cross_color, 2: _inv_subtract_green,
            3: _inv_color_indexing}


def _decode_vp8l(payload: bytes, name: str):
    """A VP8L chunk -> ((h, w) uint32 ARGB, the header's alpha bit)."""
    if len(payload) < 5 or payload[0] != 0x2f:
        _fail(name, "a VP8L chunk without its signature")
    br = _LBits(payload[1:], name)
    w, h = br.read(14) + 1, br.read(14) + 1
    alpha, version = br.read(1), br.read(3)
    if version:
        _fail(name, f"VP8L version {version}")
    return _image_stream(br, w, h, True, name), bool(alpha)


# ------------------------------------------------------------------- alpha


def _decode_alpha(payload: bytes, w: int, h: int, name: str) -> np.ndarray:
    """An ALPH chunk -> (h, w) uint8: raw or VP8L-compressed (the green
    channel of a header-less image stream), then unfiltered."""
    if not payload:
        _fail(name, "an empty ALPH chunk")
    method, filt = payload[0] & 3, (payload[0] >> 2) & 3
    if method == 0:
        if len(payload) - 1 < w * h:
            _fail(name, "a short raw ALPH chunk")
        a = np.frombuffer(payload[1:1 + w * h], np.uint8).reshape(h, w)
    elif method == 1:
        a = ((_image_stream(_LBits(payload[1:], name), w, h, True, name) >> 8) & 0xff)
        a = a.astype(np.uint8)
    else:
        _fail(name, f"ALPH compression method {method}")
    if filt == 0:
        return a.copy()
    a = a.astype(np.int64)
    out = np.empty((h, w), np.int64)
    out[0] = np.cumsum(a[0]) & 0xff  # the first row: each pixel from its left
    if filt == 1:  # horizontal: each row from its left, its first pixel from above
        first = np.cumsum(a[:, 0])
        out[1:] = (first[:-1, None] + np.cumsum(a[1:], axis=1)) & 0xff
    elif filt == 2:  # vertical
        out[1:] = a[1:]
        out = np.cumsum(out, axis=0) & 0xff
    else:  # gradient: clip(left + top - top-left)
        for y in range(1, h):
            prev, cur, row = out[y - 1].tolist(), a[y].tolist(), [0] * w
            left = tl = prev[0]
            for x in range(w):
                g = left + prev[x] - tl
                left = (cur[x] + (0 if g < 0 else 255 if g > 255 else g)) & 0xff
                tl = prev[x]
                row[x] = left
            out[y] = row
    return out.astype(np.uint8)


# ------------------------------------------------------------------ VP8 (lossy)

_NORM = [0] + [7 - int(v).bit_length() + 1 for v in range(1, 256)]  # shifts to range >= 128
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT_PROBAS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
               (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the 4x4 intra-mode tree; modes DC 0, TM 1, VE 2, HE 3, RD 4, VR 5, LD 6, VL 7, HD 8, HU 9
_BMODE_TREE = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
_DC, _TM, _VE, _HE = 0, 1, 2, 3


class _Bool:
    """The boolean entropy decoder (RFC 6386 section 7), libwebp's windowed
    form: ``value`` holds ``bits`` bits below the 8 that meet the range."""

    def __init__(self, data: bytes):
        self.data, self.pos = bytes(data), 0
        self.value, self.bits, self.range = 0, -8, 255
        self._load()

    def _load(self):
        chunk = self.data[self.pos:self.pos + 7]
        self.pos += 7
        self.value = (self.value << 56) | (int.from_bytes(chunk, "big") << (8 * (7 - len(chunk))))
        self.bits += 56

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << self.bits
        if self.value >= big:
            self.value -= big
            r = self.range - split
            b = 1
        else:
            r = split
            b = 0
        s = _NORM[r]
        self.range = r << s
        self.bits -= s
        return b

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v


def _read_coeffs(br, probas, ctx, dq, first, out):
    """One block's tokens (libwebp's GetCoeffs): the dequantized
    coefficients in raster order into ``out``; returns the index of the last
    non-zero one plus 1 (``first`` when the block ends at once)."""
    bit = br.bit
    n = first
    p = probas[n][ctx]
    while n < 16:
        if not bit(p[0]):
            return n
        while not bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = probas[n][0]
        if not bit(p[2]):
            v, nxt = 1, 1
        else:
            if not bit(p[3]):
                v = 2 if not bit(p[4]) else 3 + bit(p[5])
            elif not bit(p[6]):
                v = 5 + bit(159) if not bit(p[7]) else 7 + 2 * bit(165) + bit(145)
            else:
                b1 = bit(p[8])
                cat = 2 * b1 + bit(p[9 + b1])
                v = 0
                for prob in _CAT_PROBAS[cat]:
                    v += v + bit(prob)
                v += 3 + (8 << cat)
            nxt = 2
        if bit(128):
            v = -v
        out[_ZIGZAG[n]] = v * dq[n > 0]
        n += 1
        if n < 16:
            p = probas[n][nxt]
    return 16


def _frame_header(payload, name):
    if len(payload) < 10:
        _fail(name, "a short VP8 chunk")
    tag = payload[0] | (payload[1] << 8) | (payload[2] << 16)
    if tag & 1:
        _fail(name, "a VP8 inter frame")
    if payload[3:6] != b"\x9d\x01\x2a":
        _fail(name, "a VP8 key frame without its start code")
    w = (payload[6] | (payload[7] << 8)) & 0x3fff
    h = (payload[8] | (payload[9] << 8)) & 0x3fff
    part0 = tag >> 5
    if 10 + part0 > len(payload):
        _fail(name, "a truncated VP8 first partition")
    return w, h, part0


def _parse_headers(br, payload, part0, name):
    hdr = {}
    br.bit(128), br.bit(128)  # colour space, clamping type
    use_segment = br.bit(128)
    # libwebp's reset segment header: absolute values of 0 until updated
    update_map, absolute, seg_q, seg_lf = 0, 1, [0] * 4, [0] * 4
    seg_probs = [255, 255, 255]
    if use_segment:
        update_map = br.bit(128)
        if br.bit(128):
            absolute = br.bit(128)
            seg_q = [br.signed(7) if br.bit(128) else 0 for _ in range(4)]
            seg_lf = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        if update_map:
            seg_probs = [br.literal(8) if br.bit(128) else 255 for _ in range(3)]
    simple, level, sharpness = br.bit(128), br.literal(6), br.literal(3)
    ref_lf, mode_lf = [0] * 4, [0] * 4
    use_lf_delta = br.bit(128)
    if use_lf_delta and br.bit(128):
        for d in (ref_lf, mode_lf):
            for i in range(4):
                if br.bit(128):
                    d[i] = br.signed(6)
    num_parts = 1 << br.literal(2)
    sizes_at = 10 + part0
    rest = sizes_at + 3 * (num_parts - 1)
    if rest > len(payload):
        _fail(name, "truncated VP8 partition sizes")
    parts = []
    for i in range(num_parts):
        if i < num_parts - 1:
            size = int.from_bytes(payload[sizes_at + 3 * i:sizes_at + 3 * i + 3], "little")
        else:
            size = len(payload) - rest
        parts.append(_Bool(payload[rest:rest + size]))
        rest += size
    base_q = br.literal(7)
    dq = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]  # y1 dc, y2 dc, y2 ac, uv dc, uv ac
    quants = []
    for s in range(4):
        q = (seg_q[s] + (0 if absolute else base_q)) if use_segment else base_q

        def clip(v, m):
            return 0 if v < 0 else m if v > m else v

        y2ac = (AC_TABLE[clip(q + dq[2], 127)] * 101581) >> 16
        quants.append(((DC_TABLE[clip(q + dq[0], 127)], AC_TABLE[clip(q, 127)]),
                       (DC_TABLE[clip(q + dq[1], 127)] * 2, max(y2ac, 8)),
                       (DC_TABLE[clip(q + dq[3], 117)], AC_TABLE[clip(q + dq[4], 127)])))
    br.bit(128)  # refresh entropy probabilities: ignored on a key-frame-only stream
    proba = COEFF_PROBA0.astype(np.int64).copy()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if br.bit(int(COEFF_UPDATE_PROBA[t, b, c, p])):
                        proba[t, b, c, p] = br.literal(8)
    use_skip = br.bit(128)
    skip_p = br.literal(8) if use_skip else 0
    # per type, per coefficient position 0..16: its band's probabilities
    bands = [[proba[t, _BANDS[n]].tolist() for n in range(17)] for t in range(4)]
    # loop-filter strengths per (segment, is_i4x4)
    strengths = {}
    for s in range(4):
        base = (seg_lf[s] + (0 if absolute else level)) if use_segment else level
        for i4 in (0, 1):
            lv = base
            if use_lf_delta:
                lv += ref_lf[0] + (mode_lf[0] if i4 else 0)
            lv = min(max(lv, 0), 63)
            if lv > 0:
                il = lv
                if sharpness > 0:
                    il >>= 2 if sharpness > 4 else 1
                    il = min(il, 9 - sharpness)
                il = max(il, 1)
                strengths[s, i4] = (2 * lv + il, il, 2 if lv >= 40 else 1 if lv >= 15 else 0)
            else:
                strengths[s, i4] = (0, 0, 0)
    hdr.update(update_map=update_map, seg_probs=seg_probs, parts=parts, quants=quants,
               bands=bands, use_skip=use_skip, skip_p=skip_p, strengths=strengths,
               filter_type=0 if level == 0 else 1 if simple else 2)
    return hdr


def _parse_modes(br, hdr, top, left):
    """One macroblock's segment, skip flag and intra modes (libwebp's
    ParseIntraMode); ``top`` / ``left`` are the 4x4 mode contexts."""
    if hdr["update_map"]:
        sp = hdr["seg_probs"]
        seg = br.bit(sp[1]) if not br.bit(sp[0]) else 2 + br.bit(sp[2])
    else:
        seg = 0
    skip = br.bit(hdr["skip_p"]) if hdr["use_skip"] else 0
    is_i4 = not br.bit(145)
    if not is_i4:
        ymode = (_TM if br.bit(128) else _HE) if br.bit(156) else (_VE if br.bit(163) else _DC)
        top[:] = [ymode] * 4
        left[:] = [ymode] * 4
        modes = ymode
    else:
        modes = []
        for y in range(4):
            m = left[y]
            for x in range(4):
                prob = BMODES_PROBA[top[x], m]
                i = _BMODE_TREE[br.bit(int(prob[0]))]
                while i > 0:
                    i = _BMODE_TREE[2 * i + br.bit(int(prob[i]))]
                m = -i
                top[x] = m
            modes.extend(top)
            left[y] = m
    uv = _DC if not br.bit(142) else _VE if not br.bit(114) else (_TM if br.bit(183) else _HE)
    return seg, skip, is_i4, modes, uv


def _wht(c):
    """libwebp's inverse Walsh-Hadamard transform of (..., 16) Y2
    coefficients -> the 16 luma blocks' DCs, (..., 16)."""
    c = c.astype(np.int64)
    a0 = c[..., 0:4] + c[..., 12:16]
    a1 = c[..., 4:8] + c[..., 8:12]
    a2 = c[..., 4:8] - c[..., 8:12]
    a3 = c[..., 0:4] - c[..., 12:16]
    t = np.concatenate([a0 + a1, a3 + a2, a0 - a1, a3 - a2], -1)  # tmp[0..15]
    t = t.reshape(*c.shape[:-1], 4, 4)
    dc = t[..., 0] + 3
    b0 = dc + t[..., 3]
    b1 = t[..., 1] + t[..., 2]
    b2 = t[..., 1] - t[..., 2]
    b3 = dc - t[..., 3]
    out = np.stack([(b0 + b1) >> 3, (b3 + b2) >> 3, (b0 - b1) >> 3, (b3 - b2) >> 3], -1)
    return out.reshape(*c.shape[:-1], 16)


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(c):
    """libwebp's TransformOne on (..., 16) raster coefficients: the
    residuals (..., 4, 4) added to the prediction (before clipping)."""
    c = c.astype(np.int64).reshape(*c.shape[:-1], 4, 4)
    i0, i1, i2, i3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a, b = i0 + i2, i0 - i2
    cc, d = _mul2(i1) - _mul1(i3), _mul1(i1) + _mul2(i3)
    t = np.stack([a + d, b + cc, b - cc, a - d], -1)  # t[..., column, k]
    dc = t[..., 0, :] + 4
    a, b = dc + t[..., 2, :], dc - t[..., 2, :]
    cc = _mul2(t[..., 1, :]) - _mul1(t[..., 3, :])
    d = _mul1(t[..., 1, :]) + _mul2(t[..., 3, :])
    return np.stack([a + d, b + cc, b - cc, a - d], -1) >> 3  # [..., row, column]


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _pred4(mode, X, A, B, C, D, E, F, G, H, I, J, K, L):
    """One 4x4 block's intra prediction (libwebp dec.c), 16 values row by row."""
    if mode == _DC:
        return [(A + B + C + D + I + J + K + L + 4) >> 3] * 16
    if mode == _TM:
        top = (A, B, C, D)
        return [min(max(t + l - X, 0), 255) for l in (I, J, K, L) for t in top]
    if mode == _VE:
        return [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)] * 4
    if mode == _HE:
        return ([_avg3(X, I, J)] * 4 + [_avg3(I, J, K)] * 4 + [_avg3(J, K, L)] * 4
                + [_avg3(K, L, L)] * 4)
    o = [0] * 16

    def put(v, *xy):
        for x, y in xy:
            o[4 * y + x] = v

    if mode == 4:  # RD
        put(_avg3(J, K, L), (0, 3))
        put(_avg3(I, J, K), (1, 3), (0, 2))
        put(_avg3(X, I, J), (2, 3), (1, 2), (0, 1))
        put(_avg3(A, X, I), (3, 3), (2, 2), (1, 1), (0, 0))
        put(_avg3(B, A, X), (3, 2), (2, 1), (1, 0))
        put(_avg3(C, B, A), (3, 1), (2, 0))
        put(_avg3(D, C, B), (3, 0))
    elif mode == 5:  # VR
        put((X + A + 1) >> 1, (0, 0), (1, 2))
        put((A + B + 1) >> 1, (1, 0), (2, 2))
        put((B + C + 1) >> 1, (2, 0), (3, 2))
        put((C + D + 1) >> 1, (3, 0))
        put(_avg3(K, J, I), (0, 3))
        put(_avg3(J, I, X), (0, 2))
        put(_avg3(I, X, A), (0, 1), (1, 3))
        put(_avg3(X, A, B), (1, 1), (2, 3))
        put(_avg3(A, B, C), (2, 1), (3, 3))
        put(_avg3(B, C, D), (3, 1))
    elif mode == 6:  # LD
        put(_avg3(A, B, C), (0, 0))
        put(_avg3(B, C, D), (1, 0), (0, 1))
        put(_avg3(C, D, E), (2, 0), (1, 1), (0, 2))
        put(_avg3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
        put(_avg3(E, F, G), (3, 1), (2, 2), (1, 3))
        put(_avg3(F, G, H), (3, 2), (2, 3))
        put(_avg3(G, H, H), (3, 3))
    elif mode == 7:  # VL
        put((A + B + 1) >> 1, (0, 0))
        put((B + C + 1) >> 1, (1, 0), (0, 2))
        put((C + D + 1) >> 1, (2, 0), (1, 2))
        put((D + E + 1) >> 1, (3, 0), (2, 2))
        put(_avg3(A, B, C), (0, 1))
        put(_avg3(B, C, D), (1, 1), (0, 3))
        put(_avg3(C, D, E), (2, 1), (1, 3))
        put(_avg3(D, E, F), (3, 1), (2, 3))
        put(_avg3(E, F, G), (3, 2))
        put(_avg3(F, G, H), (3, 3))
    elif mode == 8:  # HD
        put((I + X + 1) >> 1, (0, 0), (2, 1))
        put((J + I + 1) >> 1, (0, 1), (2, 2))
        put((K + J + 1) >> 1, (0, 2), (2, 3))
        put((L + K + 1) >> 1, (0, 3))
        put(_avg3(A, B, C), (3, 0))
        put(_avg3(X, A, B), (2, 0))
        put(_avg3(I, X, A), (1, 0), (3, 1))
        put(_avg3(J, I, X), (1, 1), (3, 2))
        put(_avg3(K, J, I), (1, 2), (3, 3))
        put(_avg3(L, K, J), (1, 3))
    else:  # HU
        put((I + J + 1) >> 1, (0, 0))
        put((J + K + 1) >> 1, (2, 0), (0, 1))
        put((K + L + 1) >> 1, (2, 1), (0, 2))
        put(_avg3(I, J, K), (1, 0))
        put(_avg3(J, K, L), (3, 0), (1, 1))
        put(_avg3(K, L, L), (3, 1), (1, 2))
        put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    return o


def _pred_block(mode, top, left, tl, n, mb_x, mb_y):
    """16x16 luma or 8x8 chroma prediction (numpy) with libwebp's DC
    variants at the frame's top / left edges."""
    if mode == _DC:
        if mb_x == 0 and mb_y == 0:
            return np.full((n, n), 128, np.int64)
        if mb_y == 0:
            return np.full((n, n), (int(left.sum()) + n // 2) >> (n.bit_length() - 1), np.int64)
        if mb_x == 0:
            return np.full((n, n), (int(top.sum()) + n // 2) >> (n.bit_length() - 1), np.int64)
        return np.full((n, n), (int(top.sum()) + int(left.sum()) + n) >> n.bit_length(), np.int64)
    if mode == _VE:
        return np.broadcast_to(top[None, :], (n, n)).astype(np.int64)
    if mode == _HE:
        return np.broadcast_to(left[:, None], (n, n)).astype(np.int64)
    return np.clip(top[None, :] + left[:, None] - tl, 0, 255)


def _context(plane, y0, x0, n, mb_x, mb_y, right=0):
    """A block's top row (with ``right`` samples past it), left column and
    top-left sample from the unfiltered plane, or libwebp's frame-edge
    values: 127 above the frame, 129 left of it."""
    if mb_y == 0:
        top = np.full(n + right, 127, np.int64)
        tl = 127
    else:
        top = plane[y0 - 1, x0:x0 + n + right].astype(np.int64)
        if right and top.shape[0] < n + right:  # the rightmost macroblock
            top = np.concatenate([top, np.full(n + right - top.shape[0], top[n - 1])])
        tl = 129 if mb_x == 0 else int(plane[y0 - 1, x0 - 1])
    left = (np.full(n, 129, np.int64) if mb_x == 0
            else plane[y0:y0 + n, x0 - 1].astype(np.int64))
    return top, left, tl


def _decode_vp8(payload: bytes, name: str) -> np.ndarray:
    """A VP8 key frame -> (h, w, 3) uint8 RGB."""
    w, h, part0 = _frame_header(payload, name)
    br = _Bool(payload[10:10 + part0])
    hdr = _parse_headers(br, payload, part0, name)
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    parts, quants, bands = hdr["parts"], hdr["quants"], hdr["bands"]
    # parse: modes from the first partition, tokens from the row's partition
    coeffs = np.zeros((mbh, mbw, 25, 16), np.int64)  # 16 Y, 4 U, 4 V, Y2
    info = []
    top_modes = [[0] * 4 for _ in range(mbw)]
    top_nz = [[0] * 9 for _ in range(mbw)]  # 4 Y, 2 U, 2 V, Y2
    for mb_y in range(mbh):
        left_modes, left_nz = [0] * 4, [0] * 9
        tb = parts[mb_y & (len(parts) - 1)]
        row = []
        for mb_x in range(mbw):
            seg, skip, is_i4, modes, uv = _parse_modes(br, hdr, top_modes[mb_x], left_modes)
            tnz, c = top_nz[mb_x], coeffs[mb_y, mb_x]
            if not skip:
                yq, y2q, uvq = quants[seg]
                blk = [0] * 16
                if not is_i4:
                    nz = _read_coeffs(tb, bands[1], tnz[8] + left_nz[8], y2q, 0, blk)
                    tnz[8] = left_nz[8] = int(nz > 0)
                    c[24] = blk
                    first, probas = 1, bands[0]
                else:
                    first, probas = 0, bands[3]
                for y in range(4):
                    for x in range(4):
                        blk = [0] * 16
                        nz = _read_coeffs(tb, probas, tnz[x] + left_nz[y], yq, first, blk)
                        tnz[x] = left_nz[y] = int(nz > first)
                        c[4 * y + x] = blk
                for ch in (0, 1):
                    for y in range(2):
                        for x in range(2):
                            blk = [0] * 16
                            k = 4 + 2 * ch
                            nz = _read_coeffs(tb, bands[2], tnz[k + x] + left_nz[k + y], uvq, 0,
                                              blk)
                            tnz[k + x] = left_nz[k + y] = int(nz > 0)
                            c[16 + 4 * ch + 2 * y + x] = blk
            else:
                tnz[:8] = [0] * 8
                left_nz[:8] = [0] * 8
                if not is_i4:
                    tnz[8] = left_nz[8] = 0
            row.append((seg, is_i4, modes, uv))
        info.append(row)
    # dequantized Y2 -> the luma DCs of the 16x16 macroblocks
    i16 = np.array([[not m[1] for m in r] for r in info], bool)
    coeffs = ((coeffs + 32768) & 0xffff) - 32768  # the decoder's int16 coefficients
    coeffs[..., :16, 0] = np.where(i16[..., None], _wht(coeffs[..., 24, :]),
                                   coeffs[..., :16, 0])
    coeffs = ((coeffs + 32768) & 0xffff) - 32768  # the decoder's int16 coefficients
    res = _idct(coeffs[..., :24, :])  # (mbh, mbw, 24, 4, 4)
    nonzero = coeffs[..., :24, :].any(axis=(-1, -2))
    Y = np.zeros((mbh * 16, mbw * 16), np.uint8)
    U = np.zeros((mbh * 8, mbw * 8), np.uint8)
    V = np.zeros((mbh * 8, mbw * 8), np.uint8)
    for mb_y in range(mbh):
        for mb_x in range(mbw):
            _, is_i4, modes, uv = info[mb_y][mb_x]
            r = res[mb_y, mb_x]
            y0, x0 = 16 * mb_y, 16 * mb_x
            if is_i4:
                top, left, tl = _context(Y, y0, x0, 16, mb_x, mb_y, right=4)
                buf = np.zeros((17, 21), np.int64)
                buf[0, 0], buf[0, 1:], buf[1:, 0] = tl, top, left
                buf[4, 17:] = buf[8, 17:] = buf[12, 17:] = top[16:]
                for n in range(16):
                    by, bx = divmod(n, 4)
                    r0, c0 = 1 + 4 * by, 1 + 4 * bx
                    t = buf[r0 - 1, c0 - 1:c0 + 8].tolist()
                    p = _pred4(modes[n], *t, *buf[r0:r0 + 4, c0 - 1].tolist())
                    buf[r0:r0 + 4, c0:c0 + 4] = np.clip(
                        np.array(p, np.int64).reshape(4, 4) + r[n], 0, 255)
                Y[y0:y0 + 16, x0:x0 + 16] = buf[1:, 1:17]
            else:
                top, left, tl = _context(Y, y0, x0, 16, mb_x, mb_y)
                pred = _pred_block(modes, top, left, tl, 16, mb_x, mb_y)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(
                    pred + r[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16), 0,
                    255)
            for k, P in ((16, U), (20, V)):
                top, left, tl = _context(P, y0 // 2, x0 // 2, 8, mb_x, mb_y)
                pred = _pred_block(uv, top, left, tl, 8, mb_x, mb_y)
                P[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = np.clip(
                    pred + r[k:k + 4].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8),
                    0, 255)
    if hdr["filter_type"]:
        _loop_filter(Y, U, V, info, nonzero, hdr)
    return _yuv_to_rgb(Y[:h, :w], U[:(h + 1) // 2, :(w + 1) // 2],
                       V[:(h + 1) // 2, :(w + 1) // 2])


# loop filter (libwebp dec.c), on (lanes, 8) segments p3 p2 p1 p0 q0 q1 q2 q3,
# each lane with its macroblock's thresholds


def _sclip1(v):
    return np.clip(v, -128, 127)


def _filter_simple(seg, thresh):
    p1, p0, q0, q1 = (seg[:, k] for k in (2, 3, 4, 5))
    on = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * thresh + 1
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = np.clip((a + 4) >> 3, -16, 15)
    a2 = np.clip((a + 3) >> 3, -16, 15)
    seg[:, 3] = np.where(on, np.clip(p0 + a2, 0, 255), p0)
    seg[:, 4] = np.where(on, np.clip(q0 - a1, 0, 255), q0)


def _filter_normal(seg, thresh, ithresh, hev_thresh, edge):
    """FilterLoop26 (``edge``, a macroblock edge) or FilterLoop24: where
    the edge needs filtering, DoFilter2 at high edge variance, else
    DoFilter6 / DoFilter4."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (seg[:, k] for k in range(8))
    ad = [np.abs(d) for d in (p3 - p2, p2 - p1, p1 - p0, q3 - q2, q2 - q1, q1 - q0)]
    on = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * thresh + 1
    for d in ad:
        on &= d <= ithresh
    hev = (ad[2] > hev_thresh) | (ad[5] > hev_thresh)
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    f2 = {3: np.clip(p0 + np.clip((a + 3) >> 3, -16, 15), 0, 255),
          4: np.clip(q0 - np.clip((a + 4) >> 3, -16, 15), 0, 255)}
    if edge:  # DoFilter6
        a = _sclip1(a)
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        new = {1: p2 + a3, 2: p1 + a2, 3: p0 + a1, 4: q0 - a1, 5: q1 - a2, 6: q2 - a3}
    else:  # DoFilter4
        a = 3 * (q0 - p0)
        a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        new = {2: p1 + a3, 3: p0 + a2, 4: q0 - a1, 5: q1 - a3}
    out = seg.copy()
    for k, v in new.items():
        v = np.where(hev, f2[k] if k in f2 else seg[:, k], np.clip(v, 0, 255))
        out[:, k] = np.where(on, v, seg[:, k])
    seg[:] = out


def _loop_filter(Y, U, V, info, nonzero, hdr):
    """libwebp's DoFilter on every macroblock: the left edge, the inner
    vertical edges, the top edge, then the inner horizontal ones, in
    raster order. Macroblock (x, y) waits only for (x - 1, y), (x, y - 1)
    and (x + 1, y - 1), so the macroblocks with one x + 2y run together."""
    simple = hdr["filter_type"] == 1
    mbh, mbw = len(info), len(info[0])
    lim = np.zeros((mbh, mbw, 3), np.int64)  # limit, interior limit, hev threshold
    for y, row in enumerate(info):
        for x, (seg_id, is_i4, _, _) in enumerate(row):
            lim[y, x] = hdr["strengths"][seg_id, int(is_i4)]
    inner = np.array([[m[1] for m in r] for r in info], bool) | nonzero
    planes = [(Y, 16, (4, 8, 12))] + ([] if simple else [(U, 8, (4,)), (V, 8, (4,))])
    planes = [(P.astype(np.int64), n, at) for P, n, at in planes]
    ar8 = np.arange(8) - 4
    for t in range(mbw + 2 * (mbh - 1)):
        ys = np.arange(mbh)
        xs = t - 2 * ys
        keep = (xs >= 0) & (xs < mbw)
        ys, xs = ys[keep], xs[keep]
        keep = lim[ys, xs, 0] > 0
        ys, xs = ys[keep], xs[keep]
        if not len(ys):
            continue
        for vertical in (False, True):  # the vertical edges (H filters) first
            for P, n, inner_at in planes:
                for k in (0,) + inner_at:
                    sel = ((ys if vertical else xs) > 0) if k == 0 else inner[ys, xs]
                    if not sel.any():
                        continue
                    y0, x0 = ys[sel] * n, xs[sel] * n
                    lanes = np.arange(n)
                    if vertical:  # lanes are columns, the segment runs down
                        cols = (x0[:, None] + lanes).ravel()[:, None]
                        rows = np.repeat(y0 + k, n)[:, None] + ar8
                    else:
                        rows = (y0[:, None] + lanes).ravel()[:, None]
                        cols = np.repeat(x0 + k, n)[:, None] + ar8
                    L = np.repeat(lim[ys[sel], xs[sel]], n, axis=0)
                    thresh = L[:, 0] + (4 if k == 0 else 0)
                    seg = P[rows, cols]
                    if simple:
                        _filter_simple(seg, thresh)
                    else:
                        _filter_normal(seg, thresh, L[:, 1], L[:, 2], k == 0)
                    P[rows, cols] = seg
    for (P, _, _), dst in zip(planes, (Y, U, V)):
        dst[:] = P


def _upsample(top, cur):
    """libwebp's fancy upsampler for one pair of output rows from chroma
    rows ``top`` and ``cur`` (the nearer one weighted 3 to 1 vertically, 9
    3 3 1 in 2-D): (top output row, bottom output row), 2 * len - 1 or
    2 * len values each."""
    T, C = top.astype(np.int64), cur.astype(np.int64)
    n = T.shape[-1]
    out_t = np.empty(T.shape[:-1] + (2 * n,), np.int64)
    out_b = np.empty_like(out_t)
    out_t[..., 0] = (3 * T[..., 0] + C[..., 0] + 2) >> 2
    out_b[..., 0] = (3 * C[..., 0] + T[..., 0] + 2) >> 2
    tl, t, l, c = T[..., :-1], T[..., 1:], C[..., :-1], C[..., 1:]
    avg = tl + t + l + c + 8
    d12 = (avg + 2 * (t + l)) >> 3
    d03 = (avg + 2 * (tl + c)) >> 3
    out_t[..., 1:-1:2] = (d12 + tl) >> 1
    out_t[..., 2::2] = (d03 + t) >> 1
    out_b[..., 1:-1:2] = (d03 + l) >> 1
    out_b[..., 2::2] = (d12 + c) >> 1
    out_t[..., -1] = (3 * T[..., -1] + C[..., -1] + 2) >> 2
    out_b[..., -1] = (3 * C[..., -1] + T[..., -1] + 2) >> 2
    return out_t, out_b


def _clip8(v):
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def _yuv_to_rgb(Y, U, V):
    """libwebp's fancy upsampling of U / V to Y's size, then its 14-bit
    fixed-point YUV -> RGB (VP8YUVToR / G / B) per pixel."""
    h, w = Y.shape
    rows = []
    for P in (U, V):
        up = np.empty((h, 2 * P.shape[1]), np.int64)
        up[0] = _upsample(P[0], P[0])[0]  # the first row mirrors its chroma row
        if h > 1:
            t, b = _upsample(P[:-1], P[1:])  # output rows 2k - 1 and 2k
            up[1:2 * t.shape[0]:2] = t[:(h - 1 + 1) // 2]
            up[2:2 * t.shape[0] + 1:2] = b[:h // 2]
            if h % 2 == 0:  # the last row of an even height: its chroma row alone
                up[h - 1] = _upsample(P[-1], P[-1])[0]
        rows.append(up[:, :w])
    u, v = rows
    y = Y.astype(np.int64)

    def hi(a, k):
        return (a * k) >> 8

    r = _clip8(hi(y, 19077) + hi(v, 26149) - 14234)
    g = _clip8(hi(y, 19077) - hi(u, 6419) - hi(v, 13320) + 8708)
    b = _clip8(hi(y, 19077) + hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)
