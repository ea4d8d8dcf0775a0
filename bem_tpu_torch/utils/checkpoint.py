"""Reading bem_tpu's ``net_g_*.msgpack`` checkpoints (counterpart of
bem_tpu/utils/checkpoint.py ``load_params``) without flax or msgpack.

``msgpack_restore`` decodes what ``flax.serialization.msgpack_serialize``
writes: maps, arrays, str, bin, ints, floats, nil and bools; ext type 1
(an ndarray: a msgpack ``(shape, dtype name, C-order bytes)``) and ext
type 3 (a numpy scalar, the same payload); and the
``__msgpack_chunked_array__`` dicts flax splits arrays over 2^30 bytes
into. bfloat16 leaves come back as float32 (numpy has no bfloat16; the
widening is exact). The tree feeds ``bem_tpu_torch.convert.load_flax_params``.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Decoder:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def node(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.node() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.string(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8 / 16 / 32
        if t in sized:
            return self.take(self.unpack(sized[t]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in numbers:
            return self.unpack(numbers[t])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            code = self.unpack(">b")
            return _ext(code, self.take(fixext[t]))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if t in ext:
            n = self.unpack(ext[t])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in strs:
            return self.string(self.unpack(strs[t]))
        if t in (0xDC, 0xDD):
            return [self.node() for _ in range(self.unpack(">H" if t == 0xDC else ">I"))]
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.node()
            out[k] = self.node()
        return out


def _decode(data: bytes, raw: bool = False):
    d = _Decoder(data, raw)
    out = d.node()
    if d.pos != len(d.data):
        raise ValueError("msgpack: trailing bytes after the object")
    return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buf = _decode(payload, raw=True)
    name = name.decode("ascii")
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"msgpack: unsupported ext type {code}")


def _unchunk(tree):
    """Reassemble flax's chunked array leaves (serialization._unchunk)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore without flax: nested dicts / lists
    of Python values and numpy arrays."""
    return _unchunk(_decode(data))


def load_params(path: str, param_key: str = "params") -> Any:
    """The ``param_key`` tree of a ``save_params`` file; the sole entry of a
    one-entry file otherwise, else the whole tree (checkpoint.py:32-42)."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if param_key in tree:
        return tree[param_key]
    if len(tree) == 1:
        return next(iter(tree.values()))
    return tree
