"""bem_tpu's checkpoints without flax or msgpack (counterpart of
bem_tpu/utils/checkpoint.py): ``net_g_<iter>.msgpack`` network files
(``save_params`` / ``load_params``) and ``<iter>.state`` training states
(``save_state`` / ``load_state``), read and written in
``flax.serialization``'s msgpack layout.

``msgpack_restore`` decodes what ``flax.serialization.msgpack_serialize``
writes: maps, arrays, str, bin, ints, floats, nil and bools; ext type 1
(an ndarray: a msgpack ``(shape, dtype name, C-order bytes)``) and ext
type 3 (a numpy scalar, the same payload); and the
``__msgpack_chunked_array__`` dicts flax splits arrays over 2^30 bytes
into. bfloat16 leaves come back as float32 (numpy has no bfloat16; the
widening is exact). The tree feeds ``bem_tpu_torch.convert.load_flax_params``.

``msgpack_serialize`` writes what ``flax.serialization.msgpack_serialize``
writes for the same tree, byte for byte: dict keys sorted, msgpack's smallest encodings,
Python floats as float64, numpy arrays (and torch tensors, bf16 ones as
``bfloat16``) as ext type 1, numpy scalars as ext type 3, and arrays over
2^30 bytes split into ``__msgpack_chunked_array__`` dicts.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Any, Optional

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax's limit on the bytes of one array leaf


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


def _ndarray_payload(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return _encode(((*a.shape,), "bfloat16", a.contiguous().view(torch.int16).numpy().tobytes()))
        a = a.numpy()
    return _encode((a.shape, a.dtype.name, np.ascontiguousarray(a).tobytes()))


def _sized(out: list, n: int, fix, tags) -> None:
    """Append the header of a length-``n`` object: ``fix`` = (tag, limit)
    gives tag | n below the limit, else the first of ``tags`` (tag, length
    format) that holds n."""
    if fix is not None and n < fix[1]:
        out.append(bytes([fix[0] | n]))
        return
    for tag, fmt in tags:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(bytes([tag]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: object of length {n} too large")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(bytes([obj]))
        elif -32 <= obj < 0:
            out.append(struct.pack(">b", obj))
        elif obj >= 0:
            tag, fmt = next((t, f) for t, f in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                                                 (0xCF, ">Q")) if obj < 1 << (8 * struct.calcsize(f)))
            out.append(bytes([tag]) + struct.pack(fmt, obj))
        else:
            tag, fmt = next((t, f) for t, f in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                                                 (0xD3, ">q")) if obj >= -(1 << (8 * struct.calcsize(f) - 1)))
            out.append(bytes([tag]) + struct.pack(fmt, obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _sized(out, len(b), (0xA0, 32), ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray)):
        _sized(out, len(obj), None, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), (0x90, 16), ((0xDC, ">H"), (0xDD, ">I")))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _sized(out, len(obj), (0x80, 16), ((0xDE, ">H"), (0xDF, ">I")))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor, np.generic)):
        code = _EXT_NPSCALAR if isinstance(obj, np.generic) else _EXT_NDARRAY
        payload = _ndarray_payload(np.asarray(obj) if code == _EXT_NPSCALAR else obj)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixext:
            out.append(bytes([fixext[len(payload)]]))
        else:
            _sized(out, len(payload), None, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
        out.append(struct.pack(">b", code) + payload)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def _encode(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def _chunk(tree):
    """Sort dict keys (flax copies the tree with jax.tree_util, which sorts
    them) and split array leaves over MAX_CHUNK_SIZE bytes
    (serialization._chunk)."""
    if isinstance(tree, dict):
        return {k: _chunk(tree[k]) for k in sorted(tree)}
    if isinstance(tree, torch.Tensor) and tree.dtype != torch.bfloat16:
        tree = tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        flat = tree.reshape(-1)
        n = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        chunks = [flat[i:i + n] for i in range(0, flat.size, n)]
        return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def msgpack_serialize(tree) -> bytes:
    """flax.serialization.msgpack_serialize without flax: nested dicts (str
    keys), lists, Python scalars, numpy arrays and torch tensors."""
    return _encode(_chunk(tree))


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def save_params(path: str, params, param_key: str = "params", extra: dict = None):
    """A ``net_g`` file: {param_key: params, **extra} (checkpoint.py:23), the
    trees in flax's layout (``convert.state_dict_to_flax``)."""
    tree = {param_key: params}
    tree.update(extra or {})
    _write(path, msgpack_serialize(tree))


def save_state(path: str, state: dict):
    """A training state: the tree of bem_tpu's ``TrainState`` (step, params,
    opt_state, rng, ema_params, bayes_prior), as ``flax.serialization.to_bytes``
    writes it (checkpoint.py:44)."""
    _write(path, msgpack_serialize(state))


def load_state(path: str) -> dict:
    """A training state's tree (checkpoint.py:52; the trainer maps it onto
    itself, where bem_tpu restores it onto a template)."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def find_latest_state(state_dir: str) -> Optional[str]:
    """The ``<iter>.state`` file of the largest iter in ``state_dir``, None
    where there is none (checkpoint.py:57)."""
    if not os.path.isdir(state_dir):
        return None
    best, best_iter = None, -1
    for name in os.listdir(state_dir):
        m = re.fullmatch(r"(\d+)\.state", name)
        if m and int(m.group(1)) > best_iter:
            best_iter, best = int(m.group(1)), os.path.join(state_dir, name)
    return best
