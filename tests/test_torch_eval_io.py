"""The eval CLI's readers: the port's PNG / BMP codecs against cv2 (and
PIL for palette and grey + alpha files), its YAML-subset reader and
``parse`` against PyYAML and bem_tpu, and its msgpack checkpoint reader
against flax, down to a converted net's output against bem_tpu's.
"""

import glob
import os
import struct
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from PIL import Image

from bem_tpu.archs import build_network as jax_build
from bem_tpu.utils.checkpoint import save_params
from bem_tpu.utils.options import parse as jax_parse
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import load_flax_params, state_dict_to_flax
from bem_tpu_torch.options import lolv1_options
from bem_tpu_torch.utils import yaml_lite
from bem_tpu_torch.utils.checkpoint import load_params, msgpack_restore
from bem_tpu_torch.utils.image_codec import encode_png
from bem_tpu_torch.utils.img_util import imread, imwrite
from bem_tpu_torch.utils.options import parse, yaml_load

from test_eval_cli import CG_YML, IE_YML

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OPTIONS = sorted(glob.glob(os.path.join(ROOT, "Options", "*.yml")))


def _cv2_rgb(path):
    return cv2.imread(str(path), cv2.IMREAD_COLOR)[:, :, ::-1]


def _rand(rng, *shape, hi=256, dtype=np.uint8):
    return rng.integers(0, hi, shape).astype(dtype)


def _write_cv2(path, a):
    assert cv2.imwrite(str(path), a)


def _write_pil(path, a, mode, **kw):
    Image.fromarray(a).convert(mode, **kw).save(str(path))


@pytest.mark.parametrize("kind,shape", [
    ("rgb", (37, 53)), ("rgb", (1, 1)), ("grey", (7, 13)), ("rgba", (19, 8)),
    ("rgb16", (11, 29)), ("grey16", (12, 5)), ("pal256", (21, 33)), ("pal16", (9, 17)),
    ("pal2", (5, 11)), ("bilevel", (6, 21)), ("grey_alpha", (15, 4)),
])
def test_png_decode_matches_cv2(tmp_path, kind, shape):
    rng = np.random.default_rng(sum(map(ord, kind)) + shape[0])
    path = tmp_path / f"{kind}.png"
    rgb = _rand(rng, *shape, 3)
    if kind == "rgb":
        _write_cv2(path, rgb)
    elif kind == "grey":
        _write_cv2(path, rgb[..., 0])
    elif kind == "rgba":
        _write_cv2(path, _rand(rng, *shape, 4))
    elif kind == "rgb16":
        _write_cv2(path, _rand(rng, *shape, 3, hi=65536, dtype=np.uint16))
    elif kind == "grey16":
        _write_cv2(path, _rand(rng, *shape, hi=65536, dtype=np.uint16))
    elif kind.startswith("pal"):  # PIL writes 1-, 4- and 8-bit palettes
        _write_pil(path, rgb, "P", palette=Image.ADAPTIVE, colors=int(kind[3:]))
    elif kind == "bilevel":
        Image.fromarray(rgb[..., 0] > 127).save(str(path))
    else:
        Image.fromarray(_rand(rng, *shape, 2), mode="LA").save(str(path))
    ours = imread(str(path), float32=False)
    np.testing.assert_array_equal(ours, _cv2_rgb(path))
    np.testing.assert_array_equal(imread(str(path)), ours.astype(np.float32) / 255.0)


def _filter_row(row, prev, ftype, bpp):
    """PNG's forward filters (the decoder's inverse), on one scanline."""
    r, p = row.astype(np.int64), prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), p[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(r)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = p
    elif ftype == 3:
        pred = (a + p) // 2
    else:
        pa, pb, pc = np.abs(p - c), np.abs(a - c), np.abs(a + p - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) & 0xFF).astype(np.uint8)


def _png(w, h, depth, color, rows, interlace=0):
    def chunk(t, b):
        return struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,color,bpp", [(8, 2, 3), (16, 6, 8), (8, 0, 1)])
def test_png_all_five_filters(tmp_path, depth, color, bpp):
    """Every row filter, cycling row by row (Paeth also on the first row)."""
    rng = np.random.default_rng(depth + color)
    h, w = 12, 23
    raw = _rand(rng, h, w * bpp)
    prev = np.zeros(w * bpp, np.uint8)
    rows = b""
    for y in range(h):
        ftype = (4 + y) % 5
        rows += bytes([ftype]) + _filter_row(raw[y], prev, ftype, bpp).tobytes()
        prev = raw[y]
    path = tmp_path / "filters.png"
    path.write_bytes(_png(w, h, depth, color, rows))
    np.testing.assert_array_equal(imread(str(path), float32=False), _cv2_rgb(path))


@pytest.mark.parametrize("shape", [(37, 53), (1, 7), (400, 6)])
def test_png_write_read_back(tmp_path, shape):
    img = _rand(np.random.default_rng(1), *shape, 3)
    path = tmp_path / "sub" / "out.png"
    assert imwrite(img, str(path))
    np.testing.assert_array_equal(_cv2_rgb(path), img)
    np.testing.assert_array_equal(imread(str(path), float32=False), img)


@pytest.mark.parametrize("shape", [(9, 5), (4, 1), (16, 32)])
def test_bmp_matches_cv2(tmp_path, shape):
    path = tmp_path / "x.bmp"
    _write_cv2(path, _rand(np.random.default_rng(2), *shape, 3))
    np.testing.assert_array_equal(imread(str(path), float32=False), _cv2_rgb(path))


def test_unsupported_images_raise_naming_the_file(tmp_path):
    img = _rand(np.random.default_rng(3), 8, 8, 3)
    for ext in ("jpg", "tif"):
        path = tmp_path / f"x.{ext}"
        _write_cv2(path, img)
        with pytest.raises(ValueError, match=f"{path}.*(JPEG|TIFF) decoding is not supported"):
            imread(str(path))
    path = tmp_path / "laced.png"
    rows = b"".join(b"\x00" + r.tobytes() for r in img.reshape(8, 24))
    path.write_bytes(_png(8, 8, 8, 2, rows, interlace=1))
    with pytest.raises(ValueError, match=f"{path}: interlaced PNG"):
        imread(str(path))
    path = tmp_path / "x32.bmp"
    _write_cv2(path, _rand(np.random.default_rng(3), 8, 8, 4))
    with pytest.raises(ValueError, match=f"{path}: only uncompressed 24-bit BMP"):
        imread(str(path))
    with pytest.raises(FileNotFoundError):
        imread(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError, match="PNG only"):
        imwrite(img, str(tmp_path / "x.jpg"))
    with pytest.raises(ValueError, match="uint8"):
        encode_png(img.astype(np.float32))


@pytest.mark.parametrize("path", OPTIONS, ids=os.path.basename)
def test_options_reader_matches_pyyaml_and_bem_tpu(path):
    with open(path) as f:
        assert yaml_lite.load(f.read(), path) == yaml.safe_load(open(path))
    for is_train in (False, True):
        assert parse(path, is_train=is_train) == jax_parse(path, is_train=is_train)


def test_options_reader_flow_yamls_and_traps():
    for text in (CG_YML.format(), IE_YML.format()):
        assert yaml_load(text) == yaml.safe_load(text)
    text = """
a: 1e-4
b: !!float 1e-4
c: !!float 1e3
d: ~
e: '{}'
f: [1, 2.5, yes, off, null, 0x1f, 017, 1_000, '#x', "a\\tb", .inf, -.Inf, 1:30, 0.]
g: {x: 1, 'y': [a, b], z: }
h: "q # not a comment"  # a comment
i: it's
j: &anc
  m: 1
k: *anc
l: !!str 12
m: [a,
  b, {c: d,
  e: f}]
'q r': 3
n: +2
o: 1.5e+3
p: -0
"""
    got, want = yaml_lite.load(text), yaml.safe_load(text)
    assert repr(got) == repr(want)
    assert got["j"] is got["k"]  # aliases share the anchored object, as PyYAML's do
    opt = yaml_load(os.path.join(ROOT, "Options", "CG_UNet_LOLv1.yml"))
    assert opt == lolv1_options("ConditionGenerator")
    assert yaml_load(os.path.join(ROOT, "Options", "IE_UNet_LOLv1.yml")) == lolv1_options(
        "ImageEnhancer")
    assert opt["datasets"]["train"]["condition"] is opt["condition"]
    for bad in ("a:\n  - 1\n", "a: |\n  x\n", "a: b\n  c\n", "a: [1, 2\n", "<<: {}\n",
                "a: !!binary eA==\n", "a: 2020-01-02\n"):
        with pytest.raises(ValueError, match="<yaml>:"):
            yaml_lite.load(bad)


def _tiny(bayesian):
    return dict(type="Network", in_channels=3, out_channels=3, n_feat=8, num_blocks=(1, 1),
                d_state=(1, 1), ssm_ratio=1, mlp_ratio=2, use_pixelshuffle=True,
                bayesian=bayesian)


def test_load_params_matches_flax_and_bem_tpu(tmp_path):
    jnet = jax_build(dict(_tiny(True), scan_backend="xla"))
    x = np.random.default_rng(4).random((1, 16, 24, 3)).astype(np.float32)
    # seeded by the port, written by bem_tpu (no init compile needed)
    params = state_dict_to_flax(build_network(_tiny(True), torch.Generator().manual_seed(3)))
    path = str(tmp_path / "net_g.msgpack")
    save_params(path, params, extra={"step": np.int64(7), "lr": np.float32(2e-4)})
    ours = load_params(path)
    theirs = serialization.msgpack_restore(open(path, "rb").read())["params"]
    flat_o = dict(jax.tree_util.tree_leaves_with_path(ours))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(theirs))
    assert flat_o.keys() == flat_t.keys()
    for k, v in flat_t.items():
        np.testing.assert_array_equal(flat_o[k], v)
        assert flat_o[k].dtype == v.dtype
    net = load_flax_params(build_network(_tiny(True)), ours)
    with torch.no_grad():
        out = net(torch.from_numpy(x))[-1].numpy()
    ref = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x))[-1])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    # the param_key fallback: a one-entry file gives its sole entry
    one = str(tmp_path / "one.msgpack")
    save_params(one, params, param_key="params_ema")
    assert jax.tree_util.tree_structure(load_params(one)) == jax.tree_util.tree_structure(
        params)


def test_msgpack_chunked_scalars_and_types(monkeypatch):
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((5, 7)), "b": jnp.asarray(rng.standard_normal(6),
                                                                jnp.bfloat16),
            "s": np.float32(3.5), "i": np.int64(-9), "n": None, "t": True, "f": 1.25,
            "big": 2 ** 40, "neg": -70000, "str": "x" * 40, "e": np.zeros((0, 3), np.float16),
            "u": {"deep": np.arange(300, dtype=np.int32).reshape(3, 100)}}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)  # chunk "a" and "deep"
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    ours, theirs = msgpack_restore(blob), serialization.msgpack_restore(blob)
    for k, v in jax.tree_util.tree_leaves_with_path(theirs):
        got = dict(jax.tree_util.tree_leaves_with_path(ours))[k]
        np.testing.assert_array_equal(np.asarray(got, np.float64 if k[0].key == "b" else None),
                                      np.asarray(v, np.float64 if k[0].key == "b" else None))
    assert ours["n"] is None and ours["t"] is True and ours["str"] == "x" * 40
    assert isinstance(ours["s"], np.float32) and ours["b"].dtype == np.float32
    with pytest.raises(ValueError, match="trailing bytes"):
        msgpack_restore(blob + b"\x00")
