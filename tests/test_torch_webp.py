"""WebP decoding (``utils/webp_codec.py``) against cv2.imdecode, 0 LSB.

Files come from ``cv2.imencode('.webp', ...)`` in the test: lossy at
qualities 1-100, lossless (quality 101), with alpha (lossy + ``ALPH``,
lossless with the alpha channel), at small odd sizes, under the three read
flags; hypothesis draws more. ``ALPH`` chunks with each of the four
filters, raw, are built in the test around a cv2 lossy frame (cv2's
encoder picks the filter itself). The committed fixtures
(``bem_tpu_torch/testdata/g_lossy_q80.webp``, 400x600;
``{h_lossless,i_alpha}.webp``, 112x144 crops: the test data stays under 1
MiB) equal cv2's decode committed beside them as PNG. Refused: animated WebP
(cv2 reads the first frame), an EXIF orientation, truncated and non-WebP
data, each raising a ValueError naming the file.
"""

import os
import struct

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from bem_tpu_torch.utils.img_util import imfrombytes, imread
from bem_tpu_torch.utils.webp_codec import decode_webp

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

FLAGS = {"color": cv2.IMREAD_COLOR, "grayscale": cv2.IMREAD_GRAYSCALE,
         "unchanged": cv2.IMREAD_UNCHANGED}
TESTDATA = os.path.join(os.path.dirname(__file__), "..", "bem_tpu_torch", "testdata")


def _image(h, w, channels=3, seed=0):
    """Smooth gradients with noise (and an alpha ramp)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    chans = [(xx * rng.integers(1, 6) + yy * rng.integers(0, 6) + rng.integers(0, 256)) % 256
             for _ in range(channels)]
    img = np.stack(chans, -1) + rng.integers(-30, 31, (h, w, channels))
    return np.clip(img, 0, 255).astype(np.uint8)


def _encode(img, quality):
    ok, buf = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return buf.tobytes()


def _cv2(data, flag):
    want = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS[flag])
    if want.ndim == 3:  # BGR(A) -> RGB(A)
        want = want[..., [2, 1, 0, 3][:want.shape[2]]]
    return want


def _same(data, flag):
    want, got = _cv2(data, flag), imfrombytes(data, flag, name="x.webp")
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("quality", [1, 25, 50, 75, 90, 100])
def test_lossy(flag, quality):
    _same(_encode(_image(37, 53, seed=quality), quality), flag)


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("shape", [(37, 53), (1, 1), (2, 3), (17, 16), (5, 130), (64, 33)])
def test_lossless_and_odd_sizes(flag, shape):
    for quality in (101, 60):
        _same(_encode(_image(*shape, seed=shape[0]), quality), flag)


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("quality", [101, 90, 40])
def test_alpha(flag, quality):
    _same(_encode(_image(37, 53, 4, seed=quality), quality), flag)


@settings(max_examples=20, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 48), w=st.integers(1, 48), channels=st.sampled_from([3, 4]),
       quality=st.integers(1, 101), seed=st.integers(0, 2 ** 16), noise=st.booleans())
def test_drawn_images(h, w, channels, quality, seed, noise):
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 256, (h, w, channels)).astype(np.uint8) if noise
           else _image(h, w, channels, seed))
    data = _encode(img, quality)
    for flag in FLAGS:
        _same(data, flag)


def _riff(*chunks):
    body = b"WEBP" + b"".join(tag + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1)
                              for tag, p in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _vp8x(w, h, flags):
    return b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (
        h - 1).to_bytes(3, "little")


def _forward_filter(a, kind):
    """The encoder's side of the alpha filters (libwebp filters.c): the
    residuals the decoder's unfilter inverts."""
    a = a.astype(np.int64)
    h, w = a.shape
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]  # the first row: from the left (its first pixel from 0)
    if kind == 1:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = a[1:, :-1]
    elif kind == 2:
        pred[1:] = a[:-1]
    else:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 0xff).astype(np.uint8)


@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_raw_alpha_filters(filt):
    h, w = 21, 35
    frame = dict(_chunks_of(_encode(_image(h, w, seed=filt), 70)))[b"VP8 "]
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = ((xx * 11 + yy * 7) % 256 if filt % 2 else (xx * yy) % 256).astype(np.uint8)
    res = alpha if filt == 0 else _forward_filter(alpha, filt)
    data = _riff(_vp8x(w, h, 0x10), (b"ALPH", bytes([filt << 2]) + res.tobytes()),
                 (b"VP8 ", frame))
    for flag in FLAGS:
        _same(data, flag)
    np.testing.assert_array_equal(decode_webp(data, "x", "unchanged")[..., 3], alpha)


def _chunks_of(data):
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


@pytest.mark.parametrize("stem,shape", [("g_lossy_q80", (400, 600, 3)),
                                        ("h_lossless", (112, 144, 3)),
                                        ("i_alpha", (112, 144, 4))])
def test_fixtures(stem, shape):
    """The committed fixtures read through ``imread`` equal cv2's decode,
    committed beside them as PNG (read unchanged)."""
    path = os.path.join(TESTDATA, stem + ".webp")
    want = imread(os.path.join(TESTDATA, stem + ".png"), float32=False, flag="unchanged")
    got = imread(path, float32=False, flag="unchanged")
    assert got.shape == want.shape == shape
    np.testing.assert_array_equal(got, want)


def test_refusals(tmp_path):
    img = _image(16, 20)
    anim = cv2.Animation()
    anim.frames, anim.durations = [img, img[::-1].copy()], [100, 100]
    ok, buf = cv2.imencodeanimation(".webp", anim)
    assert ok and cv2.imdecode(buf, cv2.IMREAD_COLOR) is not None  # cv2: the first frame
    with pytest.raises(ValueError, match="a.webp: an animated WebP"):
        imfrombytes(buf.tobytes(), name="a.webp")
    still = _encode(img, 80)
    frame = dict(_chunks_of(still))[b"VP8 "]
    exif = b"II*\0" + struct.pack("<IH", 8, 1) + struct.pack("<HHII", 0x112, 3, 1, 6) + bytes(4)
    data = _riff(_vp8x(20, 16, 0x08), (b"VP8 ", frame), (b"EXIF", exif))
    with pytest.raises(ValueError, match="e.webp: a WebP with an EXIF orientation"):
        imfrombytes(data, name="e.webp")
    for cut in (20, len(still) - 40):
        with pytest.raises(ValueError, match="t.webp: "):
            imfrombytes(still[:cut], name="t.webp")
    with pytest.raises(ValueError, match="n.webp: "):
        decode_webp(b"RIFF\x04\0\0\0WAVE", "n.webp")
    path = tmp_path / "x.webp"
    path.write_bytes(_riff(_vp8x(20, 16, 0x10)))
    with pytest.raises(ValueError, match=f"{path}: a WebP without a VP8 or VP8L image chunk"):
        imread(str(path))
