"""The port's JPEG decoder (``utils/image_codec.decode_jpeg``) against
``cv2.imdecode(..., IMREAD_COLOR)``: exact, every sample.

- The committed fixtures under ``bem_tpu_torch/testdata/`` (400x600:
  4:2:0 q95; 4:4:4 q90 with restart intervals; grey q85; 4:2:2 written by
  PIL as 600x400 with EXIF Orientation 6), against cv2 and against the
  PNG of cv2's decode committed beside each, which chip_smoke.py holds
  the decoder to on the card's machine (it has no cv2). ``write_fixtures``
  made them.
- Images cv2 and PIL encode here: 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1,
  grey, restart intervals, quality 50 and 95, at 17x23, 400x600 and a size
  under one MCU; PIL's encoder with each subsampling; EXIF orientations
  1-8 (and an out-of-range 9, which cv2 ignores).
- Arithmetic-coded, 12-bit, hierarchical and lossless files raise a
  ValueError naming the file (progressive and CMYK ones are read:
  test_torch_jpeg_progressive.py).
"""

import io
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from bem_tpu_torch.utils.image_codec import decode_jpeg
from bem_tpu_torch.utils.img_util import imread

TESTDATA = os.path.join(os.path.dirname(__file__), "..", "bem_tpu_torch", "testdata")
FIXTURES = ("a_420_q95", "b_444_dri", "c_grey", "d_422_exif6")


def scene(seed, h=400, w=600):
    """Smooth seeded content, dim as a low-light input, with a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    f = rng.uniform(2, 7, (3, 4))
    ph = rng.uniform(0, 6.3, (3, 2))
    img = np.stack([0.35 + 0.25 * np.sin(f[c, 0] * x + f[c, 1] * y + ph[c, 0])
                    * np.cos(f[c, 2] * x - f[c, 3] * y + ph[c, 1]) for c in range(3)], -1)
    img *= 0.4 + 0.6 * np.exp(-((x - 0.5) ** 2 + (y - 0.35) ** 2) * 6)[..., None]
    return np.clip(img * 255 + rng.normal(0, 1.5, img.shape), 0, 255).astype(np.uint8)


def _cv2_jpeg(rgb, quality, sampling=None, rst=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    if rst:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1] if rgb.ndim == 3 else rgb, params)
    assert ok
    return buf.tobytes()


def _pil_jpeg(rgb, orientation=None, **kw):
    exif = Image.Exif()
    if orientation is not None:
        exif[0x0112] = orientation
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, "JPEG", exif=exif.tobytes(), **kw)
    return b.getvalue()


def write_fixtures(d):
    """The committed fixtures and the PNGs of cv2's decodes."""
    files = {
        "a_420_q95": _cv2_jpeg(scene(1), 95, "420"),
        "b_444_dri": _cv2_jpeg(scene(2), 90, "444", rst=7),
        "c_grey": _cv2_jpeg(scene(3)[..., 1], 85),
        "d_422_exif6": _pil_jpeg(np.ascontiguousarray(np.rot90(scene(4), 1)), 6,
                                 quality=90, subsampling=1),
    }
    for stem, data in files.items():
        with open(os.path.join(d, f"{stem}.jpg"), "wb") as f:
            f.write(data)
        cv2.imwrite(os.path.join(d, f"{stem}.png"), np.ascontiguousarray(_cv2(data)[..., ::-1]),
                    [cv2.IMWRITE_PNG_COMPRESSION, 9])


def _cv2(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


def _same(data, name="<jpeg>"):
    want = _cv2(data)
    got = decode_jpeg(data, name)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("stem", FIXTURES)
def test_fixtures_match_cv2_and_their_png(stem):
    path = os.path.join(TESTDATA, f"{stem}.jpg")
    with open(path, "rb") as f:
        got = _same(f.read(), path)
    assert got.shape == (400, 600, 3)
    np.testing.assert_array_equal(got, imread(path, float32=False))
    np.testing.assert_array_equal(got, imread(path[:-4] + ".png", float32=False))


def test_fixtures_stay_small():
    assert sum(os.path.getsize(os.path.join(TESTDATA, f)) for f in os.listdir(TESTDATA)) < 1 << 20


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411"])
@pytest.mark.parametrize("hw", [(17, 23), (5, 3)])
def test_cv2_encodes(hw, sampling, quality):
    _same(_cv2_jpeg(scene(5, *hw), quality, sampling))


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440"])
def test_cv2_encodes_400x600(sampling):
    img = scene(5)
    for quality in (50, 95):
        _same(_cv2_jpeg(img, quality, sampling))


@pytest.mark.parametrize("hw", [(17, 23), (400, 600)])
def test_grey_and_restart_intervals(hw):
    img = scene(6, *hw)
    _same(_cv2_jpeg(img[..., 0], 95))
    for rst in (1, 3):
        _same(_cv2_jpeg(img, 90, "420", rst=rst))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_pil_encodes(subsampling):
    _same(_pil_jpeg(scene(7, 33, 47), quality=80, subsampling=subsampling))
    _same(_pil_jpeg(scene(7, 33, 47)[..., 2], quality=70))


@pytest.mark.parametrize("orientation", range(1, 10))
def test_exif_orientation(orientation):
    got = _same(_pil_jpeg(scene(8, 40, 60), orientation, quality=90))
    assert got.shape == ((60, 40, 3) if 5 <= orientation <= 8 else (40, 60, 3))


def test_unsupported_kinds_raise_naming_the_file(tmp_path):
    img = scene(9, 16, 16)
    base = _cv2_jpeg(img, 90)
    sof = base.index(b"\xff\xc0")
    path = tmp_path / "hier.jpg"
    path.write_bytes(base[:sof + 1] + b"\xc5" + base[sof + 2:])
    with pytest.raises(ValueError, match=f"{path}: a hierarchical"):
        imread(str(path))
    with pytest.raises(ValueError, match="x.jpg: a arithmetic-coded JPEG"):
        decode_jpeg(base[:sof + 1] + b"\xc9" + base[sof + 2:], "x.jpg")
    twelve = bytearray(base)
    twelve[sof + 4] = 12  # the frame's sample precision
    with pytest.raises(ValueError, match="y.jpg: a 12-bit JPEG"):
        decode_jpeg(bytes(twelve), "y.jpg")
    with pytest.raises(ValueError, match="z.jpg: a lossless JPEG"):
        decode_jpeg(base[:sof + 1] + b"\xc3" + base[sof + 2:], "z.jpg")
