"""The port's progressive and four-component JPEG decoding against bem_tpu's
``imfrombytes`` (``cv2.imdecode``), bit for bit, under the color,
grayscale and unchanged flags:

- cv2's progressive encoder at every sampling factor it offers (4:4:4,
  4:2:2, 4:2:0, 4:4:0, 4:1:1) and grey, at 1x1, 8x8, 17x9 and 37x53, with
  restart intervals and optimised Huffman tables; one 400x600 file;
  Pillow's progressive encoder; EXIF orientations under each flag.
- CMYK (Adobe transform 0, stored inverted, as Pillow writes it) baseline
  and progressive; YCCK (the same files with the Adobe transform set to 2,
  which cv2 decodes as YCCK); a three-component JPEG with the component
  ids R, G, B and no JFIF marker (libjpeg takes it as RGB).
- The committed 400x600 fixtures ``e_420_prog`` (progressive 4:2:0) and
  ``f_cmyk`` (CMYK) against the PNGs of cv2's decodes beside them, which
  ``chip_smoke.py`` holds the decoder to on the card's machine (no cv2
  there). ``write_fixtures`` made them.
- Refused with a ValueError naming the file: an arithmetic-coded (SOF9)
  header, a 12-bit SOF1 header, a lossless (SOF3) header, and a
  progressive file whose scans stop before the last refinement (libjpeg
  smooths its blocks; cv2 decodes it).
"""

import io
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from bem_tpu.utils.img_util import imfrombytes as bem_imfrombytes
from bem_tpu_torch.utils.img_util import imfrombytes, imread

from test_torch_cpu_setup import one_torch_thread  # noqa: F401  (module fixture)
from test_torch_jpeg import TESTDATA, _pil_jpeg, scene

FLAGS = ("color", "grayscale", "unchanged")
SAMPLING = ("444", "422", "420", "440", "411")
SIZES = [(1, 1), (8, 8), (17, 9), (37, 53)]
NEW_FIXTURES = ("e_420_prog", "f_cmyk")


def _rgb(img):
    return img[..., ::-1] if img.ndim == 3 else img


def same(data, name="x.jpg"):
    """Each flag's port read equals bem_tpu's; returns them by flag."""
    out = {}
    for flag in FLAGS:
        want = _rgb(bem_imfrombytes(data, flag))
        got = imfrombytes(data, flag, name=name)
        assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, flag
        np.testing.assert_array_equal(got, want, err_msg=flag)
        out[flag] = got
    return out


def progressive(rgb, sampling="420", quality=90, rst=0, optimize=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
              cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize), cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    if rgb.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1] if rgb.ndim == 3 else rgb, params)
    assert ok
    return buf.tobytes()


def cmyk(rgb, **kw):
    b = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(b, "JPEG", **kw)
    return b.getvalue()


def write_fixtures(d):
    """The committed fixtures and the PNGs of cv2's decodes."""
    files = {"e_420_prog": progressive(scene(11), "420", 90, optimize=True),
             "f_cmyk": cmyk(scene(12), quality=85)}
    for stem, data in files.items():
        with open(os.path.join(d, f"{stem}.jpg"), "wb") as f:
            f.write(data)
        cv2.imwrite(os.path.join(d, f"{stem}.png"), bem_imfrombytes(data),
                    [cv2.IMWRITE_PNG_COMPRESSION, 9])


@pytest.mark.parametrize("sampling", SAMPLING)
@pytest.mark.parametrize("hw", SIZES)
def test_cv2_progressive(hw, sampling):
    img = scene(20, *hw)
    for rst in (0, 1, 3):
        for optimize in (False, True):
            same(progressive(img, sampling, 90, rst, optimize))
    same(progressive(img, sampling, 40))


@pytest.mark.parametrize("hw", SIZES + [(400, 600)])
def test_grey_and_400x600(hw):
    img = scene(21, *hw)
    got = same(progressive(img[..., 1], quality=85, rst=2))
    assert got["unchanged"].ndim == 2
    if hw == (400, 600):
        same(progressive(img, "420", 95))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_pil_progressive(subsampling):
    img = scene(22, 33, 47)
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", progressive=True, quality=80, subsampling=subsampling)
    same(b.getvalue())
    b = io.BytesIO()
    Image.fromarray(img[..., 0]).save(b, "JPEG", progressive=True, quality=75)
    same(b.getvalue())


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_each_flag(orientation):
    img = scene(23, 24, 40)
    got = same(_pil_jpeg(img, orientation, quality=90, progressive=True))
    rotated = 5 <= orientation <= 8
    assert got["color"].shape == ((40, 24, 3) if rotated else (24, 40, 3))
    assert got["grayscale"].shape == got["color"].shape[:2]
    assert got["unchanged"].shape == (24, 40, 3)  # unchanged skips the orientation
    same(_pil_jpeg(img[..., 2], orientation, quality=90))


@pytest.mark.parametrize("hw", [(1, 1), (17, 9), (37, 53)])
def test_cmyk_and_ycck(hw):
    img = scene(24, *hw)
    for kw in (dict(quality=90), dict(quality=70, progressive=True)):
        data = cmyk(img, **kw)
        same(data)
        ycck = bytearray(data)
        at = ycck.index(b"Adobe")
        assert ycck[at + 11] == 0  # transform 0: CMYK
        ycck[at + 11] = 2
        same(bytes(ycck))


def test_rgb_component_ids():
    img = scene(25, 19, 27)
    ok, buf = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    data = bytearray(buf.tobytes())
    assert data[2:4] == b"\xff\xe0"  # drop the JFIF marker
    data = data[:2] + data[4 + int.from_bytes(data[4:6], "big"):]
    sof, sos = data.index(b"\xff\xc0"), data.index(b"\xff\xda")
    for k, cid in enumerate(b"RGB"):
        data[sof + 10 + 3 * k] = cid
        data[sos + 5 + 2 * k] = cid
    same(bytes(data))


@pytest.mark.parametrize("stem", NEW_FIXTURES)
def test_fixtures_match_cv2_and_their_png(stem):
    path = os.path.join(TESTDATA, f"{stem}.jpg")
    with open(path, "rb") as f:
        got = same(f.read(), path)["color"]
    assert got.shape == (400, 600, 3)
    np.testing.assert_array_equal(got, imread(path, float32=False))
    np.testing.assert_array_equal(got, imread(path[:-4] + ".png", float32=False))


def test_refused_kinds_raise_naming_the_file():
    img = scene(26, 16, 16)
    base = progressive(img, "420")
    sof = base.index(b"\xff\xc2")
    for marker, what in ((b"\xc9", "arithmetic-coded"), (b"\xc3", "lossless")):
        data = base[:sof + 1] + marker + base[sof + 2:]
        with pytest.raises(ValueError, match=f"a.jpg: a {what} JPEG"):
            imfrombytes(data, name="a.jpg")
    ok, buf = cv2.imencode(".jpg", img[..., ::-1])
    twelve = bytearray(buf.tobytes())
    sof = twelve.index(b"\xff\xc0")
    twelve[sof + 1] = 0xC1  # extended sequential
    twelve[sof + 4] = 12    # the frame's sample precision
    for flag in FLAGS:
        with pytest.raises(ValueError, match="b.jpg: a 12-bit JPEG"):
            imfrombytes(bytes(twelve), flag, name="b.jpg")
    # a progressive script cut after its sixth scan: cv2 decodes it with
    # libjpeg's block smoothing, the port refuses it
    data = progressive(scene(27, 64, 64), "420")
    scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    cut = data[:scans[6]] + b"\xff\xd9"
    assert cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR) is not None
    with pytest.raises(ValueError, match="c.jpg: a progressive JPEG whose scans leave"):
        imfrombytes(cut, name="c.jpg")
