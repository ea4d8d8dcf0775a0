"""bem_tpu's read flags in the port: ``imfrombytes(content, flag)`` for
"color", "grayscale" and "unchanged", ``imfrombytesDP`` and ``padding_DP``
against bem_tpu's (``cv2.imdecode``), bit for bit, codec by codec, and the
port's ``resize_linear`` against ``cv2.resize``:

- Grey differs by codec in cv2 and each is held on its own: a JPEG's Y
  plane (libjpeg's JCS_GRAYSCALE, the chroma never upsampled), libpng's
  rgb-to-gray for PNG (truncated at 8 bits, rounded at 16 bits, a palette
  looked up first), cvtColor's fixed point for BMP and TIFF.
- ``unchanged`` keeps 2-D grey, alpha (PNG tRNS included) and 16 bits, and
  skips the EXIF orientation; ``float32`` divides by 255, ``imfrombytesDP``
  by 65535 (16-bit PNG and TIFF dual-pixel frames).
- Refused: a greyscale read of a colour PNG carrying gAMA or sRGB; WebP,
  PNM, Sun raster, HDR and JPEG 2000 files cv2 writes (each names the file).
- ``resize_linear``: uint8 bit for bit against cv2 as built (cv2 does not
  take IPP for uint8 INTER_LINEAR); float32 bit for bit against cv2 with
  IPP off (cv2's own code; with IPP on a float32 resize moves by float32
  ulps, the difference Dataset_SIDImage states).
"""

import struct

import cv2
import numpy as np
import pytest

from bem_tpu.utils.img_util import imfrombytes as bem_imfrombytes
from bem_tpu.utils.img_util import imfrombytesDP as bem_imfrombytesDP
from bem_tpu.utils.img_util import padding_DP as bem_padding_DP
from bem_tpu_torch.utils.image_writers import (bmp_rows, encode_bmp, encode_png_samples,
                                               encode_tiff)
from bem_tpu_torch.utils.img_util import imfrombytes, imfrombytesDP, padding_DP, resize_linear

from test_torch_jpeg import _pil_jpeg, scene

FLAGS = ("color", "grayscale", "unchanged")


def _rgb(img):
    if img.ndim == 3:
        return img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def same(data, flag, float32=False):
    want = _rgb(bem_imfrombytes(data, flag, float32))
    got = imfrombytes(data, flag, float32, name="x")
    assert got.shape == want.shape and got.dtype == want.dtype, (flag, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    return got


def _png_cases(rng):
    h, w = 9, 13
    yield "grey8", encode_png_samples(rng.integers(0, 256, (h, w, 1)), 0, 8)
    yield "grey16", encode_png_samples(rng.integers(0, 65536, (h, w, 1)), 0, 16)
    yield "grey2", encode_png_samples(rng.integers(0, 4, (h, w, 1)), 0, 2)
    yield "grey_alpha16", encode_png_samples(rng.integers(0, 65536, (h, w, 2)), 4, 16)
    yield "rgb8", encode_png_samples(rng.integers(0, 256, (h, w, 3)), 2, 8)
    rgb16 = rng.integers(0, 65536, (h, w, 3))
    yield "rgb16", encode_png_samples(rgb16, 2, 16)
    yield "rgb16_trns", encode_png_samples(rgb16, 2, 16,
                                           trns=struct.pack(">HHH", *map(int, rgb16[1, 2])))
    yield "rgba16_laced", encode_png_samples(rng.integers(0, 65536, (h, w, 4)), 6, 16, True)
    pal = rng.integers(0, 256, (16, 3))
    yield "palette_trns", encode_png_samples(rng.integers(0, 16, (h, w, 1)), 3, 4, palette=pal,
                                             trns=bytes(range(0, 160, 20)))


def _bmp_cases(rng):
    h, w = 9, 13
    p = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    yield "bmp24", encode_bmp(bmp_rows([r[:, :3].tobytes() for r in p[::-1]]), w, h, 24)
    yield "bmp32_masks", encode_bmp(bmp_rows([r.tobytes() for r in p[::-1]]), w, h, 32, 3,
                                    header=124, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    yield "bmp32_os2", encode_bmp(bmp_rows([r.tobytes() for r in p[::-1]]), w, h, 32, header=12)
    v = rng.integers(0, 1 << 16, (h, w)).astype("<u2")
    yield "bmp565", encode_bmp(bmp_rows([r.tobytes() for r in v[::-1]]), w, h, 16, 3,
                               masks=(0xF800, 0x7E0, 0x1F))
    ok, buf = cv2.imencode(".bmp", p[..., 0])
    yield "bmp_grey_palette", buf.tobytes()


def _tiff_cases(rng):
    h, w = 9, 13
    yield "tiff_rgb16", encode_tiff(rng.integers(0, 65536, (h, w, 3)), 2, 16, 8, 2)
    yield "tiff_grey16", encode_tiff(rng.integers(0, 65536, (h, w, 1)), 1, 16, 5)
    yield "tiff_rgba_unassoc", encode_tiff(rng.integers(0, 256, (h, w, 4)), 2, 8, 32773,
                                           extra_samples=(2,))
    yield "tiff_palette", encode_tiff(rng.integers(0, 256, (h, w, 1)), 3, 8, 8,
                                      colormap=rng.integers(0, 65536, (3, 256)))
    yield "tiff_orient6", encode_tiff(rng.integers(0, 256, (h, w, 3)), 2, 8, 8, orientation=6)


def _jpeg_cases(rng):
    img = scene(int(rng.integers(100)), 19, 26)
    ok, buf = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    yield "jpeg_prog_420", buf.tobytes()
    ok, buf = cv2.imencode(".jpg", img[..., 0])
    yield "jpeg_grey", buf.tobytes()
    yield "jpeg_exif6", _pil_jpeg(img, 6, quality=90, subsampling=1)


CODECS = {"png": _png_cases, "bmp": _bmp_cases, "tiff": _tiff_cases, "jpeg": _jpeg_cases}


@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("flag", FLAGS)
def test_flag_matches_bem_tpu(codec, flag):
    for _, data in CODECS[codec](np.random.default_rng(len(codec))):
        got = same(data, flag)
        if flag == "grayscale":
            assert got.ndim == 2
        same(data, flag, float32=True)


def test_unchanged_keeps_depth_alpha_and_grey():
    rng = np.random.default_rng(1)
    cases = dict(_png_cases(rng), **dict(_tiff_cases(rng)), **dict(_bmp_cases(rng)),
                 **dict(_jpeg_cases(rng)))
    shapes = {name: imfrombytes(data, "unchanged").shape for name, data in cases.items()}
    dtypes = {name: imfrombytes(data, "unchanged").dtype for name, data in cases.items()}
    assert shapes["grey16"] == (9, 13) and dtypes["grey16"] == np.uint16
    assert shapes["grey_alpha16"] == (9, 13, 4) and dtypes["grey_alpha16"] == np.uint16
    assert shapes["rgb16_trns"] == (9, 13, 4) and shapes["palette_trns"] == (9, 13, 4)
    assert shapes["tiff_rgb16"] == (9, 13, 3) and dtypes["tiff_rgb16"] == np.uint16
    assert shapes["tiff_orient6"] == (13, 9, 3)  # a TIFF's own Orientation still applies
    assert shapes["bmp32_masks"] == (9, 13, 4) and shapes["bmp_grey_palette"] == (9, 13)
    assert shapes["bmp32_os2"] == (9, 13)  # cv2 reads an OS/2 BMP as grey here
    assert shapes["jpeg_exif6"] == (19, 26, 3) and shapes["jpeg_grey"] == (19, 26)


@pytest.mark.parametrize("kind", ["png", "tiff"])
def test_imfrombytesDP_and_padding_DP(kind):
    rng = np.random.default_rng(2)
    frames = []
    for hw in ((11, 7), (11, 7), (11, 7)):
        s = rng.integers(0, 65536, (*hw, 3))
        data = encode_png_samples(s, 2, 16) if kind == "png" else encode_tiff(s, 2, 16, 8, 2)
        want = _rgb(bem_imfrombytesDP(data, float32=True))
        got = imfrombytesDP(data, float32=True, name="x")
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(imfrombytesDP(data), s)
        frames.append(got)
    for gt_size in (8, 16):
        for got, want in zip(padding_DP(*frames, gt_size), bem_padding_DP(*frames, gt_size)):
            np.testing.assert_array_equal(got, want)
    grey = [f[..., :1] for f in frames]  # cv2 pads an (H, W, 1) frame to 2-D
    for got, want in zip(padding_DP(*grey, 16), bem_padding_DP(*grey, 16)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_grey_png_with_gamma_is_refused():
    rng = np.random.default_rng(3)
    s = rng.integers(0, 256, (5, 7, 3))
    for chunk in ((b"gAMA", struct.pack(">I", 45455)), (b"sRGB", b"\0")):
        data = encode_png_samples(s, 2, 8, chunks=[chunk])
        same(data, "color")
        same(data, "unchanged")
        with pytest.raises(ValueError, match="g.png: a greyscale read of a colour PNG"):
            imfrombytes(data, "grayscale", name="g.png")
    same(encode_png_samples(s, 2, 8, chunks=[(b"gAMA", struct.pack(">I", 100000))]), "grayscale")


@pytest.mark.parametrize("ext,kind", [(".webp", "WebP"), (".ppm", "PNM"), (".pgm", "PNM"),
                                      (".ras", "Sun raster"), (".hdr", "HDR"),
                                      (".jp2", "JPEG 2000")])
def test_other_formats_raise_naming_the_file(ext, kind):
    img = np.random.default_rng(4).integers(0, 256, (64, 64, 3)).astype(np.uint8)
    ok, buf = cv2.imencode(ext, img if ext != ".pgm" else img[..., 0])
    assert ok and cv2.imdecode(buf, cv2.IMREAD_COLOR) is not None
    with pytest.raises(ValueError, match=f"f{ext}: {kind}"):
        imfrombytes(buf.tobytes(), name=f"f{ext}")


SIZES = [((37, 53), (16, 16)), ((37, 53), (106, 74)), ((37, 53), (26, 18)),
         ((400, 600), (300, 200)), ((400, 600), (901, 267)), ((5, 3), (1, 1)), ((8, 8), (8, 9))]


@pytest.mark.parametrize("src,size", SIZES)
def test_resize_linear_matches_cv2(src, size):
    rng = np.random.default_rng(5)
    for shape in ((*src, 3), src, (*src, 4)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(resize_linear(img, size), cv2.resize(img, size))
        f = img.astype(np.float32) / 255.0
        use = cv2.ipp.useIPP()
        cv2.ipp.setUseIPP(False)
        try:
            want = cv2.resize(f, size)
        finally:
            cv2.ipp.setUseIPP(use)
        got = resize_linear(f, size)
        np.testing.assert_allclose(got, cv2.resize(f, size), rtol=0, atol=5e-5)
        if (src, size) == ((400, 600), (300, 200)) and shape[-1] != 3:
            continue  # cv2's 2x area path orders its sum by channel count: 3 is mirrored
        np.testing.assert_array_equal(got, want)
