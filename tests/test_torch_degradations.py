"""The port's degradations and JPEG encoder against bem_tpu's (and cv2's).

- Every kernel generator (the deterministic bivariate kernels, their
  ``random_*`` forms, ``random_mixed_kernels`` over each type and
  ``circular_lowpass_kernel``) and every noise form (Gaussian and Poisson,
  colour and grey, clip / round) bit for bit: bem_tpu draws from Python's
  and numpy's global generators, the port from ``random.Random`` /
  ``np.random.RandomState`` seeded with the same number.
- The grey Poisson noise counts its levels on cv2's BGR -> grey; the port
  follows OpenCV's own float32 code, so bem_tpu runs with IPP off here
  (cv2's IPP build rounds some greys one ulp apart).
- ``add_jpg_compression`` (the port's encoder, then its decoder) equal to
  bem_tpu's cv2 round trip at qualities 10 / 30 / 50 / 75 / 90 / 95 / 100,
  at even and odd sizes; the encoder's bytes decode the same under
  ``cv2.imdecode``, and its quantization tables are cv2's.
"""

import math
import random

import cv2
import numpy as np
import pytest

import bem_tpu.data.degradations as bem
from bem_tpu_torch.data import degradations as port
from bem_tpu_torch.utils.cv_ops import bgr2gray
from bem_tpu_torch.utils.image_writers import encode_jpeg, jpeg_quant_tables

KTYPES = ("iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso",
          "plateau_aniso")


@pytest.fixture(autouse=True)
def opencv_own_code():
    use = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(use)


def _seed_bem(seed):
    random.seed(seed)
    np.random.seed(seed)


def _gens(seed):
    return dict(rng=np.random.RandomState(seed), py_rng=random.Random(seed))


def _image(seed, h=37, w=53):
    return (np.random.default_rng(seed).integers(0, 256, (h, w, 3)) / 255.0).astype(np.float32)


def test_deterministic_kernels():
    for ks, sx, sy, th, beta in [(21, 2.0, 0.7, 0.4, 0.8), (7, 0.3, 3.0, -1.2, 2.5),
                                 (15, 1.1, 1.1, 0.0, 1.0)]:
        for iso in (True, False):
            np.testing.assert_array_equal(port.bivariate_gaussian(ks, sx, sy, th, isotropic=iso),
                                          bem.bivariate_gaussian(ks, sx, sy, th, isotropic=iso))
            np.testing.assert_array_equal(
                port.bivariate_generalized_gaussian(ks, sx, sy, th, beta, isotropic=iso),
                bem.bivariate_generalized_gaussian(ks, sx, sy, th, beta, isotropic=iso))
            np.testing.assert_array_equal(
                port.bivariate_plateau(ks, sx, sy, th, beta, isotropic=iso),
                bem.bivariate_plateau(ks, sx, sy, th, beta, isotropic=iso))
        for cutoff, pad in ((math.pi / 3, 0), (2.9, 21), (0.7, 0)):
            np.testing.assert_array_equal(port.circular_lowpass_kernel(cutoff, ks, pad),
                                          bem.circular_lowpass_kernel(cutoff, ks, pad))
    np.testing.assert_array_equal(port.mesh_grid(5)[0], bem._mesh_grid(5)[0])
    np.testing.assert_array_equal(port.sigma_matrix2(1.5, 0.5, 0.3),
                                  bem._sigma_matrix2(1.5, 0.5, 0.3))


@pytest.mark.parametrize("ktype", KTYPES)
def test_random_mixed_kernels(ktype):
    """Each kernel type, with and without multiplicative noise, at the
    Real-ESRGAN x4plus ranges, over several seeds."""
    for seed in range(6):
        for noise in (None, (0.75, 1.25)):
            args = ([ktype], [1.0], 21, (0.2, 3), (0.2, 3), (-math.pi, math.pi), (0.5, 4),
                    (1, 2), noise)
            _seed_bem(seed)
            want = bem.random_mixed_kernels(*args)
            got = port.random_mixed_kernels(*args, **_gens(seed))
            np.testing.assert_array_equal(got, want)
    probs = [0.45, 0.25, 0.12, 0.03, 0.12, 0.03]
    for seed in range(20):  # the type drawn from the mixture
        _seed_bem(seed)
        want = bem.random_mixed_kernels(list(KTYPES), probs, 15)
        np.testing.assert_array_equal(port.random_mixed_kernels(list(KTYPES), probs, 15,
                                                                **_gens(seed)), want)


def test_random_kernel_forms():
    for seed in range(4):
        for iso in (True, False):
            _seed_bem(seed)
            want = bem.random_bivariate_gaussian(11, (0.5, 2), (0.5, 2), (-1, 1), (0.9, 1.1), iso)
            got = port.random_bivariate_gaussian(11, (0.5, 2), (0.5, 2), (-1, 1), (0.9, 1.1),
                                                 iso, rng=np.random.RandomState(seed))
            np.testing.assert_array_equal(got, want)
            _seed_bem(seed)
            want = bem.random_bivariate_generalized_gaussian(9, (0.5, 2), (0.5, 2), (-1, 1),
                                                             (0.5, 4), None, iso)
            got = port.random_bivariate_generalized_gaussian(
                9, (0.5, 2), (0.5, 2), (-1, 1), (0.5, 4), None, iso,
                rng=np.random.RandomState(seed))
            np.testing.assert_array_equal(got, want)
            _seed_bem(seed)
            want = bem.random_bivariate_plateau(13, (0.5, 2), (0.5, 2), (-1, 1), (1, 2),
                                                (0.8, 1.2), iso)
            got = port.random_bivariate_plateau(13, (0.5, 2), (0.5, 2), (-1, 1), (1, 2),
                                                (0.8, 1.2), iso, rng=np.random.RandomState(seed))
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gray", [False, True])
def test_gaussian_noise(gray):
    img = _image(1)
    for seed in range(3):
        np.random.seed(seed)
        want = bem.generate_gaussian_noise(img, 7.5, gray)
        got = port.generate_gaussian_noise(img, 7.5, gray, rng=np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)
        for clip, rounds in ((True, False), (True, True), (False, True), (False, False)):
            np.random.seed(seed)
            want = bem.add_gaussian_noise(img, 20, clip, rounds, gray)
            got = port.add_gaussian_noise(img, 20, clip, rounds, gray,
                                          rng=np.random.RandomState(seed))
            np.testing.assert_array_equal(got, want)
        np.random.seed(seed)
        want = bem.random_add_gaussian_noise(img, (1, 30), 0.4 if gray else 0.0)
        got = port.random_add_gaussian_noise(img, (1, 30), 0.4 if gray else 0.0,
                                             rng=np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gray", [False, True])
def test_poisson_noise(gray):
    """The level count comes from np.unique of the (grey) image: a grey one
    ulp off cv2 would change it, so the images here are 8-bit values (as
    the dataset reads them) and random floats, at widths off the vector
    width."""
    for seed, img in enumerate((_image(2), _image(3, 64, 48),
                                np.random.default_rng(4).random((29, 61, 3), np.float32))):
        if gray:
            np.testing.assert_array_equal(bgr2gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
        np.random.seed(seed)
        want = bem.generate_poisson_noise(img, 0.8, gray)
        got = port.generate_poisson_noise(img, 0.8, gray, rng=np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)
        for clip, rounds in ((True, False), (True, True), (False, True)):
            np.random.seed(seed)
            want = bem.add_poisson_noise(img, 1.5, clip, rounds, gray)
            got = port.add_poisson_noise(img, 1.5, clip, rounds, gray,
                                         rng=np.random.RandomState(seed))
            np.testing.assert_array_equal(got, want)
        np.random.seed(seed)
        want = bem.random_add_poisson_noise(img, (0.05, 3), 0.5)
        got = port.random_add_poisson_noise(img, (0.05, 3), 0.5, rng=np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [10, 30, 50, 75, 90, 95, 100])
def test_jpeg_round_trip(quality):
    """add_jpg_compression equal to bem_tpu's (cv2.imencode -> imdecode) at
    even, odd and sub-MCU sizes; cv2 decodes the encoder's bytes to the
    same pixels; the DQT tables are cv2's."""
    rng = np.random.default_rng(quality)
    for h, w in ((48, 64), (37, 53), (16, 16), (9, 23), (1, 1), (100, 75)):
        noisy = rng.random((h, w, 3)).astype(np.float32)
        smooth = cv2.GaussianBlur(noisy, (7, 7), 0)
        for img in (noisy, smooth, noisy * 1.4 - 0.2):  # the last one needs the clip
            want = bem.add_jpg_compression(img, quality)
            got = port.add_jpg_compression(img, quality)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=f"q{quality} {h}x{w}")
            u8 = (np.clip(img, 0, 1) * 255.0).astype(np.uint8)
            data = encode_jpeg(np.ascontiguousarray(u8[..., ::-1]), quality)
            ref = cv2.imdecode(cv2.imencode(".jpg", u8, [cv2.IMWRITE_JPEG_QUALITY, quality])[1], 1)
            np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), 1), ref)
    cv_bytes = cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8),
                            [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
    luma, chroma = jpeg_quant_tables(quality)
    zz = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40,
                   48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29,
                   22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
                   47, 55, 62, 63])
    for tq, table in enumerate((luma, chroma)):
        assert bytes([0xFF, 0xDB, 0, 67, tq]) + bytes(table[zz].astype(np.uint8)) in cv_bytes


def test_random_jpg_compression():
    img = _image(5, 40, 40)
    for seed in range(3):
        np.random.seed(seed)
        want = bem.random_add_jpg_compression(img, (30, 95))
        got = port.random_add_jpg_compression(img, (30, 95), rng=np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)


def test_encoder_rejects_other_inputs():
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError, match="odd kernel_size"):
        port.circular_lowpass_kernel(1.0, 8)
