"""``utils/cv_ops.py`` against cv2 5.0 as installed.

uint8 results bit for bit with OpenCV's own code (``cv2.ipp.setUseIPP(False)``):
resize (nearest, linear, cubic; up and down, odd sizes), warpAffine
(shear, translation, rotation; widths on and off the vector loop's 16),
getRotationMatrix2D, equalizeHist, the 3x3 GaussianBlur; float32
BGR -> grey bit for bit; reflect-101 borders. The float32 51-tap
Gaussian of USM sums in float64 where cv2 sums in float32: held within
1e-6 on [0, 1] images. With IPP on (cv2's default), the cubic resize
stays within 1 of the port's values and grey within 1 float32 ulp.
"""

import cv2
import numpy as np
import pytest

from bem_tpu_torch.utils import cv_ops

SHAPES = [(37, 53, 80, 91), (100, 120, 32, 32), (13, 17, 7, 29), (64, 64, 224, 224),
          (375, 500, 256, 341), (31, 9, 5, 40), (224, 224, 224, 223)]


@pytest.fixture
def own_code():
    use = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(use)


@pytest.mark.parametrize("interp", [cv_ops.INTER_NEAREST, cv_ops.INTER_LINEAR,
                                    cv_ops.INTER_CUBIC])
def test_resize_u8(own_code, interp):
    rng = np.random.default_rng(interp)
    for h, w, oh, ow in SHAPES:
        for img in (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                    rng.integers(0, 256, (h, w), dtype=np.uint8)):
            want = cv2.resize(img, (ow, oh), interpolation=interp)
            np.testing.assert_array_equal(cv_ops.resize(img, (ow, oh), interp), want)
            view = img[1:, ::-1]  # a strided view, as the crops and flips hand it over
            np.testing.assert_array_equal(cv_ops.resize(view, (ow, oh), interp),
                                          cv2.resize(np.ascontiguousarray(view), (ow, oh),
                                                     interpolation=interp))


def test_resize_cubic_under_ipp():
    """cv2's default IPP path: at most 1 away from OpenCV's own code."""
    assert cv2.ipp.useIPP()
    rng = np.random.default_rng(1)
    for h, w, oh, ow in SHAPES[:4]:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        d = cv_ops.resize(img, (ow, oh), cv_ops.INTER_CUBIC).astype(int) - cv2.resize(
            img, (ow, oh), interpolation=cv2.INTER_CUBIC)
        assert np.abs(d).max() <= 1


def _matrices(h, w):
    out = []
    for m in (0.0, 9 / 30, 1.0):
        for sign in (-1, 1):
            out += [np.float32([[1, sign * m, 0], [0, 1, 0]]),
                    np.float32([[1, 0, 0], [sign * m, 1, 0]]),
                    np.float32([[1, 0, sign * m * w / 3], [0, 1, 0]]),
                    np.float32([[1, 0, 0], [0, 1, sign * m * h / 3]]),
                    cv2.getRotationMatrix2D((w / 2, h / 2), sign * m * 30, 1.0)]
    return out


@pytest.mark.parametrize("h,w", [(32, 32), (37, 53), (9, 7), (20, 17), (100, 100),
                                 (224, 224), (31, 63)])
def test_warp_affine(own_code, h, w):
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    grey = rng.integers(0, 256, (h, w), dtype=np.uint8)
    for M in _matrices(h, w):
        want = cv2.warpAffine(img, M, (w, h), borderValue=(128, 128, 128))
        np.testing.assert_array_equal(cv_ops.warp_affine(img, M, (w, h), (128, 128, 128)), want)
        want = cv2.warpAffine(grey, M, (w, h), borderValue=(77,))
        np.testing.assert_array_equal(cv_ops.warp_affine(grey, M, (w, h), (77,)), want)
    M = cv2.getRotationMatrix2D((w / 2, h / 2), 11.5, 0.8)
    np.testing.assert_array_equal(cv_ops.warp_affine(img, M, (w + 5, h - 3)),
                                  cv2.warpAffine(img, M, (w + 5, h - 3)))


def test_rotation_matrix():
    for center, angle, scale in (((16, 16), 9.0, 1.0), ((26.5, 18.5), -30.0, 1.0),
                                 ((0.1, 7.3), 123.4, 0.7)):
        np.testing.assert_array_equal(cv_ops.get_rotation_matrix_2d(center, angle, scale),
                                      cv2.getRotationMatrix2D(center, angle, scale))


def test_equalize_hist():
    rng = np.random.default_rng(2)
    for img in (rng.integers(0, 256, (37, 53), dtype=np.uint8),
                (rng.integers(0, 256, (64, 48)) // 37 + 3).astype(np.uint8),
                np.full((5, 7), 200, np.uint8), rng.integers(250, 256, (3, 3), dtype=np.uint8)):
        np.testing.assert_array_equal(cv_ops.equalize_hist(img), cv2.equalizeHist(img))


def test_gaussian_blur_u8_3x3():
    rng = np.random.default_rng(3)
    for shape in ((32, 32, 3), (37, 53, 3), (5, 4), (1, 9, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(cv_ops.gaussian_blur(img, 3), cv2.GaussianBlur(img, (3, 3), 0))


@pytest.mark.parametrize("ksize", [51, 21, 11])
def test_gaussian_blur_float(ksize):
    """Within 1e-6 of cv2 (IPP on or off) on [0, 1] images; the kernel
    within float32 rounding of cv2.getGaussianKernel's double one. Below
    11 taps cv2 takes a fixed-point kernel, which the port refuses."""
    np.testing.assert_allclose(cv_ops.gaussian_kernel_1d(ksize),
                               cv2.getGaussianKernel(ksize, 0, cv2.CV_64F).ravel(), rtol=2e-7,
                               atol=1e-9)
    with pytest.raises(ValueError, match="fixed-point"):
        cv_ops.gaussian_kernel_1d(9)
    rng = np.random.default_rng(ksize)
    for shape in ((64, 80, 3), (60, 70), (400, 31, 3)):
        img = rng.random(shape, dtype=np.float32)
        got = cv_ops.gaussian_blur(img, ksize)
        for ipp in (True, False):
            use = cv2.ipp.useIPP()
            cv2.ipp.setUseIPP(ipp)
            want = cv2.GaussianBlur(img, (ksize, ksize), 0)
            cv2.ipp.setUseIPP(use)
            assert np.abs(got - want).max() <= 1e-6


def test_bgr2gray(own_code):
    rng = np.random.default_rng(4)
    for w in (1, 7, 8, 13, 61, 224):
        for img in (rng.random((29, w, 3), dtype=np.float32),
                    (rng.integers(0, 256, (29, w, 3)) / 255.0).astype(np.float32)):
            np.testing.assert_array_equal(cv_ops.bgr2gray(img),
                                          cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    cv2.ipp.setUseIPP(True)
    img = rng.random((50, 61, 3), dtype=np.float32)
    got, want = cv_ops.bgr2gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    assert np.abs(got.view(np.int32) - want.view(np.int32)).max() <= 1


def test_fma32_is_correctly_rounded():
    """fma32 against exact rational arithmetic on float32 operands, the
    double-rounding cases included."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32) * np.float32(2.0 ** -20)
    c = rng.standard_normal(2000).astype(np.float32)
    got = cv_ops.fma32(a, b, c)
    for i in range(0, 2000, 7):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.array(v).view(np.int32)) & 1))
        assert got[i] == best, i
    # a * b on a float32 tie and c far below float64's reach: the float64
    # sum alone rounds to the tie, then to even; the fused sum rounds up
    a = np.float32(1 + 2.0 ** -12)
    c = np.float32(2.0 ** -70)
    assert np.float32(np.float64(a) * np.float64(a) + np.float64(c)) == np.float32(1 + 2.0 ** -11)
    assert cv_ops.fma32(a, a, c) == np.float32(1 + 2.0 ** -11 + 2.0 ** -23)
    assert cv_ops.fma32(a, a, -c) == np.float32(1 + 2.0 ** -11)


def test_reflect101_border():
    img = np.arange(24, dtype=np.float32).reshape(4, 6)
    np.testing.assert_array_equal(cv_ops.copy_make_border_reflect101(img, 0, 3, 0, 2),
                                  cv2.copyMakeBorder(img, 0, 3, 0, 2, cv2.BORDER_REFLECT_101))
    img3 = np.random.default_rng(6).random((5, 3, 3), dtype=np.float32)
    np.testing.assert_array_equal(cv_ops.copy_make_border_reflect101(img3, 1, 2, 2, 1),
                                  cv2.copyMakeBorder(img3, 1, 2, 2, 1, cv2.BORDER_REFLECT_101))
    assert cv_ops.copy_make_border_reflect101(img[..., None], 0, 1, 0, 1).shape == (5, 7)


def test_refusals():
    with pytest.raises(ValueError, match="not ported"):
        cv_ops.resize(np.zeros((4, 4, 3), np.float32), (8, 8), cv_ops.INTER_CUBIC)
    with pytest.raises(ValueError, match="uint8 only"):
        cv_ops.warp_affine(np.zeros((4, 4), np.float32), np.eye(2, 3), (4, 4))
