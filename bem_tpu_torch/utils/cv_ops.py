"""The OpenCV operations bem_tpu calls on its data paths, in numpy (the
card's machine has no cv2).

Each function names the cv2 call it stands for and follows OpenCV's own
code for it (modules/imgproc: resize.cpp, warp_kernels.simd.hpp, histogram.cpp,
smooth.dispatch.cpp, color_rgb.simd.hpp): uint8 results are bit for bit
cv2's where its own code runs. A cv2 built with IPP (the default) hands
some of these calls to IPP instead: uint8 ``INTER_CUBIC`` resizes then
differ from OpenCV's own code by 1 at about 1-8 % of the values, and
float32 grey conversions, blurs and resizes by float32 ulps. ``cv2.ipp.setUseIPP(False)``
gives OpenCV's own results, which these equal; where OpenCV's own code
takes vector and scalar paths that round differently, the functions
follow the split of the AVX2 build (8 float32 lanes).

Interpolation codes are cv2's: ``INTER_NEAREST`` 0, ``INTER_LINEAR`` 1,
``INTER_CUBIC`` 2.
"""

from __future__ import annotations

import math

import numpy as np

from .img_util import resize_linear

INTER_NEAREST, INTER_LINEAR, INTER_CUBIC = 0, 1, 2
_F32 = np.float32


def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """interpolateCubic (A = -0.75) in float32, as resize.cpp computes it:
    (n, 4) weights of the taps at -1, 0, 1, 2 around the floor."""
    A, one = _F32(-0.75), _F32(1)
    x = x.astype(_F32)
    x1 = x + one
    c0 = ((A * x1 - _F32(5) * A) * x1 + _F32(8) * A) * x1 - _F32(4) * A
    c1 = ((A + _F32(2)) * x - (A + _F32(3))) * x * x + one
    y = one - x
    c2 = ((A + _F32(2)) * y - (A + _F32(3))) * y * y + one
    return np.stack([c0, c1, c2, one - c0 - c1 - c2], -1)


def _cubic_axis(n_in: int, n_out: int):
    """Source taps (n_out, 4), clamped to the edge as resizeGeneric_ does,
    and their 11-bit fixed-point weights (cvRound of weight * 2048)."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(_F32)
    s = np.floor(f)
    c = np.rint(_cubic_coeffs((f - s).astype(_F32)) * _F32(2048)).astype(np.int64)
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0, n_in - 1)
    return idx, c


def _resize_cubic_u8(img: np.ndarray, size) -> np.ndarray:
    """uint8 INTER_CUBIC: the horizontal pass in integers (11-bit weights);
    the vertical pass over each output row's width x channels values as
    VResizeCubic does it: in blocks of 8 (its vector loop) the int rows in
    float32, weights scaled by 2^-22, (S0 b0 + (S1 b1 + (S2 b2 + S3 b3)))
    rounded to even; the last (width x channels) % 8 values (its scalar
    loop) in integers, (sum + 2^21) >> 22."""
    w_out, h_out = size
    h, w = img.shape[:2]
    xi, xc = _cubic_axis(w, w_out)
    yi, yc = _cubic_axis(h, h_out)
    x = img.astype(np.int64)
    col = (1, -1) + (1,) * (img.ndim - 2)
    row = (-1,) + (1,) * (img.ndim - 1)
    rows = sum(x[:, xi[:, k]] * xc[:, k].reshape(col) for k in range(4))
    scale = _F32(1.0 / (2048 * 2048))
    b = [(yc[:, k].astype(_F32) * scale).reshape(row) for k in range(4)]
    r = [rows[yi[:, k]].astype(_F32) for k in range(4)]
    out = np.rint(r[0] * b[0] + (r[1] * b[1] + (r[2] * b[2] + r[3] * b[3]))).reshape(h_out, -1)
    n = out.shape[1]
    tail = n - n % 8
    if tail < n:
        exact = sum(rows[yi[:, k]] * yc[:, k].reshape(row) for k in range(4)).reshape(h_out, -1)
        out[:, tail:] = (exact[:, tail:] + (1 << 21)) >> 22
    return np.clip(out, 0, 255).astype(np.uint8).reshape((h_out, w_out) + img.shape[2:])


def _resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """INTER_NEAREST (resizeNN): source index floor(d * in / out) in
    double, clamped to the last."""
    w_out, h_out = size
    h, w = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(w_out) * (1.0 / (w_out / w))).astype(np.int64), w - 1)
    sy = np.minimum(np.floor(np.arange(h_out) * (1.0 / (h_out / h))).astype(np.int64), h - 1)
    return img[sy][:, sx]


def resize(img: np.ndarray, size, interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=...)``, ``size`` = (width,
    height): uint8 under INTER_NEAREST, INTER_LINEAR
    (:func:`.img_util.resize_linear`) and INTER_CUBIC; float32 under
    INTER_NEAREST and INTER_LINEAR."""
    w_out, h_out = size
    if (w_out, h_out) == img.shape[1::-1]:
        return img.copy()
    if interpolation == INTER_NEAREST:
        return _resize_nearest(img, size)
    if interpolation == INTER_LINEAR:
        return resize_linear(img, size)
    if interpolation == INTER_CUBIC and img.dtype == np.uint8:
        return _resize_cubic_u8(img, size)
    raise ValueError(f"resize: interpolation {interpolation} on {img.dtype} is not ported "
                     f"(uint8 nearest / linear / cubic, float32 nearest / linear)")


def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the (2, 3) float64 matrix; ``center``
    passes through float32, as cv2's Point2f."""
    cx, cy = (float(_F32(c)) for c in center)
    a = angle * math.pi / 180
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def fma32(a, b, c) -> np.ndarray:
    """Fused a * b + c of float32 operands, rounded once to float32 (as
    an FMA instruction does): the product is exact in float64, the sum's
    rounding error is recovered exactly (TwoSum) and breaks the float32
    rounding where the float64 sum alone would round twice."""
    a, b, c = (np.asarray(v, _F32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    s = np.where(e > 0, np.nextafter(s, np.inf), np.where(e < 0, np.nextafter(s, -np.inf), s))
    return s.astype(_F32)


def _invert_affine(M) -> np.ndarray:
    """cv2's inversion of a (2, 3) affine map, in double (imgwarp.cpp)."""
    m = np.asarray(M, np.float64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    return np.array([a11, a12, -a11 * m[0, 2] - a12 * m[1, 2],
                     a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]])


def warp_affine(img: np.ndarray, M, dsize, border_value=(0, 0, 0, 0)) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize, borderValue=...)`` for uint8 (H, W)
    or (H, W, C): INTER_LINEAR, BORDER_CONSTANT, as OpenCV 5's
    warpAffineLinearInvoker computes it in float32. M is inverted in
    double and rounded to float32; in the vector loop (blocks of 16
    columns) a row's offset is y M1 + M2 (float32 product and sum) and the
    source x = fma(M0, x, offset), in the scalar loop over the row's last
    width % 16 columns fma(x, M0, y M1) + M2 (y alike); the taps at floor(x), floor(y) and +1, a tap outside the image the border
    value (a cv2 Scalar: channel c takes entry c, missing entries 0); the
    value fma(a, p01 - p00, p00) per row pair, then fma(b, lower - upper,
    upper), a and b the fractions, rounded to even and saturated."""
    if img.dtype != np.uint8:
        raise ValueError(f"warp_affine: uint8 only, not {img.dtype}")
    m = _invert_affine(M).astype(_F32)
    w_out, h_out = dsize
    ys = np.arange(h_out, dtype=_F32)[:, None]
    xs = np.arange(w_out, dtype=_F32)[None, :]
    sx = fma32(m[0], xs, ys * m[1] + m[2])
    sy = fma32(m[3], xs, ys * m[4] + m[5])
    t = w_out - w_out % 16
    sx[:, t:] = fma32(xs[:, t:], m[0], ys * m[1]) + m[2]
    sy[:, t:] = fma32(xs[:, t:], m[3], ys * m[4]) + m[5]
    ix, iy = np.floor(sx), np.floor(sy)
    extra = img.shape[2:]
    tail = (1,) * len(extra)
    a = (sx - ix).reshape(sx.shape + tail)
    b = (sy - iy).reshape(sy.shape + tail)
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    h, w = img.shape[:2]
    src = img.astype(_F32)
    scalar = np.zeros(4, _F32)
    given = np.asarray(border_value, _F32).reshape(-1)[:4]
    scalar[:given.size] = given
    cval = scalar[:extra[0]] if extra else scalar[0]

    def tap(dy, dx):
        tx, ty = ix + dx, iy + dy
        inside = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
        v = src[np.clip(ty, 0, h - 1), np.clip(tx, 0, w - 1)]
        return np.where(inside.reshape(inside.shape + tail), v, cval)

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    upper = fma32(a, p01 - p00, p00)
    lower = fma32(a, p11 - p10, p10)
    out = fma32(b, lower - upper, upper)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def equalize_hist(img: np.ndarray) -> np.ndarray:
    """``cv2.equalizeHist`` of a 2-D uint8 image: the LUT from the first
    occupied bin, float32 scale 255 / (total - hist[first]), each entry
    cvRound(sum * scale); an image of one value comes back as that value."""
    hist = np.bincount(img.ravel(), minlength=256)
    i = int(np.flatnonzero(hist)[0])
    total = img.size
    if hist[i] == total:
        return np.full_like(img, i)
    scale = _F32(255.0) / _F32(total - hist[i])
    lut = np.zeros(256, np.int64)
    sums = np.cumsum(hist[i + 1:])
    lut[i + 1:] = np.rint(sums.astype(_F32) * scale)
    return np.clip(lut, 0, 255).astype(np.uint8)[img]


def copy_make_border_reflect101(img: np.ndarray, top: int, bottom: int, left: int,
                                right: int) -> np.ndarray:
    """``cv2.copyMakeBorder(..., cv2.BORDER_REFLECT_101)`` (gfedcb|abcdefgh|gfedcba),
    numpy's "reflect"; like cv2, an (H, W, 1) image comes back 2-D."""
    out = np.pad(img, ((top, bottom), (left, right)) + ((0, 0),) * (img.ndim - 2),
                 mode="reflect")
    return out[..., 0] if out.ndim == 3 and out.shape[2] == 1 else out


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """The float32 kernel of cv2.GaussianBlur on float32 images where cv2
    computes it (ksize >= 11 at sigma 0, or sigma > 0): exp(-x^2 / (2
    sigma^2)) in double, each tap rounded to float32, scaled by 1 / their
    sum; sigma <= 0 is 0.3 ((ksize - 1) / 2 - 1) + 0.8. Smaller kernels at
    sigma 0 come from cv2's fixed-point approximations: not ported."""
    if ksize % 2 != 1:
        raise ValueError(f"gaussian_kernel_1d: odd ksize, not {ksize}")
    if sigma <= 0 and ksize < 11:
        raise ValueError(f"gaussian_kernel_1d: ksize {ksize} at sigma 0 takes cv2's "
                         "fixed-point kernel; not ported")
    s = sigma if sigma > 0 else ((ksize - 1) * 0.5 - 1) * 0.3 + 0.8
    x = np.arange(ksize) - (ksize - 1) * 0.5
    cf = np.exp((-0.5 / (s * s)) * x * x).astype(_F32)
    total = float(np.sum(cf.astype(np.float64)))
    return (cf.astype(np.float64) * (1.0 / total)).astype(_F32)


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float = 0.0) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)``, BORDER_REFLECT_101,
    in two forms:

    - uint8, ksize 3, sigma 0: cv2's bit-exact fixed-point [1, 2, 1] / 4
      per axis, (sum + 8) >> 4;
    - float32 at odd ksize >= 11 (or sigma > 0): the separable filter of
      :func:`gaussian_kernel_1d`, rows then columns, summed in float64 and
      rounded to float32 once. cv2 sums in float32 (through IPP where
      built with it), so the two differ by float32 ulps, not bit for bit.
    """
    if img.dtype == np.uint8:
        if ksize != 3 or sigma != 0:
            raise ValueError("gaussian_blur: uint8 is ported at ksize 3, sigma 0")
        x = copy_make_border_reflect101(img, 1, 1, 1, 1).astype(np.int64)
        if img.ndim == 3 and img.shape[2] == 1:
            x = x[..., None]
        rows = x[:, :-2] + 2 * x[:, 1:-1] + x[:, 2:]
        out = (rows[:-2] + 2 * rows[1:-1] + rows[2:] + 8) >> 4
        return out.astype(np.uint8).reshape(img.shape)
    if img.dtype != np.float32:
        raise ValueError(f"gaussian_blur: uint8 or float32, not {img.dtype}")
    k = gaussian_kernel_1d(ksize, sigma).astype(np.float64)
    r = ksize // 2
    x = np.pad(img.astype(np.float64), ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2),
               mode="reflect")
    h, w = img.shape[:2]
    rows = sum(k[i] * x[:, i:i + w] for i in range(ksize))
    out = sum(k[i] * rows[i:i + h] for i in range(ksize))
    return out.astype(_F32)


def bgr2gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` of a float32 (H, W, 3) BGR
    image, as OpenCV's own RGB2Gray<float> computes it row by row: blocks
    of 8 pixels (its AVX2 vectors) fma(R, 0.299, fma(G, 0.587, B 0.114)),
    the row's last width % 8 pixels (its scalar loop) fma(R, 0.299,
    fma(B, 0.114, G 0.587)), all in float32."""
    if img.dtype != np.float32 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"bgr2gray: float32 (H, W, 3), not {img.dtype} {img.shape}")
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    cb, cg, cr = _F32(0.114), _F32(0.587), _F32(0.299)
    out = fma32(r, cr, fma32(g, cg, b * cb))
    tail = img.shape[1] - img.shape[1] % 8
    out[:, tail:] = fma32(r[:, tail:], cr, fma32(b[:, tail:], cb, g[:, tail:] * cg))
    return out
