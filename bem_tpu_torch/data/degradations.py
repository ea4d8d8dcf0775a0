"""Degradation synthesis (counterpart of bem_tpu/data/degradations.py):
the blur kernels (isotropic / anisotropic Gaussian, generalized Gaussian,
plateau, sinc), mixed-kernel sampling, Gaussian and Poisson noise (colour
and grey) and JPEG compression of the Real-ESRGAN degradation pipeline,
host-side numpy.

Every draw comes from the generators a function is given: ``rng``, an
``np.random.RandomState`` (bem_tpu draws from numpy's global legacy
state) and, for the kernel type, ``py_rng``, a ``random.Random`` (bem_tpu:
Python's global ``random``). Seeded alike, they give bem_tpu's draws.
Images are HWC float in [0, 1], in bem_tpu's cv2 channel order (BGR):
the grey Poisson noise takes cv2's BGR -> grey weights and the JPEG
round trip reads the image as BGR (the port's readers give RGB: flip with
``[..., ::-1]``).
"""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence

import numpy as np
from scipy.special import j1

from ..utils.cv_ops import bgr2gray
from ..utils.image_writers import encode_jpeg
from ..utils.img_util import imdecode


def _np_rng(rng: Optional[np.random.RandomState]) -> np.random.RandomState:
    return rng if rng is not None else np.random.RandomState()


# --------------------------------------------------------------- blur kernels


def mesh_grid(kernel_size: int):
    """(kernel_size, kernel_size, 2) (x, y) grid centred on 0, and xx, yy
    (degradations.py:27)."""
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.hstack([xx.reshape(-1, 1), yy.reshape(-1, 1)]).reshape(kernel_size, kernel_size, 2)
    return xy, xx, yy


def sigma_matrix2(sig_x, sig_y, theta):
    """The covariance of a Gaussian with axes sig_x, sig_y rotated by theta
    (degradations.py:35)."""
    d = np.array([[sig_x**2, 0], [0, sig_y**2]])
    u = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def _inverse_sigma(sig_x, sig_y, theta, isotropic):
    if isotropic:
        sigma_matrix = np.array([[sig_x**2, 0], [0, sig_x**2]])
    else:
        sigma_matrix = sigma_matrix2(sig_x, sig_y, theta)
    return np.linalg.inv(sigma_matrix)


def bivariate_gaussian(kernel_size, sig_x, sig_y=None, theta=0.0, grid=None, isotropic=True):
    """exp(-x^T S^-1 x / 2), normalized (degradations.py:41)."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    inverse_sigma = _inverse_sigma(sig_x, sig_y, theta, isotropic)
    kernel = np.exp(-0.5 * np.sum(grid @ inverse_sigma * grid, 2))
    return kernel / np.sum(kernel)


def bivariate_generalized_gaussian(kernel_size, sig_x, sig_y, theta, beta, grid=None,
                                   isotropic=True):
    """exp(-(x^T S^-1 x)^beta / 2), normalized (degradations.py:54)."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    inverse_sigma = _inverse_sigma(sig_x, sig_y, theta, isotropic)
    kernel = np.exp(-0.5 * np.power(np.sum(grid @ inverse_sigma * grid, 2), beta))
    return kernel / np.sum(kernel)


def bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta, grid=None, isotropic=True):
    """1 / ((x^T S^-1 x)^beta + 1), normalized (degradations.py:68)."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    inverse_sigma = _inverse_sigma(sig_x, sig_y, theta, isotropic)
    kernel = np.reciprocal(np.power(np.sum(grid @ inverse_sigma * grid, 2), beta) + 1)
    return kernel / np.sum(kernel)


def _draw_shape(rng, sigma_x_range, sigma_y_range, rotation_range, isotropic):
    sigma_x = rng.uniform(*sigma_x_range)
    if isotropic:
        return sigma_x, sigma_x, 0.0
    return sigma_x, rng.uniform(*sigma_y_range), rng.uniform(*rotation_range)


def _draw_beta(rng, beta_range):
    if rng.uniform() < 0.5:
        return rng.uniform(beta_range[0], 1)
    return rng.uniform(1, beta_range[1])


def _noisy(kernel, noise_range, rng):
    if noise_range is not None:
        kernel = kernel * rng.uniform(*noise_range, kernel.shape)
    return kernel / np.sum(kernel)


def random_bivariate_gaussian(kernel_size, sigma_x_range, sigma_y_range=None,
                              rotation_range=(-math.pi, math.pi), noise_range=None,
                              isotropic=True, rng: Optional[np.random.RandomState] = None):
    """A Gaussian kernel of random shape: sigma_x (then sigma_y and the
    rotation unless isotropic) uniform in their ranges (degradations.py:82)."""
    rng = _np_rng(rng)
    sx, sy, rot = _draw_shape(rng, sigma_x_range, sigma_y_range, rotation_range, isotropic)
    kernel = bivariate_gaussian(kernel_size, sx, sy, rot, isotropic=isotropic)
    return _noisy(kernel, noise_range, rng)


def random_bivariate_generalized_gaussian(kernel_size, sigma_x_range, sigma_y_range,
                                          rotation_range, beta_range, noise_range=None,
                                          isotropic=True,
                                          rng: Optional[np.random.RandomState] = None):
    """A generalized Gaussian kernel of random shape; beta uniform below 1
    or above it, each with p = 0.5 (degradations.py:98)."""
    rng = _np_rng(rng)
    sx, sy, rot = _draw_shape(rng, sigma_x_range, sigma_y_range, rotation_range, isotropic)
    beta = _draw_beta(rng, beta_range)
    kernel = bivariate_generalized_gaussian(kernel_size, sx, sy, rot, beta, isotropic=isotropic)
    return _noisy(kernel, noise_range, rng)


def random_bivariate_plateau(kernel_size, sigma_x_range, sigma_y_range, rotation_range,
                             beta_range, noise_range=None, isotropic=True,
                             rng: Optional[np.random.RandomState] = None):
    """A plateau kernel of random shape (degradations.py:120)."""
    rng = _np_rng(rng)
    sx, sy, rot = _draw_shape(rng, sigma_x_range, sigma_y_range, rotation_range, isotropic)
    beta = _draw_beta(rng, beta_range)
    kernel = bivariate_plateau(kernel_size, sx, sy, rot, beta, isotropic=isotropic)
    return _noisy(kernel, noise_range, rng)


def random_mixed_kernels(kernel_list: Sequence[str], kernel_prob, kernel_size=21,
                         sigma_x_range=(0.6, 5), sigma_y_range=(0.6, 5),
                         rotation_range=(-math.pi, math.pi), betag_range=(0.5, 8),
                         betap_range=(0.5, 8), noise_range=None,
                         rng: Optional[np.random.RandomState] = None,
                         py_rng: Optional[random.Random] = None):
    """A kernel of a type drawn from ``kernel_list`` by ``kernel_prob``
    (``py_rng.choices``), then drawn from ``rng`` (degradations.py:140);
    the plateau kernels take no multiplicative noise, as bem_tpu's."""
    rng = _np_rng(rng)
    kernel_type = (py_rng or random.Random()).choices(kernel_list, kernel_prob)[0]
    if kernel_type in ("iso", "aniso"):
        return random_bivariate_gaussian(kernel_size, sigma_x_range, sigma_y_range,
                                         rotation_range, noise_range,
                                         isotropic=kernel_type == "iso", rng=rng)
    if kernel_type in ("generalized_iso", "generalized_aniso"):
        return random_bivariate_generalized_gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range, betag_range, noise_range,
            isotropic=kernel_type == "generalized_iso", rng=rng)
    if kernel_type in ("plateau_iso", "plateau_aniso"):
        return random_bivariate_plateau(kernel_size, sigma_x_range, sigma_y_range,
                                        rotation_range, betap_range, None,
                                        kernel_type == "plateau_iso", rng=rng)
    raise ValueError(kernel_type)


def circular_lowpass_kernel(cutoff, kernel_size, pad_to=0):
    """The 2-D sinc filter of ``cutoff`` (scipy's j1), normalized, zero
    padded to ``pad_to`` (degradations.py:169)."""
    if kernel_size % 2 != 1:
        raise ValueError(f"circular_lowpass_kernel: odd kernel_size, not {kernel_size}")
    c = (kernel_size - 1) / 2

    def f(x, y):
        r = np.sqrt((x - c) ** 2 + (y - c) ** 2)
        return cutoff * j1(cutoff * r + 1e-12) / (2 * np.pi * r + 1e-12)

    kernel = np.fromfunction(f, [kernel_size, kernel_size])
    kernel[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = cutoff**2 / (4 * np.pi)
    kernel = kernel / np.sum(kernel)
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel


# --------------------------------------------------------------------- noise


def _finish(out, clip, rounds):
    if clip and rounds:
        return np.clip((out * 255.0).round(), 0, 255) / 255.0
    if clip:
        return np.clip(out, 0, 1)
    if rounds:
        return (out * 255.0).round() / 255.0
    return out


def generate_gaussian_noise(img, sigma=10, gray_noise=False,
                            rng: Optional[np.random.RandomState] = None):
    """float32 N(0, sigma / 255) noise of the image's shape, one plane
    repeated over the channels when ``gray_noise`` (degradations.py:194)."""
    rng = _np_rng(rng)
    if gray_noise:
        noise = rng.randn(*img.shape[:2]).astype(np.float32)[..., None]
        return np.repeat(noise, 3, axis=2) * sigma / 255.0
    return rng.randn(*img.shape).astype(np.float32) * sigma / 255.0


def add_gaussian_noise(img, sigma=10, clip=True, rounds=False, gray_noise=False,
                       rng: Optional[np.random.RandomState] = None):
    """img + Gaussian noise, clipped to [0, 1] and / or rounded to 1/255
    (degradations.py:203)."""
    return _finish(img + generate_gaussian_noise(img, sigma, gray_noise, rng), clip, rounds)


def random_add_gaussian_noise(img, sigma_range=(0, 10), gray_prob=0, clip=True, rounds=False,
                              rng: Optional[np.random.RandomState] = None):
    """sigma uniform in ``sigma_range``, grey with p = ``gray_prob``
    (degradations.py:215)."""
    rng = _np_rng(rng)
    sigma = rng.uniform(*sigma_range)
    gray = rng.uniform() < gray_prob
    return add_gaussian_noise(img, sigma, clip, rounds, gray, rng)


def generate_poisson_noise(img, scale=1.0, gray_noise=False,
                           rng: Optional[np.random.RandomState] = None):
    """Poisson noise at 2^ceil(log2(#distinct values)) levels, of the BGR
    -> grey image when ``gray_noise`` (cv2's float32 weights, so the level
    count is bem_tpu's), times ``scale`` (degradations.py:222)."""
    rng = _np_rng(rng)
    gimg = bgr2gray(img) if gray_noise else img
    vals = len(np.unique(gimg))
    vals = 2 ** np.ceil(np.log2(vals))
    out = np.float32(rng.poisson(gimg * vals) / float(vals))
    noise = out - gimg
    if gray_noise and noise.ndim == 2:
        noise = np.repeat(noise[..., None], 3, axis=2)
    return noise * scale


def add_poisson_noise(img, scale=1.0, clip=True, rounds=False, gray_noise=False,
                      rng: Optional[np.random.RandomState] = None):
    """img + Poisson noise (degradations.py:236)."""
    return _finish(img + generate_poisson_noise(img, scale, gray_noise, rng), clip, rounds)


def random_add_poisson_noise(img, scale_range=(0, 1.0), gray_prob=0, clip=True, rounds=False,
                             rng: Optional[np.random.RandomState] = None):
    """scale uniform in ``scale_range``, grey with p = ``gray_prob``
    (degradations.py:248)."""
    rng = _np_rng(rng)
    scale = rng.uniform(*scale_range)
    gray = rng.uniform() < gray_prob
    return add_poisson_noise(img, scale, clip, rounds, gray, rng)


# ---------------------------------------------------------------------- JPEG


def add_jpg_compression(img, quality=90):
    """A BGR float image in [0, 1] through JPEG at int(quality) and back,
    float32 (degradations.py:257): clipped, truncated to uint8, encoded
    with :func:`..utils.image_writers.encode_jpeg` (cv2.imencode's
    coefficients) and decoded as cv2.imdecode does."""
    img = np.clip(img, 0, 1)
    u8 = (img * 255.0).astype(np.uint8)
    data = encode_jpeg(np.ascontiguousarray(u8[..., ::-1]), int(quality))
    return np.float32(imdecode(data, "<jpeg>", "color")[..., ::-1]) / 255.0


def random_add_jpg_compression(img, quality_range=(90, 100),
                               rng: Optional[np.random.RandomState] = None):
    """quality uniform in ``quality_range`` (degradations.py:263)."""
    return add_jpg_compression(img, _np_rng(rng).uniform(*quality_range))
