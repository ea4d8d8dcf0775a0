"""The host NIQE of the ``val.metrics`` registry against bem_tpu's
calculate_niqe (bem_tpu/metrics/niqe.py): seeded BGR images of 96 px and
more, through the ``y`` and ``gray`` conversions, a crop, and a 2-D image;
the score within 1e-6 relative (both in fp64 after the same rounding)."""

import cv2
import numpy as np
import pytest

from bem_tpu.metrics.niqe import calculate_niqe as jax_niqe
from bem_tpu_torch.metrics import calculate_metric
from bem_tpu_torch.metrics.niqe import calculate_niqe

from test_torch_cpu_setup import one_torch_thread  # noqa: F401  (module fixture)


def _image(rng, h, w):
    """Smooth structure plus noise, [0, 255] float32 BGR."""
    yy, xx = np.mgrid[0:h, 0:w] / 13.0
    base = 0.5 + 0.35 * np.sin(yy + 0.6 * xx)[..., None] * rng.random((1, 1, 3))
    img = np.clip(base + 0.06 * rng.standard_normal((h, w, 3)), 0, 1)
    return (img * 255.0).astype(np.float32)


@pytest.fixture
def no_ipp():
    """cv2's BGR2GRAY with IPP off: the code the port's bgr2gray follows."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.mark.parametrize("convert_to,crop,size", [("y", 0, (100, 130)), ("gray", 0, (97, 200)),
                                                  ("y", 3, (200, 203)), ("gray", 2, (196, 100))])
def test_niqe_matches_bem_tpu(no_ipp, convert_to, crop, size):
    rng = np.random.default_rng(hash((convert_to, crop)) % 2 ** 31)
    img = _image(rng, *size)
    want = jax_niqe(img, crop, convert_to=convert_to)
    got = calculate_niqe(img, crop, convert_to=convert_to)
    assert np.isfinite(want)
    assert got == pytest.approx(want, rel=1e-6)


def test_niqe_registry_and_2d_input():
    """The registry dispatches ``calculate_niqe`` (the train / test CLIs'
    ``val.metrics``), and ``input_order="HW"`` takes a grey image as it is."""
    rng = np.random.default_rng(5)
    img = _image(rng, 110, 150)
    want = jax_niqe(img, 0)
    got = calculate_metric({"img": img, "img2": img[::-1]}, {"type": "calculate_niqe",
                                                             "crop_border": 0})
    assert got == pytest.approx(want, rel=1e-6)
    grey = img[..., 1]
    assert calculate_niqe(grey, 0, input_order="HW") == pytest.approx(
        jax_niqe(grey, 0, input_order="HW"), rel=1e-6)
