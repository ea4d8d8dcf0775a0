"""The native host-pipeline library (``bem_tpu_torch.native``, the port's
copy of bem_tpu/native) against bem_tpu.

The KDE histograms against bem_tpu's numpy route and its own native
library (rtol 1e-4, a ragged size through the reflect padding too), the
fused crop + augment in all 8 modes against bem_tpu's
``data_augmentation`` (exact), the port's numpy route against bem_tpu's,
and ``histogram_condition`` against bem_tpu's. The native cases skip
without g++, as tests/test_native.py does.
"""

import numpy as np
import pytest

from bem_tpu import native as bem_native
from bem_tpu.data.transforms import data_augmentation
from bem_tpu.utils.histogram import _compute_histograms_np as bem_histograms_np
from bem_tpu.utils.histogram import histogram_condition as bem_histogram_condition
from bem_tpu_torch import native
from bem_tpu_torch.utils import histogram

needs_gxx = pytest.mark.skipif(not native.available(),
                               reason="native library unavailable (no g++)")
SIZES = [((24, 36), 8, 32), ((19, 21), 8, 16)]  # the second ragged: reflect-padded


def _image(shape, seed=0):
    return np.random.default_rng(seed).random((*shape, 3)).astype(np.float32)


@needs_gxx
@pytest.mark.parametrize("shape, patch, bins", SIZES)
def test_kde_matches_bem_tpu(shape, patch, bins):
    img = _image(shape)
    got = native.kde_histograms(img, patch, bins)
    np.testing.assert_allclose(got, bem_histograms_np(img, patch, bins), rtol=1e-4, atol=1e-6)
    if bem_native.available():
        np.testing.assert_allclose(got, bem_native.kde_histograms(img, patch, bins),
                                   rtol=1e-4, atol=1e-6)


@needs_gxx
@pytest.mark.parametrize("mode", range(8))
def test_crop_augment_matches_bem_tpu(mode):
    rng = np.random.default_rng(mode)
    lq = rng.random((16, 20, 3)).astype(np.float32)
    gt = rng.random((16, 20, 3)).astype(np.float32)
    top, left, P = 3, 5, 8
    got_gt, got_lq = native.paired_crop_augment(lq, gt, top, left, P, mode)
    np.testing.assert_array_equal(got_gt, data_augmentation(gt[top:top + P, left:left + P], mode))
    np.testing.assert_array_equal(got_lq, data_augmentation(lq[top:top + P, left:left + P], mode))


@needs_gxx
def test_crop_augment_refuses_a_crop_outside():
    img = np.zeros((16, 20, 3), np.float32)
    with pytest.raises(ValueError, match="crop"):
        native.paired_crop_augment(img, img, 10, 5, 8, 0)


@pytest.mark.parametrize("shape, patch, bins", SIZES)
def test_numpy_route_matches_bem_tpu(shape, patch, bins):
    img = _image(shape, 1)
    np.testing.assert_allclose(histogram._compute_histograms_np(img, patch, bins),
                               bem_histograms_np(img, patch, bins), rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape, patch, bins", SIZES)
def test_histogram_condition_matches_bem_tpu(shape, patch, bins):
    img = _image(shape, 2)
    got = histogram.histogram_condition(img, patch, bins)
    assert got.shape == (-(-shape[0] // patch), -(-shape[1] // patch), 3 * bins)
    np.testing.assert_allclose(got, bem_histogram_condition(img, patch, bins),
                               rtol=1e-4, atol=1e-6)
