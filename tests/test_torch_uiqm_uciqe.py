"""UCIQE and UIQM (``metrics/uciqe_uiqm.py``) and their two exact pieces
against the host libraries bem_tpu calls.

- ``rgb2lab_u8`` equals cv2's uint8 ``COLOR_RGB2LAB`` on all 2^24 colours,
  in four chunks of 2^22 (one each, so six test workers stay within
  memory).
- ``pil_bicubic_resize_u8`` equals Pillow's ``Image.resize`` (BICUBIC) at
  the eval CLI's sizes for 400x600 and 600x400 inputs and at two odd
  sizes, upsampling included.
- ``getUCIQE`` / ``getUIQM``, the batch and the registered
  ``calculate_uciqe`` / ``calculate_uiqm`` (BGR in) against bem_tpu's on
  seeded images: smooth and random content, a flat image (UCIQE's +-0.5
  histogram range; UIQM's zero-min blocks), images under 10 px a side and
  sizes that 10 does not divide. UCIQE within 1e-8, UIQM within 1e-5
  relative.
"""

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from bem_tpu.metrics import uciqe_uiqm as jm
from bem_tpu_torch.metrics import calculate_metric
from bem_tpu_torch.metrics.uciqe_uiqm import (getUCIQE, getUIQM, uciqe_batch, uiqm_batch,
                                             uiqm_uciqe_batch)
from bem_tpu_torch.ops.resize import pil_bicubic_resize_u8
from bem_tpu_torch.utils.color_util import rgb2lab_u8

from test_torch_cpu_setup import one_torch_thread  # noqa: F401  (module fixture)
from test_torch_jpeg import scene


@pytest.mark.parametrize("chunk", range(4))
def test_rgb2lab_all_colours(chunk):
    c = np.arange(chunk << 22, (chunk + 1) << 22, dtype=np.uint32)
    rgb = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).astype(np.uint8)
    rgb = rgb.reshape(2048, 2048, 3)
    np.testing.assert_array_equal(rgb2lab_u8(torch.from_numpy(rgb)).numpy(),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB))


@pytest.mark.parametrize("hw,size", [((400, 600), None), ((600, 400), None),
                                     ((123, 517), (256, 60)), ((9, 7), (256, 331))])
def test_resize_matches_pil(hw, size):
    img = np.random.default_rng(1).integers(0, 256, (*hw, 3), dtype=np.uint8)
    size = size or (256, int(256 / hw[1] * hw[0]))
    want = np.asarray(Image.fromarray(img).resize(size))
    np.testing.assert_array_equal(pil_bicubic_resize_u8(torch.from_numpy(img), size).numpy(),
                                  want)


def _images():
    rng = np.random.default_rng(2)
    return {
        "smooth 170x256": scene(11, 170, 256),
        "smooth 123x517": scene(12, 123, 517),
        "smooth 400x600": scene(13),
        "random 40x60": rng.integers(0, 256, (40, 60, 3), dtype=np.uint8),
        "flat 30x30": np.full((30, 30, 3), 77, np.uint8),
        "under 10 px 7x9": scene(14, 7, 9),
        "33x47": scene(15, 33, 47),
        "dark with zeros 50x64": (scene(16, 50, 64) // 40).astype(np.uint8),
    }


IMAGES = _images()


@pytest.mark.parametrize("name", list(IMAGES))
def test_single_image_metrics_match_bem_tpu(name):
    img = IMAGES[name]
    assert getUCIQE(img) == pytest.approx(jm.getUCIQE(img), rel=0, abs=1e-8)
    want = jm.getUIQM(img)
    assert getUIQM(img) == pytest.approx(want, rel=1e-5, abs=1e-12)
    bgr = img[..., ::-1].astype(np.float64)
    assert calculate_metric({"img": bgr, "img2": bgr}, {"type": "calculate_uciqe"}) == \
        pytest.approx(jm.calculate_uciqe(bgr), abs=1e-8)
    assert calculate_metric({"img": bgr, "img2": bgr},
                            {"type": "calculate_uiqm", "crop_border": 2}) == \
        pytest.approx(jm.calculate_uiqm(bgr, crop_border=2), rel=1e-5, abs=1e-12)


def test_batch_matches_bem_tpu():
    """K candidates of one size through the batch, each image against
    bem_tpu's; the eval CLI's form (float candidates, UIQM on the PIL resize)
    against bem_tpu's recipe."""
    rng = np.random.default_rng(3)
    base = scene(17, 60, 90).astype(np.float32) / 255
    cands = np.clip(base[None] * rng.uniform(0.5, 1.6, (5, 1, 1, 3))
                    + rng.normal(0, 0.02, (5, 60, 90, 3)), 0, 1).astype(np.float32)
    cands[4] = 0.3  # a flat candidate
    u8 = (cands * 255).round().astype(np.uint8)
    np.testing.assert_allclose(uciqe_batch(torch.from_numpy(u8)),
                               [jm.getUCIQE(c) for c in u8], rtol=0, atol=1e-8)
    np.testing.assert_allclose(uiqm_batch(torch.from_numpy(u8)),
                               [jm.getUIQM(c) for c in u8], rtol=1e-5, atol=1e-12)
    uiqms, uciqes = uiqm_uciqe_batch(torch.from_numpy(cands))
    small = [np.array(Image.fromarray(c).resize((256, int(256 / 90 * 60)))) for c in u8]
    np.testing.assert_allclose(uiqms, [jm.getUIQM(s) for s in small], rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(uciqes, [jm.getUCIQE(c) for c in u8], rtol=0, atol=1e-8)
