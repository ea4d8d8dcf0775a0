"""The eval CLI's host metrics and condition inputs against bem_tpu: PSNR /
SSIM (1e-6 relative), the histogram condition (1e-6 against bem_tpu's,
route by route: native, numpy), the /16 condition downsample against cv2's INTER_LINEAR
(1e-6), and LPIPS on seeded AlexNet-shaped weights (1e-5).
"""

import cv2
import numpy as np
import pytest

from bem_tpu.enhancement.lpips_jax import LPIPS as JaxLPIPS
from bem_tpu.metrics import calculate_psnr as jax_psnr
from bem_tpu.metrics import calculate_ssim as jax_ssim
from bem_tpu.utils import histogram as jax_hist
from bem_tpu_torch.enhancement.eval import downsample
from bem_tpu_torch.enhancement.lpips import LPIPS
from bem_tpu_torch.metrics.psnr_ssim import calculate_psnr, calculate_ssim
from bem_tpu_torch.utils import histogram as port_hist
from bem_tpu_torch.utils.histogram import histogram_condition

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

_ALEX = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3), (256, 256, 3)]


def _natural(rng, h, w, noise=0.05):
    """Smooth structure plus noise, [0, 1] float32 RGB."""
    yy, xx = np.mgrid[0:h, 0:w] / 17.0
    base = 0.5 + 0.3 * np.sin(yy + 0.7 * xx)[..., None] * rng.random((1, 1, 3))
    return np.clip(base + noise * rng.standard_normal((h, w, 3)), 0, 1).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(crop_border=0), dict(crop_border=4),
                                dict(crop_border=0, test_y_channel=True)])
def test_psnr_ssim_match_bem_tpu(kw):
    rng = np.random.default_rng(0)
    a = _natural(rng, 61, 83)
    b = np.clip(a + 0.03 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    for x, y in (((a * 255).round().astype(np.uint8), (b * 255).round().astype(np.uint8)),
                 (a * 255, b * 255)):
        assert calculate_psnr(x, y, **kw) == pytest.approx(jax_psnr(x, y, **kw), rel=1e-6)
        assert calculate_ssim(x, y, **kw) == pytest.approx(jax_ssim(x, y, **kw), rel=1e-6)
    assert calculate_psnr(a, a, 0) == float("inf")


@pytest.mark.parametrize("shape,patch,bins", [((64, 96), 8, 64), ((50, 37), 8, 16)])
def test_histogram_condition_matches_bem_tpu(shape, patch, bins):
    """The port takes bem_tpu's routes: the native C++ library where it
    builds (its own copy of bem_tpu's), numpy otherwise. Each route is held
    to bem_tpu's at 1e-6: the condition as both packages compute it, and
    the port's numpy path against bem_tpu's (the native path is float32 with
    its own exp and sits 2.7e-6 relative from the numpy one)."""
    img = _natural(np.random.default_rng(3), *shape)
    ours = histogram_condition(img, patch, bins)
    np.testing.assert_allclose(ours, jax_hist.histogram_condition(img, patch, bins),
                               rtol=1e-6, atol=1e-9)
    kde = jax_hist._compute_histograms_np(img, patch, bins)  # (C, nh, nw, bins)
    ref = kde.transpose(3, 0, 1, 2).reshape(-1, *kde.shape[1:3]).transpose(1, 2, 0)
    ours_np = port_hist._compute_histograms_np(img, patch, bins)
    ours_np = ours_np.transpose(3, 0, 1, 2).reshape(-1, *kde.shape[1:3]).transpose(1, 2, 0)
    np.testing.assert_allclose(ours_np, ref, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("shape,factor", [((448, 640), 16), ((128, 192), 16), ((64, 32), 4)])
def test_condition_downsample_matches_cv2_linear(shape, factor):
    img = np.random.default_rng(4).random((*shape, 3)).astype(np.float32)
    want = cv2.resize(img, None, fx=1 / factor, fy=1 / factor, interpolation=cv2.INTER_LINEAR)
    got = downsample(img, factor)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_lpips_matches_bem_tpu(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    w = {}
    for i, (o, c, k) in enumerate(_ALEX):  # tools/convert_lpips.py's layout, seeded
        bound = 1 / np.sqrt(c * k * k)
        w[f"conv{i + 1}.kernel"] = rng.uniform(-bound, bound, (k, k, c, o)).astype(np.float32)
        w[f"conv{i + 1}.bias"] = rng.uniform(-bound, bound, o).astype(np.float32)
        w[f"lin{i}.kernel"] = (np.abs(rng.standard_normal((1, 1, o, 1))) / o).astype(np.float32)
    path = tmp_path / "lpips.npz"
    np.savez(path, **w)
    monkeypatch.setenv("BEM_LPIPS_WEIGHTS", str(path))
    a = _natural(rng, 72, 88)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    want = JaxLPIPS()(a, b)
    got = LPIPS(device="cpu")(a, b)
    assert got == pytest.approx(want, rel=1e-5, abs=1e-7)
    assert got > 0 and LPIPS(device="cpu")(a, a) == 0.0
    monkeypatch.delenv("BEM_LPIPS_WEIGHTS")
    with pytest.raises(RuntimeError, match="BEM_LPIPS_WEIGHTS"):
        LPIPS(device="cpu")
