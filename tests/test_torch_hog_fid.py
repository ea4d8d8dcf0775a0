"""The long tail's numeric helpers against bem_tpu: HOG features, the
noise map, MATLAB's imresize and the Fréchet distance.

HOG on 8-bit-quantized images (the Sobel sums exact in fp32): the same
bins populated in every cell, and the values within 1e-6 relative. Not
bitwise: torch's CPU sqrt is not correctly rounded on some inputs, and
XLA's fused norm adds the bins' squares in its own order, so single
entries differ by up to 3 fp32 ulps. The noise map to 1e-6; imresize
(scales 0.5 / 0.25 / 2, ``out_shape``, antialiasing on and off) to 1e-10
in float64; the Fréchet distance to 1e-9; the feature extractor refuses
without weights; and ``calculate_fid`` joins the metric registry exactly
when bem_tpu's takes it: once ``metrics.fid`` is imported.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.metrics import fid as bem_fid
from bem_tpu.utils import matlab_functions as bem_matlab
from bem_tpu.utils.hog import hog_features as bem_hog
from bem_tpu.utils.noise_cal import calculate_noise_map as bem_noise_map
from bem_tpu_torch.metrics import fid
from bem_tpu_torch.utils import matlab_functions
from bem_tpu_torch.utils.hog import hog_features
from bem_tpu_torch.utils.noise_cal import calculate_noise_map

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

HOG_CASES = [(16, (2, 32, 32, 3)), (32, (2, 32, 32, 3)), (16, (1, 64, 64, 2)),
             (0, (1, 16, 24, 3))]


@pytest.mark.parametrize("window, shape", HOG_CASES)
def test_hog_matches_bem_tpu(window, shape):
    rng = np.random.default_rng(window + shape[1])
    x = (rng.integers(0, 256, shape) / 256.0).astype(np.float32)
    want = np.asarray(bem_hog(jnp.asarray(x), nbins=9, pool=8, gaussian_window=window))
    got = hog_features(torch.from_numpy(x), nbins=9, pool=8, gaussian_window=window).numpy()
    assert got.shape == want.shape == (shape[0], shape[1] // 8, shape[2] // 8, shape[3], 9)
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_hog_refuses_an_untiled_window():
    with pytest.raises(ValueError, match="gw"):
        hog_features(torch.zeros(1, 24, 24, 3), gaussian_window=16)


def test_noise_map_matches_bem_tpu():
    x = np.random.default_rng(0).standard_normal((2, 12, 17, 3)).astype(np.float32)
    want = np.asarray(bem_noise_map(jnp.asarray(x)))
    got = calculate_noise_map(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


IMRESIZE_CASES = [dict(scale=0.5), dict(scale=0.25), dict(scale=2),
                  dict(out_shape=(13, 29)), dict(scale=0.5, antialiasing=False),
                  dict(out_shape=(9, 40), antialiasing=False)]


@pytest.mark.parametrize("kwargs", IMRESIZE_CASES, ids=str)
@pytest.mark.parametrize("channels", [None, 3])
def test_imresize_matches_bem_tpu(kwargs, channels):
    shape = (37, 26) if channels is None else (37, 26, channels)
    img = np.random.default_rng(3).random(shape)
    want = bem_matlab.imresize(img, **kwargs)
    got = matlab_functions.imresize(img, **kwargs)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_frechet_distance_matches_bem_tpu():
    rng = np.random.default_rng(4)
    f1 = rng.standard_normal((200, 16))
    f2 = rng.standard_normal((180, 16)) * 1.3 + 0.2
    want = bem_fid.calculate_fid(f1, f2)
    assert abs(fid.calculate_fid(f1, f2) - want) <= 1e-9 * max(1.0, abs(want))
    mu, sig = f1.mean(0), np.cov(f1, rowvar=False)
    singular = np.zeros((16, 16))  # a singular product for sqrtm
    assert abs(fid.calculate_fid_from_stats(mu, singular, mu + 1, singular)
               - bem_fid.calculate_fid_from_stats(mu, singular, mu + 1, singular)) <= 1e-9
    assert abs(fid.calculate_fid_from_stats(mu, sig, mu, sig)) <= 1e-6


def test_inception_features_refuse_without_weights(monkeypatch):
    monkeypatch.delenv("BEM_INCEPTION_WEIGHTS", raising=False)
    with pytest.raises(RuntimeError, match="InceptionV3"):
        fid.extract_inception_features(np.zeros((1, 8, 8, 3), np.float32))


def test_fid_registers_when_imported_as_in_bem_tpu():
    code = ("import bem_tpu_torch.metrics as m, bem_tpu.metrics as b\n"
            "from bem_tpu.utils.registry import METRIC_REGISTRY as R\n"
            "def has(reg):\n"
            "    try:\n        reg.get('calculate_fid')\n        return True\n"
            "    except Exception:\n        return False\n"
            "before = ('calculate_fid' in m.METRICS, has(R))\n"
            "import bem_tpu_torch.metrics.fid, bem_tpu.metrics.fid\n"
            "print(before, ('calculate_fid' in m.METRICS, has(R)))")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root,
                         capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu")).stdout.split("\n")[-2]
    assert out == "(False, False) (True, True)"
