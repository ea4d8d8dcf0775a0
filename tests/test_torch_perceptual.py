"""The perceptual (VGG19) loss: the port vs bem_tpu/losses/perceptual.py.

- The random features of ``BEM_ALLOW_RANDOM_VGG=1`` are bit-identical to
  bem_tpu's (the same ``default_rng(19)`` draws in the same order).
- Without the opt-in and without weights, construction raises
  ``FileNotFoundError`` in both packages.
- VGG19 features at conv1_2, conv3_4 and conv5_4 (before their ReLU) on
  2x32x32 inputs within 1e-4 of each feature's largest entry; the
  ``BEM_VGG19_WEIGHTS`` .npz read the same way (HWIO kernels, nonzero
  biases) at conv1_2.
- The perceptual and Gram style losses, each criterion and ``range_norm``,
  within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from bem_tpu.losses import perceptual as jp
from bem_tpu_torch.losses import perceptual as pp

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

LAYERS = ("conv1_2", "conv3_4", "conv5_4")


@pytest.fixture
def random_vgg(monkeypatch, tmp_path):
    """The random-feature opt-in, with no weights file in reach."""
    monkeypatch.delenv("BEM_VGG19_WEIGHTS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("BEM_ALLOW_RANDOM_VGG", "1")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.random((2, 32, 32, 3), np.float32), rng.random((2, 32, 32, 3), np.float32)


def test_random_features_are_bem_tpus(random_vgg):
    want, got = jp._load_vgg_weights(), pp._load_vgg_weights()
    assert set(got) == set(want) and len(got) == 32
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_missing_weights_raise(monkeypatch, tmp_path):
    monkeypatch.delenv("BEM_VGG19_WEIGHTS", raising=False)
    monkeypatch.delenv("BEM_ALLOW_RANDOM_VGG", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        jp.VGGFeatureExtractor(["conv5_4"])
    with pytest.raises(FileNotFoundError, match="BEM_ALLOW_RANDOM_VGG"):
        pp.VGGFeatureExtractor(["conv5_4"], device="cpu")


def _assert_features(got, want, names):
    assert set(got) == set(want) == set(names)
    for k in names:
        w = np.asarray(want[k])
        g = got[k].permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_features_match(random_vgg, images):
    x = images[0]
    want = jp.VGGFeatureExtractor(list(LAYERS))(x)
    port = pp.VGGFeatureExtractor(list(LAYERS), device="cpu")
    assert [n for n, _ in port.layers][-1] == "conv5_4"  # no deeper than asked
    _assert_features(port(torch.from_numpy(x)), want, LAYERS)


def test_weights_file_is_read_the_same_way(monkeypatch, tmp_path, images):
    rng = np.random.default_rng(3)
    arrays = {"conv1_1.kernel": rng.standard_normal((3, 3, 3, 64)).astype(np.float32) * 0.3,
              "conv1_1.bias": rng.standard_normal(64).astype(np.float32),
              "conv1_2.kernel": rng.standard_normal((3, 3, 64, 64)).astype(np.float32) * 0.05,
              "conv1_2.bias": rng.standard_normal(64).astype(np.float32)}
    path = tmp_path / "vgg.npz"
    np.savez(path, **arrays)
    monkeypatch.setenv("BEM_VGG19_WEIGHTS", str(path))
    monkeypatch.delenv("BEM_ALLOW_RANDOM_VGG", raising=False)
    x = images[0]
    want = jp.VGGFeatureExtractor(["conv1_2"], range_norm=True)(x * 2 - 1)
    got = pp.VGGFeatureExtractor(["conv1_2"], range_norm=True, device="cpu")(
        torch.from_numpy(x * 2 - 1))
    _assert_features(got, want, ("conv1_2",))


@pytest.mark.parametrize("criterion,range_norm,use_input_norm",
                         [("l1", False, True), ("l2", False, True), ("mse", True, True),
                          ("fro", False, False)])
def test_losses_match(random_vgg, images, criterion, range_norm, use_input_norm):
    x, gt = images
    opt = dict(type="PerceptualLoss", layer_weights={"conv1_2": 0.5, "conv3_4": 1.0, "conv5_4": 2.0},
               vgg_type="vgg19", use_input_norm=use_input_norm, range_norm=range_norm,
               perceptual_weight=0.01, style_weight=0.3, criterion=criterion)
    want = jp.build_perceptual(opt)(x, gt)
    got = pp.build_perceptual(opt, device="cpu")(torch.from_numpy(x), torch.from_numpy(gt))
    for g, w, what in zip(got, want, ("perceptual", "style")):
        assert float(g) == pytest.approx(float(w), rel=1e-5), what
    none = pp.build_perceptual(dict(opt, perceptual_weight=0, style_weight=0), device="cpu")
    assert none(torch.from_numpy(x), torch.from_numpy(gt)) == (None, None)
