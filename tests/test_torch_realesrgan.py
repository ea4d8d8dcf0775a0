"""RealESRGAN's two datasets, DiffJPEG and USM against bem_tpu's.

- ``RealESRGANDataset`` item by item at the Real-ESRGAN x4plus degradation
  settings (crops, reflect-101 pads, the three kernels) bit for bit:
  bem_tpu draws from Python's and numpy's global generators, seeded here
  with the option's seed, the port from its own; bem_tpu's ``augment``
  draws from an unseeded generator, so one case turns the flips off and
  one hands bem_tpu's module an ``augment`` seeded as the port's.
- ``RealESRGANPairedDataset`` (folders and meta_info, train and val,
  mean / std) bit for bit; its lmdb backend raises.
- ``diff_jpeg`` values and gradients (``jax.grad``) at qualities 30 / 90
  within 2e-5 / 1e-4 (gradients relative to their largest). A quantized
  coefficient within 1e-4 of a rounding tie may round the other way in
  one package (their float32 DCT sums differ in order), so the 8 x 8
  luma blocks (16 x 16 for chroma) of such coefficients, located on
  bem_tpu's values, are left out, at most 10 % of the image. The pipeline
  without rounding is held everywhere.
- ``usm_sharp`` (host, cv2's blur in bem_tpu) and ``usm_sharp_torch`` vs
  ``usm_sharp_jax`` within 1e-5.
- The registry builds both datasets; the video datasets raise.
"""

import random

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bem_tpu.data.realesrgan_dataset as bem_rds
from bem_tpu.data.realesrgan_paired_dataset import RealESRGANPairedDataset as BemPaired
from bem_tpu.data.transforms import augment as bem_augment
from bem_tpu.utils import diffjpeg as bem_dj
from bem_tpu.utils.img_process_util import usm_sharp as bem_usm
from bem_tpu.utils.img_process_util import usm_sharp_jax
from bem_tpu_torch.data import DATASETS, build_dataset
from bem_tpu_torch.utils import diffjpeg
from bem_tpu_torch.utils.img_process_util import usm_sharp, usm_sharp_torch

from test_torch_cpu_setup import one_torch_thread  # noqa: F401  (module fixture)

X4PLUS = dict(blur_kernel_size=21, kernel_list=["iso", "aniso", "generalized_iso",
                                                "generalized_aniso", "plateau_iso",
                                                "plateau_aniso"],
              kernel_prob=[0.45, 0.25, 0.12, 0.03, 0.12, 0.03], sinc_prob=0.1,
              blur_sigma=[0.2, 3], betag_range=[0.5, 4], betap_range=[1, 2],
              final_sinc_prob=0.8)
X4PLUS.update({k + "2": v for k, v in X4PLUS.items() if k != "final_sinc_prob"})
X4PLUS.update(blur_sigma2=[0.2, 1.5])


def _smooth(rng, h, w):
    return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 0)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("realesrgan")
    rng = np.random.default_rng(0)
    gt, lq = root / "gt", root / "lq"
    gt.mkdir()
    lq.mkdir()
    sizes = [(60, 80), (40, 52), (48, 48), (70, 46), (36, 64)]
    for i, (h, w) in enumerate(sizes):
        img = _smooth(rng, h, w)
        ext = ".png" if i % 2 else ".jpg"
        cv2.imwrite(str(gt / f"{i:03d}{ext}"), img)
        cv2.imwrite(str(lq / f"{i:03d}{ext}"), cv2.resize(img, (w // 2, h // 2),
                                                           interpolation=cv2.INTER_AREA))
    (root / "meta.txt").write_text("".join(f"{i:03d}{'.png' if i % 2 else '.jpg'}\n"
                                           for i in (3, 1, 4)))
    return root


def _rds_opt(folders, **kw):
    return {**X4PLUS, "type": "RealESRGANDataset", "dataroot_gt": str(folders / "gt"),
            "io_backend": {"type": "disk"}, "crop_pad_size": 48, "seed": 11, **kw}


def _same_items(port, bem, n):
    for i in range(n):
        a, b = port[i], bem[i]
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"item {i} {k}")
            else:
                assert a[k] == b[k]


def test_realesrgan_dataset_no_flips(folders):
    opt = _rds_opt(folders, use_hflip=False, use_rot=False)
    port = build_dataset(opt)
    random.seed(11)
    np.random.seed(11)
    bem = bem_rds.RealESRGANDataset(dict(opt))
    _same_items(port, bem, 10)  # twice around the folder
    item = port[0]
    assert item["gt"].shape == (48, 48, 3)
    for k in ("kernel1", "kernel2", "sinc_kernel"):
        assert item[k].shape == (21, 21) and abs(item[k].sum() - 1) < 1e-5


def test_realesrgan_dataset_flips_and_meta_info(folders, monkeypatch):
    """bem_tpu's augment seeded as the port's dataset seeds its own."""
    opt = _rds_opt(folders, meta_info=str(folders / "meta.txt"), crop_pad_size=40)
    gen = np.random.default_rng(11)
    monkeypatch.setattr(bem_rds, "augment", lambda img, hflip, rot: bem_augment(
        img, hflip, rot, rng=gen))
    port = build_dataset(opt)
    random.seed(11)
    np.random.seed(11)
    _same_items(port, bem_rds.RealESRGANDataset(dict(opt)), 6)


@pytest.mark.parametrize("phase", ["train", "val"])
def test_realesrgan_paired_dataset(folders, phase):
    for extra in ({}, {"meta_info": str(folders / "meta.txt")},
                  {"mean": [0.5, 0.4, 0.3], "std": [0.2, 0.25, 0.3]}):
        opt = dict(type="RealESRGANPairedDataset", dataroot_gt=str(folders / "gt"),
                   dataroot_lq=str(folders / "lq"), io_backend={"type": "disk"}, phase=phase,
                   gt_size=32, scale=2, seed=5, **extra)
        port, bem = build_dataset(opt), BemPaired(dict(opt))
        assert len(port) == len(bem)
        _same_items(port, bem, len(port))
    with pytest.raises(NotImplementedError, match="lmdb"):
        build_dataset(dict(opt, io_backend={"type": "lmdb"}))


def _tie_mask(img, quality):
    """Pixels of the blocks holding a coefficient within 1e-4 of a
    rounding tie in bem_tpu's DiffJPEG."""
    seen = []

    def capture(x):
        seen.append(np.asarray(x))
        return bem_dj.diff_round(x)

    bem_dj.diff_jpeg(jnp.asarray(img), quality, rounding=capture)
    B, H, W, _ = img.shape
    mask = np.zeros((B, H, W), bool)
    for ci, x in enumerate(seen):
        s = 1 if ci == 0 else 2
        near = (np.abs(np.abs(x - np.floor(x)) - 0.5) < 1e-4).any(axis=(2, 3))  # (B, n)
        nbw = W // (8 * s)
        for b, n in zip(*np.nonzero(near)):
            r, c = divmod(int(n), nbw)
            mask[b, r * 8 * s:(r + 1) * 8 * s, c * 8 * s:(c + 1) * 8 * s] = True
    return mask


@pytest.mark.parametrize("quality", [30, 90])
def test_diff_jpeg(quality):
    rng = np.random.default_rng(quality)
    img = np.stack([_smooth(rng, 32, 48) for _ in range(2)]).astype(np.float32) / 255.0
    ident = diffjpeg.diff_jpeg(torch.from_numpy(img), quality, rounding=lambda x: x).numpy()
    want = np.asarray(bem_dj.diff_jpeg(jnp.asarray(img), quality, rounding=lambda x: x))
    np.testing.assert_allclose(ident, want, rtol=0, atol=2e-5)
    mask = _tie_mask(img, quality)[..., None]
    assert mask.mean() <= 0.1
    got = diffjpeg.diff_jpeg(torch.from_numpy(img), quality).numpy()
    want = np.asarray(bem_dj.diff_jpeg(jnp.asarray(img), quality))
    assert np.abs(np.where(mask, 0, got - want)).max() <= 2e-5
    w = rng.standard_normal(img.shape).astype(np.float32)
    gw = np.asarray(jax.grad(lambda x: jnp.sum(bem_dj.diff_jpeg(x, quality) * w))(
        jnp.asarray(img)))
    x = torch.from_numpy(img).requires_grad_(True)
    (diffjpeg.diff_jpeg(x, quality) * torch.from_numpy(w)).sum().backward()
    gp = x.grad.numpy()
    assert np.abs(np.where(mask, 0, gp - gw)).max() <= 1e-4 * np.abs(gw).max()
    assert diffjpeg.quality_to_factor(quality) == bem_dj.quality_to_factor(quality)
    with pytest.raises(ValueError, match="multiples of 16"):
        diffjpeg.diff_jpeg(torch.zeros(1, 24, 32, 3))


def test_diff_round():
    x = np.linspace(-3, 3, 601, dtype=np.float32)
    np.testing.assert_array_equal(diffjpeg.diff_round(torch.from_numpy(x)).numpy(),
                                  np.asarray(bem_dj.diff_round(jnp.asarray(x))))


def test_usm_sharp_both_forms():
    rng = np.random.default_rng(4)
    img = (_smooth(rng, 64, 80) / 255.0).astype(np.float32)
    np.testing.assert_allclose(usm_sharp(img), bem_usm(img), rtol=0, atol=1e-5)
    batch = np.stack([img, (_smooth(rng, 64, 80) / 255.0).astype(np.float32)])
    got = usm_sharp_torch(torch.from_numpy(batch)).numpy()
    np.testing.assert_allclose(got, np.asarray(usm_sharp_jax(jnp.asarray(batch))), rtol=0,
                               atol=1e-5)


def test_registry():
    assert {"RealESRGANDataset", "RealESRGANPairedDataset"} <= set(DATASETS)
    for name in ("REDSDataset", "Vimeo90KDataset", "VideoTestDataset",
                 "VideoRecurrentTestDataset"):
        assert DATASETS[name].__module__ == "bem_tpu_torch.data.video_datasets"
    with pytest.raises(NotImplementedError, match="dataset VideoDataset is not ported "
                                                  "\\(unknown"):
        build_dataset({"type": "VideoDataset"})
