"""The eight datasets this slice ports against bem_tpu's on the same seeded
folders and draws: the same keys, the same paths, equal arrays (bit for
bit), item by item.

- ``SingleImageDataset`` (folder and meta-info file, mean / std),
  ``Dataset_PairedImage_Slide`` (400x600 pairs, train and val),
  ``Dataset_PairedImage_Norm``, ``PairedImageDataset`` (``augment``'s
  flips), on folders mixing PNG, progressive JPEG, TIFF and BMP.
- ``Dataset_DefocusDeblur_DualPixel_16bit`` on 16-bit PNG and TIFF
  triples, padded where smaller than gt_size.
- ``Dataset_GaussianDenoising`` at in_ch 3 and 1 (grey through the
  grayscale flag; a grey image that needed padding comes out 2-D, as cv2
  pads it), each sigma_type, and the val phase's seeded noise;
  ``FFHQDataset``.
- ``Dataset_SIDImage`` on .npy frames and PNG frames resized to
  train_size: bem_tpu draws its flips from Python's ``random``, the port
  from its ``rng``; the test hands both the same draws. Its PNG frames
  resize in float32, where cv2's IPP build differs by float32 ulps, so
  bem_tpu runs with IPP off for them (the port follows OpenCV's own code).
- The registry knows every ported dataset (the two RealESRGAN ones
  since they were ported); lmdb and the unported ones raise.

Each bem_tpu dataset and its port get the same ``seed``: both draw from
``np.random.default_rng(seed)`` in the same order.
"""

import os

import cv2
import numpy as np
import pytest

import bem_tpu.data.sid_image_dataset as bem_sid
from bem_tpu.data.gaussian_denoising_dataset import Dataset_GaussianDenoising as BemGauss
from bem_tpu.data.gaussian_denoising_dataset import FFHQDataset as BemFFHQ
from bem_tpu.data.paired_image_dataset import Dataset_DefocusDeblur_DualPixel_16bit as BemDP
from bem_tpu.data.paired_image_dataset import Dataset_PairedImage_Norm as BemNorm
from bem_tpu.data.paired_image_dataset import Dataset_PairedImage_Slide as BemSlide
from bem_tpu.data.paired_image_dataset import PairedImageDataset as BemPaired
from bem_tpu.data.single_image_dataset import SingleImageDataset as BemSingle
from bem_tpu_torch.data import DATASETS, build_dataset
from bem_tpu_torch.utils.image_writers import encode_png_samples, encode_tiff

from test_torch_jpeg import scene

DISK = {"type": "disk"}


def _write(path, rgb):
    """Write an (H, W, 3) uint8 RGB image in the format its extension names."""
    ext = os.path.splitext(path)[1]
    if ext == ".tif":
        data = encode_tiff(rgb, 2, 8, 5, 2)
    elif ext == ".jpg":
        ok, buf = cv2.imencode(".jpg", rgb[..., ::-1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                                        cv2.IMWRITE_JPEG_QUALITY, 92])
        data = buf.tobytes()
    elif ext == ".bmp":
        ok, buf = cv2.imencode(".bmp", rgb[..., ::-1])
        data = buf.tobytes()
    else:
        data = encode_png_samples(rgb, 2, 8, interlace=True)
    with open(path, "wb") as f:
        f.write(data)


def _pairs(root, sizes, exts, seed):
    """input/ and target/ folders of seeded pairs, one extension each."""
    rng = np.random.default_rng(seed)
    for sub in ("input", "target"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, ((h, w), ext) in enumerate(zip(sizes, exts)):
        gt = scene(seed + i, h, w)
        lq = (gt * rng.uniform(0.1, 0.4)).astype(np.uint8)
        _write(os.path.join(root, "target", f"{i:03d}{ext}"), gt)
        _write(os.path.join(root, "input", f"{i:03d}{ext}"), lq)
    return os.path.join(root, "input"), os.path.join(root, "target")


def _same_item(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape and g.dtype == w.dtype, (key, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


def _same_dataset(port, bem, indices=None):
    assert len(port) == len(bem)
    for i in indices if indices is not None else range(len(bem)):
        _same_item(port[i], bem[i])


def _opt(ds_type, phase, **kw):
    return dict(type=ds_type, phase=phase, io_backend=dict(DISK), seed=7, **kw)


def test_single_image_dataset(tmp_path):
    lq, _ = _pairs(str(tmp_path), [(17, 23), (20, 11), (9, 31)], [".png", ".jpg", ".tif"], 1)
    opt = _opt("SingleImageDataset", "test", dataroot_lq=lq)
    _same_dataset(build_dataset(opt), BemSingle(dict(opt)))
    meta = tmp_path / "meta.txt"
    meta.write_text("002.tif 9 31\n000.png 17 23\n")
    opt = dict(opt, meta_info_file=str(meta), mean=[0.5, 0.4, 0.3], std=[0.2, 0.25, 0.3])
    _same_dataset(build_dataset(opt), BemSingle(dict(opt)))


@pytest.mark.parametrize("phase", ["train", "val"])
def test_slide_dataset(tmp_path, phase):
    lq, gt = _pairs(str(tmp_path), [(400, 600), (400, 600)], [".png", ".bmp"], 2)
    opt = _opt("Dataset_PairedImage_Slide", phase, dataroot_lq=lq, dataroot_gt=gt, gt_size=128,
               stride=136)
    port, bem = build_dataset(opt), BemSlide(dict(opt))
    assert len(port) == 24
    _same_dataset(port, bem, [0, 5, 11, 12, 17, 23, 3, 3])


@pytest.mark.parametrize("ds_type", ["Dataset_PairedImage_Norm", "PairedImageDataset"])
@pytest.mark.parametrize("phase", ["train", "val"])
def test_norm_and_basicsr_paired(tmp_path, ds_type, phase):
    lq, gt = _pairs(str(tmp_path), [(40, 56), (20, 27), (48, 48), (33, 40)],
                    [".png", ".jpg", ".tif", ".bmp"], 3)
    opt = _opt(ds_type, phase, dataroot_lq=lq, dataroot_gt=gt, gt_size=32,
               geometric_augs=True, use_hflip=True, use_rot=True)
    bem = (BemNorm if ds_type == "Dataset_PairedImage_Norm" else BemPaired)(dict(opt))
    _same_dataset(build_dataset(opt), bem, [0, 1, 2, 3, 2, 1])


def _dp_folders(root, seed):
    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, k) for k in ("lqL", "lqR", "gt")}
    for d in dirs.values():
        os.makedirs(d)
    for i, ((h, w), ext) in enumerate((((20, 24), ".png"), ((40, 36), ".tif"))):
        for key, d in dirs.items():
            s = rng.integers(0, 65536, (h, w, 3))
            data = encode_png_samples(s, 2, 16) if ext == ".png" else encode_tiff(s, 2, 16, 8, 2)
            with open(os.path.join(d, f"{i:03d}{ext}"), "wb") as f:
                f.write(data)
    return dirs


@pytest.mark.parametrize("phase", ["train", "val"])
def test_dual_pixel_16bit(tmp_path, phase):
    dirs = _dp_folders(str(tmp_path), 4)
    opt = _opt("Dataset_DefocusDeblur_DualPixel_16bit", phase, dataroot_lqL=dirs["lqL"],
               dataroot_lqR=dirs["lqR"], dataroot_gt=dirs["gt"], gt_size=32,
               geometric_augs=True)
    port, bem = build_dataset(opt), BemDP(dict(opt))
    _same_dataset(port, bem, [0, 1, 1, 0])
    assert port[0]["lq"].shape[-1] == 6


@pytest.mark.parametrize("in_ch", [3, 1])
@pytest.mark.parametrize("sigma", [("constant", 25), ("random", [5, 50]),
                                   ("choice", [15, 25, 50])])
def test_gaussian_denoising(tmp_path, in_ch, sigma):
    _, gt = _pairs(str(tmp_path), [(40, 56), (20, 27), (36, 36)], [".png", ".jpg", ".bmp"], 5)
    opt = _opt("Dataset_GaussianDenoising", "train", dataroot_gt=gt, gt_size=32, in_ch=in_ch,
               sigma_type=sigma[0], sigma_range=sigma[1])
    port = build_dataset(opt)
    _same_dataset(port, BemGauss(dict(opt)), [0, 1, 2, 1])
    if in_ch == 1:
        assert port[1]["gt"].ndim == 2  # padded from 20x27, as cv2 pads (H, W, 1)
    opt = _opt("Dataset_GaussianDenoising", "val", dataroot_gt=gt, in_ch=in_ch, sigma_test=25)
    _same_dataset(build_dataset(opt), BemGauss(dict(opt)))


def test_ffhq(tmp_path):
    _, gt = _pairs(str(tmp_path), [(32, 32)] * 4, [".png", ".jpg", ".tif", ".bmp"], 6)
    for extra in ({}, {"use_hflip": False, "mean": [0.5] * 3, "std": [0.5] * 3}):
        opt = _opt("FFHQDataset", "train", dataroot_gt=gt, **extra)
        _same_dataset(build_dataset(opt), BemFFHQ(dict(opt)), [0, 1, 2, 3, 0, 1])


class _Draws:
    """The same uniform draws for bem_tpu's ``random.random`` and the port's
    ``rng.random``."""

    def __init__(self, values):
        self.values = list(values)

    def random(self):
        return self.values.pop(0)


def _sid_folders(root, seed):
    rng = np.random.default_rng(seed)
    for clip, n, kind in (("0_a", 3, ".npy"), ("1_b", 2, ".png"), ("2_c", 2, ".png")):
        for side, count in (("lq", n), ("gt", 2)):
            d = os.path.join(root, side, clip)
            os.makedirs(d)
            for i in range(count):
                bgr = rng.integers(0, 256, (24, 30, 3)).astype(np.uint8)
                path = os.path.join(d, f"{i:03d}{kind}")
                if kind == ".npy":
                    np.save(path, bgr)
                else:
                    with open(path, "wb") as f:
                        f.write(encode_png_samples(bgr[..., ::-1], 2, 8))
    return os.path.join(root, "lq"), os.path.join(root, "gt")


@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("train_size", [None, (20, 16), (15, 12)])
def test_sid(tmp_path, monkeypatch, phase, train_size):
    lq, gt = _sid_folders(str(tmp_path), 8)
    opt = _opt("Dataset_SIDImage", phase, dataroot_lq=lq, dataroot_gt=gt, N_frames=3,
               train_size=list(train_size) if train_size else None)
    port, bem = build_dataset(opt), bem_sid.Dataset_SIDImage(dict(opt))
    assert len(port) == len(bem) == (5 if phase == "train" else 2)
    draws = np.random.default_rng(9).random(4 * len(port)).tolist()
    port.rng = _Draws(draws)
    monkeypatch.setattr(bem_sid, "random", _Draws(draws))
    use = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)  # the float32 resize of PNG frames: OpenCV's own code
    try:
        _same_dataset(port, bem, list(range(len(port))) * 2)
    finally:
        cv2.ipp.setUseIPP(use)


def test_registry():
    ported = {"Dataset_PairedImage", "Dataset_PairedImage_Mask", "Dataset_PairedImage_Slide",
              "Dataset_PairedImage_Norm", "Dataset_DefocusDeblur_DualPixel_16bit",
              "PairedImageDataset", "SingleImageDataset", "Dataset_GaussianDenoising",
              "FFHQDataset", "Dataset_SIDImage", "RealESRGANDataset", "RealESRGANPairedDataset",
              "REDSDataset", "Vimeo90KDataset", "VideoTestDataset", "REDSRecurrentDataset",
              "Vimeo90KRecurrentDataset", "VideoTestVimeo90KDataset", "VideoTestDUFDataset",
              "VideoRecurrentTestDataset"}
    assert set(DATASETS) == ported
    for name in ("Vimeo90KDatasetX", "LMDBDataset"):
        with pytest.raises(NotImplementedError, match=f"dataset {name} is not ported"):
            build_dataset({"type": name})
    with pytest.raises(NotImplementedError, match="lmdb"):
        build_dataset(dict(type="SingleImageDataset", phase="test", dataroot_lq="x",
                           io_backend={"type": "lmdb"}))
