"""The port's data pipeline against bem_tpu's, on seeded PNG / BMP files.

- ``Dataset_PairedImage_Mask``, train and val phases, IE and CG keys, the
  mean and histogram conditions, GT label noise, and an image smaller than
  gt_size (padded with cv2.BORDER_REFLECT): lq / gt exactly equal, the
  conditions within 1e-6, from the same ``seed`` (bem_tpu decodes BGR
  through cv2 and flips; the port decodes RGB).
- ``EnlargedSampler`` indices, and loader batches with num_workers 0 (the
  train phase, every draw in order) and 2 (no draws: threads share the
  generator, so only a single-threaded loader draws in a fixed order).
- The /16 condition ``downsample`` against ``cv2.resize(fx=1/16)`` within
  1e-6, at 400x600 and 120x180 (widths 16 does not divide) and 128x128;
  the padding, the transforms and image decoding against bem_tpu's.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from bem_tpu.data import DataLoader as JaxLoader
from bem_tpu.data import EnlargedSampler as JaxSampler
from bem_tpu.data import build_dataloader as jax_build_dataloader
from bem_tpu.data import transforms as jt
from bem_tpu.data.paired_image_dataset import Dataset_PairedImage as JaxPaired
from bem_tpu.data.paired_image_dataset import Dataset_PairedImage_Mask as JaxPairedMask
from bem_tpu.utils.img_util import imfrombytes as jax_imfrombytes
from bem_tpu.utils.img_util import padding as jax_padding
from bem_tpu_torch.data import DataLoader, EnlargedSampler, build_dataloader, build_dataset
from bem_tpu_torch.data import transforms as pt
from bem_tpu_torch.utils.img_util import downsample, imfrombytes, padding, tensor2img

from test_torch_cpu_setup import quick_compile  # noqa: F401  (module fixtures)

# (name, H, W, extension): an image smaller than GT_SIZE is padded first
IMAGES = [("a", 40, 56, ".png"), ("b", 20, 27, ".bmp"), ("c", 48, 48, ".png")]
GT_SIZE = 32
CONDITIONS = {"mean": {"type": "mean", "scale_down": 4},
              "histogram": {"type": "histogram", "hist_patch_size": 8, "num_bins": 16}}
LABELNOISE = {"tem_mean": 1.0, "tem_var": 0.05, "bright_mean": 1.1, "bright_var": 0.1}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    for kind in ("input", "target"):
        os.makedirs(root / kind)
    for name, h, w, ext in IMAGES:
        gt = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "target" / f"{name}{ext}"), gt)
        cv2.imwrite(str(root / "input" / f"{name}{ext}"), (gt * 0.3).astype(np.uint8))
    return root


def _opt(root, phase, model_type="ImageEnhancer", cond="mean", **kw):
    return dict(name="Set", type="Dataset_PairedImage_Mask", dataroot_gt=str(root / "target"),
                dataroot_lq=str(root / "input"), io_backend={"type": "disk"}, phase=phase,
                gt_size=GT_SIZE, geometric_augs=True, condition=CONDITIONS[cond],
                model_type=model_type, seed=3, scale=1, batch_size_per_gpu=2,
                num_worker_per_gpu=0, **kw)


def _assert_sample(want, got, where):
    assert set(want) == set(got), where
    for k, v in want.items():
        if isinstance(v, (str, list)):
            assert v == got[k], (where, k)
            continue
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, (where, k)
        if k in ("lq", "gt"):
            np.testing.assert_array_equal(got[k], v, err_msg=f"{where} {k}")
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=f"{where} {k}")


@pytest.mark.parametrize("model_type", ["ImageEnhancer", "ConditionGenerator"])
@pytest.mark.parametrize("cond", ["mean", "histogram"])
@pytest.mark.parametrize("phase", ["train", "val"])
def test_paired_mask_dataset_matches_bem_tpu(folder, model_type, cond, phase):
    opt = _opt(folder, phase, model_type, cond, labelnoise=LABELNOISE)
    want, got = JaxPairedMask(dict(opt)), build_dataset(dict(opt))
    assert len(got) == len(want) == len(IMAGES)
    for i in range(2 * len(IMAGES)):  # train: each image twice, other crops
        _assert_sample(want[i], got[i], f"{model_type} {cond} {phase} sample {i}")


def test_paired_dataset_matches_bem_tpu(folder):
    opt = dict(_opt(folder, "train"), type="Dataset_PairedImage", mean=[0.5, 0.4, 0.3],
               std=[0.2, 0.25, 0.3])
    want, got = JaxPaired(dict(opt)), build_dataset(dict(opt))
    for i in range(len(IMAGES)):
        _assert_sample(want[i], got[i], f"sample {i}")


def test_unported_options_raise(folder):
    with pytest.raises(NotImplementedError, match="mim not supported for histogram"):
        build_dataset(_opt(folder, "train", cond="histogram", mim={"mask_ratio": 0.5}))
    with pytest.raises(NotImplementedError, match="lmdb"):
        build_dataset(dict(_opt(folder, "train"), io_backend={"type": "lmdb"}))
    with pytest.raises(NotImplementedError, match="not ported"):
        build_dataset(dict(_opt(folder, "train"), type="NoSuchDataset"))
    # the video datasets are ported; their lmdb backend stays refused
    meta = os.path.join(folder, "meta_info.txt")
    with open(meta, "w") as f:
        f.write("001 4 (16,16,3)\n")
    reds = build_dataset(dict(type="REDSDataset", phase="train", dataroot_gt=folder,
                              dataroot_lq=folder, meta_info_file=meta, num_frame=3, gt_size=8,
                              scale=1, frames_per_clip=4, io_backend={"type": "lmdb"}))
    assert type(reds).__name__ == "REDSDataset" and len(reds) == 4
    with pytest.raises(NotImplementedError, match="lmdb"):
        reds[1]


@pytest.mark.parametrize("n,replicas,ratio,seed", [(7, 1, 1, 0), (10, 2, 3, 100), (5, 3, 2, 7)])
def test_enlarged_sampler_matches_bem_tpu(n, replicas, ratio, seed):
    for rank in range(replicas):
        want, got = JaxSampler(n, replicas, rank, ratio, seed), EnlargedSampler(n, replicas, rank,
                                                                                ratio, seed)
        assert len(got) == len(want)
        for epoch in range(3):
            want.set_epoch(epoch)
            got.set_epoch(epoch)
            assert list(got) == list(want)


def test_train_loader_batches_match_bem_tpu(folder):
    """num_workers 0: the sampler's order, drop_last and the dataset's draws
    give bem_tpu's batches, epoch after epoch."""
    opt = _opt(folder, "train", "ConditionGenerator", dataset_enlarge_ratio=3)
    loaders = []
    for Sampler, build, ds in ((JaxSampler, jax_build_dataloader, JaxPairedMask(dict(opt))),
                               (EnlargedSampler, build_dataloader, build_dataset(dict(opt)))):
        loaders.append(build(ds, opt, sampler=Sampler(len(ds), 1, 0, 3, seed=100), seed=100))
    want, got = loaders
    assert len(got) == len(want) == 4  # 9 samples, batches of 2, the last dropped
    for epoch in range(2):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        pairs = list(zip(want, got))
        assert len(pairs) == 4
        for i, (w, g) in enumerate(pairs):
            _assert_sample(w, g, f"epoch {epoch} batch {i}")


def test_threaded_loader_batches_match_bem_tpu(folder):
    """num_workers 2 on draw-free samples: the same batches in the same order."""
    opt = _opt(folder, "val")
    want = JaxLoader(JaxPairedMask(dict(opt)), batch_size=1, shuffle=True, num_workers=2, seed=5)
    got = DataLoader(build_dataset(dict(opt)), batch_size=1, shuffle=True, num_workers=2, seed=5)
    for epoch in range(2):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        pairs = list(zip(want, got))
        assert len(pairs) == len(IMAGES)
        for i, (w, g) in enumerate(pairs):
            _assert_sample(w, g, f"epoch {epoch} batch {i}")


@pytest.mark.parametrize("shape", [(400, 600), (120, 180), (128, 128)])
def test_downsample_matches_cv2_fx(shape):
    img = np.random.default_rng(4).random((*shape, 3)).astype(np.float32)
    want = cv2.resize(img, None, fx=1 / 16, fy=1 / 16, interpolation=cv2.INTER_LINEAR)
    got = downsample(img, 16)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(20, 27), (5, 40), (32, 9)])
def test_padding_is_border_reflect(shape):
    rng = np.random.default_rng(1)
    a, b = rng.random((*shape, 3)).astype(np.float32), rng.random((*shape, 3)).astype(np.float32)
    for want, got in zip(jax_padding(a, b, GT_SIZE), padding(a, b, GT_SIZE)):
        np.testing.assert_array_equal(got, want)


def test_transforms_match_bem_tpu():
    rng = np.random.default_rng(2)
    gt, lq = rng.random((20, 26, 3)), rng.random((10, 13, 3))
    for seed in range(6):
        w = jt.paired_random_crop(gt, lq, 8, 2, rng=np.random.default_rng(seed))
        g = pt.paired_random_crop(gt, lq, 8, 2, rng=np.random.default_rng(seed))
        for a, b in zip(w, g):
            np.testing.assert_array_equal(b, a)
        w = jt.augment([gt, lq], rng=np.random.default_rng(seed))
        g = pt.augment([gt, lq], rng=np.random.default_rng(seed))
        for a, b in zip(w, g):
            np.testing.assert_array_equal(b, a)
        w = jt.random_augmentation(gt, lq, rng=np.random.default_rng(seed))
        g = pt.random_augmentation(gt, lq, rng=np.random.default_rng(seed))
        for a, b in zip(w, g):
            np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(pt.mod_crop(gt, 4), jt.mod_crop(gt, 4))


@pytest.mark.parametrize("ext", [".png", ".bmp"])
def test_image_decoding_matches_cv2(tmp_path, ext):
    img = (np.random.default_rng(3).random((9, 14, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / f"x{ext}"), img)
    data = (tmp_path / f"x{ext}").read_bytes()
    bgr = jax_imfrombytes(data, float32=True)
    np.testing.assert_array_equal(imfrombytes(data, float32=True), bgr[..., ::-1])
    assert (tensor2img(bgr[..., ::-1], rgb2bgr=True) == img).all()
