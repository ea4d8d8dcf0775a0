"""The classifier's ImageFolder loader and cv2 augmentations against
bem_tpu's, bit for bit under one seed.

bem_tpu draws from Python's global ``random`` and numpy's global legacy
state; the port from the ``random.Random`` / ``np.random.RandomState`` its
loader owns. Each test seeds both with one number. The uint8 cubic resize
follows OpenCV's own code, which cv2's IPP build replaces, so bem_tpu runs
with IPP off here (``cv2_own_code``); ``test_cv_ops.py`` shows IPP's
difference.

- The train and eval transforms under each interpolation, through the
  loaders (RandAugment, flips, random erasing at the harness defaults).
- Each of the twelve RandAugment ops, by a seed that draws it first, at
  magnitudes 0, 9 and 30, on odd sizes.
- Color jitter (``AUTO_AUGMENT`` empty) and random erasing in both modes.
- ``ShardedBatchLoader``'s order over rank, world_size, drop_last and
  epochs; ``build_loader``'s tuple; WebP files read as cv2 reads them, an
  animated one raises, naming itself.
"""

import os
import random

import cv2
import numpy as np
import pytest

import bem_tpu.classification.data as bem
from bem_tpu.classification.config import get_config as bem_get_config
from bem_tpu_torch.classification import data as port
from bem_tpu_torch.classification.config import get_config

SIZES = [(40, 56), (33, 47), (64, 48), (29, 31), (50, 50), (45, 61)]


@pytest.fixture(autouse=True)
def cv2_own_code():
    use = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(use)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """train/ and val/ with 3 classes of 4 and 2 images, PNG / JPEG / BMP."""
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(0)
    exts = [".png", ".jpg", ".JPEG", ".bmp"]
    for split, n in (("train", 4), ("val", 2)):
        for c in range(3):
            d = root / split / f"n{c:04d}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = SIZES[(c * n + i) % len(SIZES)]
                img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 0)
                cv2.imwrite(str(d / f"img{i}{exts[(c + i) % 4]}"), img)
    return str(root)


def _configs(tree, **aug):
    cfgs = []
    for get in (get_config, bem_get_config):
        c = get()
        c.DATA.DATA_PATH, c.DATA.IMG_SIZE, c.DATA.BATCH_SIZE = tree, 32, 4
        for k, v in aug.items():
            node, key = (c.DATA, k) if k == "INTERPOLATION" else (c.AUG, k)
            node[key] = v
        cfgs.append(c)
    return cfgs


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _batches(loader, epochs=(0,)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out += list(loader)
    return out


def _assert_batches(got, want):
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype == np.float32 and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("interp", ["bicubic", "bilinear", "nearest", "random"])
def test_train_and_eval_transforms(tree, interp):
    """The loaders of both packages over two epochs (train) and once (val),
    the harness's augmentation defaults, seed 7."""
    pc, bc = _configs(tree, INTERPOLATION=interp)
    pc.SEED = bc.SEED = 7
    _, _, plt, plv, _ = port.build_loader(pc)
    _seed(7)
    _, _, blt, blv, _ = bem.build_loader(bc)
    _assert_batches(_batches(plt, (0, 1)), _batches(blt, (0, 1)))
    _assert_batches(list(plv), list(blv))
    for crop in (True, False):
        pc.TEST.CROP = bc.TEST.CROP = crop
        ptf, btf = port.build_transform(False, pc), bem.build_transform(False, bc)
        for h, w in SIZES:
            img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
            np.testing.assert_array_equal(ptf(img), btf(img))


def _seed_first_op(k):
    """A seed whose RandAugment draws op k first."""
    for s in range(10000):
        if random.Random(s).sample(range(12), 2)[0] == k:
            return s
    raise AssertionError(k)


@pytest.mark.parametrize("k", range(12))
def test_rand_augment_ops(k):
    rng = np.random.default_rng(k)
    s = _seed_first_op(k)
    for magnitude in (0, 9, 30):
        for h, w in ((32, 32), (37, 53), (31, 17)):
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            if k == 6:  # equalize: a narrow histogram as well
                img = (img // 16 + 100).astype(np.uint8)
            _seed(s)
            want = bem._rand_augment(img.copy(), magnitude)
            got = port._rand_augment(img.copy(), random.Random(s), magnitude)
            np.testing.assert_array_equal(got, want, err_msg=f"op {k} m{magnitude} {h}x{w}")


def test_color_jitter_and_erasing(tree):
    rng = np.random.default_rng(3)
    for s in range(8):
        img = rng.integers(0, 256, (37, 41, 3), dtype=np.uint8)
        _seed(s)
        want = bem._color_jitter(img, 0.4)
        np.testing.assert_array_equal(port._color_jitter(img, 0.4, random.Random(s)), want)
        f = rng.standard_normal((32, 32, 3)).astype(np.float32)
        for mode in ("pixel", "const"):
            _seed(s)
            want = bem._random_erasing(f.copy(), 1.0, mode)
            got = port._random_erasing(f.copy(), 1.0, random.Random(s), np.random.RandomState(s),
                                       mode)
            np.testing.assert_array_equal(got, want)
    pc, bc = _configs(tree, AUTO_AUGMENT="", COLOR_JITTER=0.4, REPROB=0.5)
    _, _, plt, _, _ = port.build_loader(pc)
    _seed(pc.SEED)
    _, _, blt, _, _ = bem.build_loader(bc)
    _assert_batches(_batches(plt, (0, 1)), _batches(blt, (0, 1)))


def test_auto_augment_none_string_runs_rand_augment(tree):
    """bem_tpu's ``if config.AUG.AUTO_AUGMENT:`` is true for "none"."""
    pc, bc = _configs(tree, AUTO_AUGMENT="none")
    _, _, plt, _, _ = port.build_loader(pc)
    _seed(pc.SEED)
    _, _, blt, _, _ = bem.build_loader(bc)
    _assert_batches(list(plt), list(blt))


class _Numbers:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2,), i, np.float32), i

    def get(self, i, py_rng=None, np_rng=None):
        return self[i]


@pytest.mark.parametrize("rank,world,drop_last,shuffle", [
    (0, 1, True, True), (1, 3, True, True), (2, 3, False, True), (0, 2, False, False),
    (1, 2, True, False)])
def test_sharded_loader_order(rank, world, drop_last, shuffle):
    ds = _Numbers(23)
    p = port.ShardedBatchLoader(ds, 4, shuffle, rank, world, seed=5, drop_last=drop_last)
    b = bem.ShardedBatchLoader(ds, 4, shuffle, rank, world, seed=5, drop_last=drop_last)
    assert len(p) == len(b)
    _assert_batches(_batches(p, (0, 1, 2)), _batches(b, (0, 1, 2)))


def test_build_loader_tuple(tree):
    pc, bc = _configs(tree)
    got, want = port.build_loader(pc), bem.build_loader(bc)
    assert len(got) == len(want) == 5
    assert got[4] is want[4] is True  # mixup_active, applied by neither
    for g, w in zip(got[:2], want[:2]):
        assert g.samples == w.samples and g.classes == w.classes
    for g, w in zip(got[2:4], want[2:4]):
        assert (len(g), g.shuffle, g.drop_last) == (len(w), w.shuffle, w.drop_last)
    assert port.build_dataset(True, pc)[1] == bem.build_dataset(True, bc)[1] == 1000
    assert port.find_classes(os.path.join(tree, "train")) == bem.find_classes(
        os.path.join(tree, "train"))


def test_webp_raises_naming_the_file(tmp_path):
    """A lossy and a lossless WebP read as bem_tpu's cv2 reads them; an
    animated WebP, whose first frame cv2 reads, raises naming itself."""
    d = tmp_path / "train" / "cls"
    d.mkdir(parents=True)
    img = cv2.GaussianBlur(np.random.default_rng(5).integers(0, 256, (33, 47, 3), np.uint8),
                           (5, 5), 0)
    for fn, q in (("a.webp", 80), ("b.webp", 101)):
        ok, buf = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, q])
        (d / fn).write_bytes(buf.tobytes())
    anim = cv2.Animation()
    anim.frames, anim.durations = [img, img[::-1].copy()], [100, 100]
    ok, buf = cv2.imencodeanimation(".webp", anim)
    path = d / "c.webp"
    path.write_bytes(buf.tobytes())
    cfgs = []
    for get in (get_config, bem_get_config):
        cfg = get()
        cfg.DATA.DATA_PATH, cfg.DATA.IMG_SIZE = str(tmp_path), 32
        cfgs.append(cfg)
    ds, _ = port.build_dataset(True, cfgs[0])
    bds, _ = bem.build_dataset(True, cfgs[1])
    ds.transform = bds.transform = None
    assert [s for s, _ in ds.samples] == [str(d / f) for f in ("a.webp", "b.webp", "c.webp")]
    for i in (0, 1):
        np.testing.assert_array_equal(ds[i][0], bds[i][0])
    assert bds[2][0].shape == (33, 47, 3)
    with pytest.raises(ValueError, match=f"{path}: an animated WebP"):
        ds[2]