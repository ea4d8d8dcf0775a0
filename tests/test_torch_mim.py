"""The MIM mask and mixup: the port vs bem_tpu.

- ``MaskGenerator`` masks equal bem_tpu's from the same generator, at the
  flagship's settings (patch 1, ratio 0.75) and with a patch scale.
- ``Dataset_PairedImage_Mask`` with ``mim``: three consecutive train
  samples equal to bem_tpu's, the mask included, for the ImageEnhancer
  (mask at gt_size) and the ConditionGenerator (at gt_size / scale_down),
  with label noise: the mask is drawn last from the dataset's generator, so
  any drift in the draw order shows in the second and third samples. The
  collated batch stacks the int32 masks.
- ``Network`` with a mask: the forward within 1e-3 of bem_tpu's (XLA scan
  backend), and the mask changes the output.
- Mixup with an injected lam equals bem_tpu's inline mix; ``MixingAugment``
  with ``use_identity`` on a fixed coin equals bem_tpu's class on the key
  that gives that coin and lam.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.archs import build_network as jax_build
from bem_tpu.data.paired_image_dataset import Dataset_PairedImage_Mask as JaxPairedMask
from bem_tpu.utils.mask import MaskGenerator as JaxMaskGenerator
from bem_tpu.utils.mixing_augment import MixingAugment as JaxMixingAugment
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.data import DataLoader, build_dataset
from bem_tpu_torch.utils.mask import MaskGenerator
from bem_tpu_torch.utils.mixing_augment import MixingAugment, mix, mixup_lam

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

GT_SIZE = 32
MIM = {"mask_ratio": 0.75, "mask_patch_size": 1, "model_patch_size": 1}


@pytest.mark.parametrize("args", [(128, 1, 1, 0.75), (32, 8, 2, 0.6), (8, 1, 1, 0.5)])
def test_mask_generator_matches_bem_tpu(args):
    want = JaxMaskGenerator(*args, rng=np.random.default_rng(4))
    got = MaskGenerator(*args, rng=np.random.default_rng(4))
    for _ in range(3):
        w, g = want(), got()
        assert g.dtype == np.int32 and g.shape == (args[0] // args[2],) * 2
        np.testing.assert_array_equal(g, w)
    assert got().sum() == got.mask_count * got.scale ** 2


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("mim_pairs")
    rng = np.random.default_rng(0)
    for kind in ("input", "target"):
        os.makedirs(root / kind)
    for name, h, w in (("a", 40, 56), ("b", 36, 44), ("c", 48, 48)):
        gt = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "target" / f"{name}.png"), gt)
        cv2.imwrite(str(root / "input" / f"{name}.png"), (gt * 0.3).astype(np.uint8))
    return root


@pytest.mark.parametrize("model_type", ["ImageEnhancer", "ConditionGenerator"])
def test_mim_dataset_matches_bem_tpu(folder, model_type):
    opt = dict(name="Set", type="Dataset_PairedImage_Mask", dataroot_gt=str(folder / "target"),
               dataroot_lq=str(folder / "input"), io_backend={"type": "disk"}, phase="train",
               gt_size=GT_SIZE, geometric_augs=True, condition={"type": "mean", "scale_down": 4},
               model_type=model_type, seed=3, scale=1, mim=MIM,
               labelnoise={"tem_mean": 1.0, "tem_var": 0.05, "bright_mean": 1.1})
    want, got = JaxPairedMask(dict(opt)), build_dataset(dict(opt))
    size = GT_SIZE if model_type == "ImageEnhancer" else GT_SIZE // 4
    for i in range(3):
        w, g = want[i], got[i]
        assert set(w) == set(g) and "mask" in g, i
        assert g["mask"].shape == (size, size) and g["mask"].dtype == np.int32
        np.testing.assert_array_equal(g["mask"], w["mask"], err_msg=f"mask {i}")
        np.testing.assert_array_equal(g["lq"], w["lq"], err_msg=f"lq {i}")
        np.testing.assert_allclose(g["gt"], w["gt"], rtol=0, atol=1e-6, err_msg=f"gt {i}")
    batch = next(iter(DataLoader(got, batch_size=2)))
    assert batch["mask"].shape == (2, size, size) and batch["mask"].dtype == np.int32


def test_network_mask_matches_bem_tpu():
    cfg = dict(type="Network", in_channels=6, out_channels=3, n_feat=8, num_blocks=(1, 1, 1),
               d_state=1, ssm_ratio=1, mlp_ratio=4, mlp_type="gdmlp", use_pixelshuffle=True)
    net = build_network(cfg, torch.Generator().manual_seed(2))
    params = state_dict_to_flax(net)
    rng = np.random.default_rng(1)
    x = rng.random((2, 16, 24, 6), np.float32)
    mask = np.stack([(rng.random((16, 24)) < 0.75).astype(np.int32) for _ in range(2)])
    jnet = jax_build(dict(cfg, scan_backend="xla"))
    want = np.asarray(jax.jit(lambda p, x, m: jnet.apply({"params": p}, x, m)[-1])(
        params, jnp.asarray(x), jnp.asarray(mask)))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(mask))[-1].numpy()
        plain = net(torch.from_numpy(x))[-1].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert np.abs(plain - got).max() > 1e-2  # the mask token took the masked features


def test_mixup_matches_bem_tpu():
    rng = np.random.default_rng(2)
    gt, lq = rng.random((3, 8, 8, 3), np.float32), rng.random((3, 8, 8, 3), np.float32)
    lam = jax.random.beta(jax.random.PRNGKey(7), 1.2, 1.2)
    want_gt = lam * gt + (1 - lam) * jnp.flip(gt, axis=0)
    want_lq = lam * lq + (1 - lam) * jnp.flip(lq, axis=0)
    got_gt, got_lq = mix(torch.from_numpy(gt), torch.from_numpy(lq), np.float32(lam))
    np.testing.assert_allclose(got_gt.numpy(), np.asarray(want_gt), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got_lq.numpy(), np.asarray(want_lq), rtol=0, atol=1e-7)
    # the trainers' draw: a function of (seed, step), in (0, 1)
    lams = [mixup_lam(1.2, 100, s) for s in range(4)]
    assert lams == [mixup_lam(1.2, 100, s) for s in range(4)] and len(set(lams)) == 4
    assert all(0 < v < 1 for v in lams)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_mixing_augment_matches_bem_tpu(seed):
    """bem_tpu's class on key ``seed``; the port's on the coin and lam that
    key draws (use_identity: coin from the first split key, lam from the
    second)."""
    rng = np.random.default_rng(seed)
    gt, lq = rng.random((4, 8, 8, 3), np.float32), rng.random((4, 8, 8, 3), np.float32)
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    do_mix = bool(jax.random.uniform(k1) < 0.5)
    lam = np.float32(jax.random.beta(k2, 1.2, 1.2))
    want = JaxMixingAugment(1.2, use_identity=True)(key, gt, lq)
    got = MixingAugment(1.2, True, np.random.default_rng(9))(
        torch.from_numpy(gt), torch.from_numpy(lq), lam=lam, do_mix=do_mix)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-7)
    if not do_mix:
        assert torch.equal(got[0], torch.from_numpy(gt))
    # without use_identity: always mixed, lam from the key itself
    want = JaxMixingAugment(1.2)(key, gt, lq)
    got = MixingAugment(1.2, False, np.random.default_rng(9))(
        torch.from_numpy(gt), torch.from_numpy(lq), lam=np.float32(jax.random.beta(key, 1.2, 1.2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-7)
    # its own draws come from its generator
    a = MixingAugment(1.2, True, np.random.default_rng(9))(torch.from_numpy(gt), torch.from_numpy(lq))
    b = MixingAugment(1.2, True, np.random.default_rng(9))(torch.from_numpy(gt), torch.from_numpy(lq))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
