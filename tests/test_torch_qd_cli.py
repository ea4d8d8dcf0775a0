"""The QD trainer and evaluator: the port's against bem_tpu's, end to end.

- ``qd.train.train_qd``, model4 on two 40x48 PNG pairs (patch 32, batch 2,
  one step an epoch, no loader threads, the same seed), each objective in
  turn (``recon_only_epochs`` 1 and 0): bem_tpu's trainer starts from the
  port's seeded weights (its ``Decomp.init`` hands them back). The epoch's
  loss within 1e-5 relative; the gradient (Adam's first moment / 0.1) of
  every leaf within 1e-3 of its largest entry; the updated params within
  1e-5 where the gradient is clearly nonzero (Adam's first step is lr *
  sign(g) there), within one step elsewhere; the validation's
  reconstruction PSNR / SSIM within 1e-4. Each package's
  ``model4_0.msgpack`` loads in the other's ``Decomp`` with every leaf
  equal.
- ``qd.evaluate.main`` on two 64x96 pairs with the shipped model4, with
  ``--lpips`` (seeded AlexNet-shaped weights) and ``--save_components``:
  PSNR, SSIM, RCI and LPIPS within 1e-4, and the written components within
  1 LSB of bem_tpu's (it writes through cv2, so it flips them to BGR; the
  port's files are RGB and equal).
"""

import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch
from flax import serialization

import bem_tpu.qd.train as jax_qd_train
from bem_tpu.qd import Decomp as JaxDecomp
from bem_tpu.qd.evaluate import main as jax_evaluate
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.nn.init import initialize
from bem_tpu_torch.qd import Decomp
from bem_tpu_torch.qd.evaluate import load_qd_net
from bem_tpu_torch.qd.evaluate import main as evaluate
from bem_tpu_torch.qd.train import train_qd
from bem_tpu_torch.utils.img_util import imread

from test_torch_checkpoint_write import _copy, _flat
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)
from test_torch_eval_metrics import _ALEX


def _write_pairs(root, n, h, w, seed):
    rng = np.random.default_rng(seed)
    for kind in ("low", "high"):
        os.makedirs(root / kind, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w] / 9.0
    for i in range(n):
        base = 0.5 + 0.4 * np.sin(yy + (i + 1) * 0.6 * xx)[..., None] * rng.random((1, 1, 3))
        high = np.clip(base + 0.05 * rng.standard_normal((h, w, 3)), 0, 1)
        cv2.imwrite(str(root / "high" / f"{i}.png"), (high * 255).round().astype(np.uint8))
        cv2.imwrite(str(root / "low" / f"{i}.png"), (high * 64).round().astype(np.uint8))
    return str(root / "low"), str(root / "high")


@pytest.mark.parametrize("recon_only_epochs", [1, 0], ids=["recon_only", "retinex"])
def test_train_qd_matches_bem_tpu(tmp_path, monkeypatch, recon_only_epochs):
    low, high = _write_pairs(tmp_path / "train", 2, 40, 48, seed=0)
    vlow, vhigh = _write_pairs(tmp_path / "val", 1, 20, 26, seed=1)
    net = initialize(Decomp("model4"), torch.Generator().manual_seed(3))
    params0 = _copy(state_dict_to_flax(net))

    class Seeded(JaxDecomp):
        def init(self, *args, **kwargs):
            return {"params": params0}

    monkeypatch.setattr(jax_qd_train, "Decomp", Seeded)
    common = dict(model_type="model4", low_dir=low, high_dir=high, val_low_dir=vlow,
                  val_high_dir=vhigh, epochs=1, batch_size=2, patch_size=32,
                  recon_only_epochs=recon_only_epochs, seed=4, num_workers=0)
    jstate, jhist = jax_qd_train.train_qd(out_dir=str(tmp_path / "jax"), **common)
    trainer, hist = train_qd(out_dir=str(tmp_path / "port"), device="cpu", net=net, **common)
    assert trainer.step == int(jstate.step) == 1 and len(hist) == len(jhist) == 1
    (j,), (p,) = jhist, hist
    assert set(p) == set(j) == {"epoch", "loss", "recon_psnr", "recon_ssim"}
    assert p["loss"] == pytest.approx(j["loss"], rel=1e-5)
    assert p["recon_psnr"] == pytest.approx(j["recon_psnr"], abs=1e-4)
    assert p["recon_ssim"] == pytest.approx(j["recon_ssim"], abs=1e-4)
    with open(tmp_path / "port" / "history.jsonl") as f:
        assert [json.loads(line) for line in f] == hist

    adam = jstate.opt_state[0]
    gj = {k: v / 0.1 for k, v in _flat(jax.device_get(adam.mu)).items()}
    gp = {k: v / 0.1 for k, v in _flat(state_dict_to_flax(trainer.net, trainer.optimizer.mu)).items()}
    pj, pp = _flat(jax.device_get(jstate.params)), _flat(trainer.params_tree())
    assert set(gj) == set(gp) == set(pj) == set(pp)
    lr = trainer.optimizer.schedule(0)
    for k, g in gj.items():
        scale = np.abs(g).max()
        np.testing.assert_allclose(gp[k], g, rtol=0, atol=1e-3 * scale + 1e-12, err_msg=f"grad {k}")
        moved = np.abs(pp[k] - pj[k])
        assert (moved <= 2 * lr * (1 + 1e-4 * np.abs(pj[k])) + 1e-6).all(), k
        clear = np.abs(g) > max(1e-5, 1e-2 * scale)
        assert (moved[clear] <= 1e-5 * (1 + np.abs(pj[k][clear]))).all(), f"param {k}"

    # each package's checkpoint in the other's Decomp
    with open(tmp_path / "port" / "model4_0.msgpack", "rb") as f:
        mine = serialization.msgpack_restore(f.read())
    jout = JaxDecomp("model4").apply({"params": mine}, np.zeros((1, 8, 8, 3), np.float32))
    assert all(np.isfinite(np.asarray(q)).all() for q in jout)
    for k, v in _flat(mine).items():
        np.testing.assert_array_equal(v, pp[k], err_msg=k)
    theirs = load_qd_net("model4", str(tmp_path / "jax" / "model4_0.msgpack"), "cpu")
    for k, v in _flat(state_dict_to_flax(theirs)).items():
        np.testing.assert_array_equal(v, pj[k], err_msg=k)


def test_evaluate_matches_bem_tpu(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    w = {}
    for i, (o, c, k) in enumerate(_ALEX):
        bound = 1 / np.sqrt(c * k * k)
        w[f"conv{i + 1}.kernel"] = rng.uniform(-bound, bound, (k, k, c, o)).astype(np.float32)
        w[f"conv{i + 1}.bias"] = rng.uniform(-bound, bound, o).astype(np.float32)
        w[f"lin{i}.kernel"] = (np.abs(rng.standard_normal((1, 1, o, 1))) / o).astype(np.float32)
    np.savez(tmp_path / "lpips.npz", **w)
    monkeypatch.setenv("BEM_LPIPS_WEIGHTS", str(tmp_path / "lpips.npz"))
    low, high = _write_pairs(tmp_path / "eval", 2, 64, 96, seed=6)
    args = ["--model_type", "model4", "--low_dir", low, "--high_dir", high, "--lpips",
            "--save_components"]
    want = jax_evaluate(args + ["--out_dir", str(tmp_path / "jax")])
    got = evaluate(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert set(got) == set(want) | {"lpips"}
    for k in ("psnr", "ssim", "rci"):
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    assert 0 < got["lpips"] and 0 <= got["rci"] <= 1
    for i in range(2):
        for tag in ("Q1", "Q2", "recon"):
            a = imread(str(tmp_path / "port" / f"{i}_{tag}.png"), float32=False).astype(int)
            b = imread(str(tmp_path / "jax" / f"{i}_{tag}.png"), float32=False).astype(int)
            assert a.shape == (64, 96, 3) and np.abs(a - b).max() <= 1, (i, tag)
    assert (tmp_path / "port" / "result.txt").read_text().startswith("PSNR: ")
