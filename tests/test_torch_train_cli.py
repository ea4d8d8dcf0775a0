"""The port's train and test CLIs on the CPU, at tests/test_train_pipeline.py's
tiny options (n_feat 8, blocks (1,1,1), 24x32 PNGs, batch 2, 16x16 crops)
without its MIM mask, which the port does not take.

- ``train_pipeline`` for 4 iters: the files and log lines bem_tpu's own test
  and its CLI write (net_g_<iter>.msgpack, <iter>.state, best_psnr_*, the
  progress, checkpoint and validation lines), a finite PSNR / SSIM;
- ``--auto_resume`` with total_iter 6: it starts at iter 5 from the last
  state's params, bit for bit, at the learning rate an unbroken run has at
  iter 5, and ends at iter 6;
- ``test_pipeline`` on the last ``net_g`` gives the last validation's PSNR;
- resume at model level: save at step 2, load into a fresh trainer, one
  step with injected noise on the same batch, then one with the trainer's
  own draws: params bit-equal to the trainer that went on without the save;
- ``nondist_validation`` against bem_tpu's on the same weights and images
  (0.01 dB PSNR, 1e-4 SSIM, the images it writes within 1 LSB), IE and CG;
- ``--device cuda`` without a card fails at once; the CLIs import no JAX.

bem_tpu runs on its XLA scan backend here (no Pallas interpret mode).
"""

import glob
import os
import re
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from bem_tpu.data import build_dataloader as jax_build_dataloader
from bem_tpu.data import build_dataset as jax_build_dataset
from bem_tpu.models import build_model as jax_build_model
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.data import build_dataloader, build_dataset
from bem_tpu_torch.models import ImageEnhancer, build_model
from bem_tpu_torch.test import test_pipeline as run_test_pipeline
from bem_tpu_torch.train import train_pipeline
from bem_tpu_torch.utils.checkpoint import load_params
from bem_tpu_torch.utils.options import parse_options

from test_train_pipeline import make_yaml
from test_trainers import make_batch, make_opt

EXP = ("experiments", "debug_tiny")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lol(tmp_path_factory):
    """tests/test_train_pipeline.py's images, and a Big set (the CG's /4
    validation images must hold SSIM's 11x11 window)."""
    root = tmp_path_factory.mktemp("lol")
    rng = np.random.default_rng(0)
    for split, n, hw in (("Train", 4, (24, 32)), ("Test", 2, (24, 32)), ("Big", 2, (48, 60))):
        for kind in ("input", "target"):
            os.makedirs(root / split / kind)
        for i in range(n):
            gt = (rng.random((*hw, 3)) * 255).astype(np.uint8)
            cv2.imwrite(str(root / split / "target" / f"{i}.png"), gt)
            cv2.imwrite(str(root / split / "input" / f"{i}.png"), (gt * 0.3).astype(np.uint8))
    return root


def _yaml(lol, tmp, test=False):
    text = re.sub(r"    mim:\n(      .*\n)+", "", make_yaml(lol, tmp))
    if test:  # the test CLI's options: the val set only
        text = re.sub(r"  train:\n(    .*\n)+", "", text)
    path = tmp / ("test.yml" if test else "tiny.yml")
    path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def runs(lol, tmp_path_factory):
    """Train 4 iters, auto-resume to 6 (recording the first resumed step),
    then the test CLI on the last network file."""
    tmp = tmp_path_factory.mktemp("cli")
    yml = _yaml(lol, tmp)
    first = train_pipeline(str(tmp), ["--opt", yml, "--device", "cpu",
                                      "--force_yml", "train:total_iter=4"])
    logs = sorted(glob.glob(str(tmp.joinpath(*EXP, "train_*.log"))))
    first_log = open(logs[0]).read()
    seen = []
    orig = ImageEnhancer.train_step

    def record(self, batch, noise=None):
        if not seen:
            seen.append((self.step, {k: p.detach().clone() for k, p in self.params.items()}))
        out = orig(self, batch, noise)
        seen.append((self.step, float(out["lr"])))
        return out

    ImageEnhancer.train_step = record
    try:
        resumed = train_pipeline(str(tmp), ["--opt", yml, "--device", "cpu", "--auto_resume",
                                            "--force_yml", "train:total_iter=6"])
    finally:
        ImageEnhancer.train_step = orig
    net_g = max(glob.glob(str(tmp.joinpath(*EXP, "models", "net_g_*.msgpack"))),
                key=lambda p: int(re.search(r"net_g_(\d+)", p).group(1)))
    tested = run_test_pipeline(str(tmp), ["--opt", _yaml(lol, tmp, test=True), "--device", "cpu",
                                          "--force_yml", f"path:pretrain_network_g={net_g}"])
    return dict(tmp=tmp, first=first, first_log=first_log, seen=seen, resumed=resumed,
                tested=tested, net_g=net_g)


def test_train_cli_writes_bem_tpu_files(runs):
    first, exp = runs["first"], runs["tmp"].joinpath(*EXP)
    assert first.step == 4
    assert set(first.metric_results) == {"psnr", "ssim"}
    assert np.isfinite(list(first.metric_results.values())).all()
    # saves at save_checkpoint_freq 3 and after the loop (iter total + 1,
    # as bem_tpu names it); the resumed run adds 6 and 7
    assert {"net_g_3.msgpack", "net_g_5.msgpack"} <= set(os.listdir(exp / "models"))
    assert {"3.state", "5.state"} <= set(os.listdir(exp / "training_states"))
    assert glob.glob(str(exp / "best_psnr_*.msgpack")) and (exp / "tiny.yml").exists()
    log = runs["first_log"]
    for line in ("Training statistics:", "Number of train images: 4", "Total epochs: 2; iters: 4.",
                 "Number of val images in ValSet: 2", "Start training from epoch: 0, iter: 0",
                 "[debug..][epoch:  0, iter:       2, lr:(", "Saving models and training states.",
                 "Validation ValSet,\t\t # psnr: ", "\t # ssim: ", "New best PSNR",
                 "End of training. Time consumed:", "Save the latest model."):
        assert line in log, line
    assert len(re.findall(r"iter: +\d+, lr:", log)) == 2  # print_freq 2
    assert len(first.timings) == 4 and all(t[3] > 0 for t in first.timings)


def test_auto_resume_takes_up_the_last_state(runs):
    resumed, seen = runs["resumed"], runs["seen"]
    assert resumed.step == 6
    (step0, params0), (step1, lr1) = seen[0], seen[1]
    assert step0 == 4 and step1 == 5  # the first resumed step is iter 5
    want = state_dict_to_flax(resumed.net, {k: v for k, v in params0.items()})
    got = load_params(str(runs["tmp"].joinpath(*EXP, "models", "net_g_5.msgpack")))
    for path, leaf in _leaves(got).items():
        np.testing.assert_array_equal(_leaves(want)[path], leaf, err_msg=path)
    assert lr1 == resumed.lr_schedule(4)  # the 5th update's rate, not the 1st's
    log = open(sorted(glob.glob(str(runs["tmp"].joinpath(*EXP, "train_*.log"))))[-1]).read()
    assert "Resuming training from epoch: 2, iter: 4." in log


def test_test_cli_reproduces_last_validation(runs):
    got, want = runs["tested"].metric_results, runs["resumed"].metric_results
    assert got["psnr"] == want["psnr"] and got["ssim"] == want["ssim"]


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _trainer(model_type, tmp_path):
    opt = make_opt(model_type)
    opt["train"]["ema_decay"] = 0.5
    opt["path"] = {"experiments_root": str(tmp_path)}
    net_opt = dict(opt["network_g"])
    if model_type == "ConditionGenerator":
        net_opt.update(bayesian=True, sigma_init=0.05)
    return build_model(opt, device="cpu", net=build_network(net_opt,
                                                            torch.Generator().manual_seed(0)))


def _step(model, batch, seed):
    rng = np.random.default_rng(seed)
    if isinstance(model, ImageEnhancer):
        noise = rng.standard_normal(batch["gt_down"].shape).astype(np.float32)
        return model.train_step(batch, noise=torch.from_numpy(noise))
    eps = {k: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
           for k, p in model.params.items() if k.rpartition(".")[2].startswith("mu_")}
    return model.train_step(batch, eps=eps)


@pytest.mark.parametrize("model_type", ["ImageEnhancer", "ConditionGenerator"])
def test_resume_step_is_bit_identical(model_type, tmp_path):
    batch = make_batch(np.random.default_rng(0), H=32, W=32, down=4)
    ref = _trainer(model_type, tmp_path)
    for s in range(2):
        _step(ref, batch, s)
    ref.save(0, 2)
    fresh = _trainer(model_type, tmp_path)
    fresh.resume_training(str(tmp_path / "training_states" / "2.state"))
    for m in (ref, fresh):
        _step(m, batch, 7)
        m.train_step(batch)  # the trainer's own generator: restored with the state
    assert fresh.step == ref.step == 4
    for name in ("params", "ema_params"):
        for k, v in getattr(ref, name).items():
            assert torch.equal(getattr(fresh, name)[k], v), (name, k)
    for k in ref.params:
        assert torch.equal(fresh.optimizer.mu[k], ref.optimizer.mu[k]), k
        assert torch.equal(fresh.optimizer.nu[k], ref.optimizer.nu[k]), k
    for k, v in (ref.bayes_prior or {}).items():
        assert torch.equal(fresh.bayes_prior[k], v), k


@pytest.mark.parametrize("model_type", ["ImageEnhancer", "ConditionGenerator"])
def test_nondist_validation_matches_bem_tpu(model_type, lol, tmp_path):
    val = {"window_size": 8 if model_type == "ImageEnhancer" else 4,
           "metrics": {"psnr": {"type": "calculate_psnr", "crop_border": 0},
                       "ssim": {"type": "calculate_ssim", "crop_border": 0}}}
    ds = {"name": "ValSet", "type": "Dataset_PairedImage_Mask", "phase": "val",
          "dataroot_gt": str(lol / "Big" / "target"), "dataroot_lq": str(lol / "Big" / "input"),
          "io_backend": {"type": "disk"}, "model_type": model_type,
          "condition": {"type": "mean", "scale_down": 4}}
    pm = _trainer(model_type, tmp_path)
    _step(pm, make_batch(np.random.default_rng(0), H=32, W=32, down=4), 0)  # off the init
    pm.opt["val"] = val
    jopt = make_opt(model_type)
    jopt.update(val=val, is_train=False)
    jopt["network_g"]["scan_backend"] = "xla"
    jm = jax_build_model(jopt)
    params = jax.tree.map(np.array, state_dict_to_flax(pm.net, pm.ema_params))
    jm._init_variables = lambda rng, batch: {"params": params}
    jm.init_state(make_batch(np.random.default_rng(0), H=32, W=32, down=4), seed=0)
    jm.opt["path"]["visualization"] = str(tmp_path / "jax_vis")
    pm.opt["path"]["visualization"] = str(tmp_path / "port_vis")
    want_psnr = jm.nondist_validation(jax_build_dataloader(jax_build_dataset(dict(ds)), ds), 1,
                                      save_img=True)
    got_psnr = pm.nondist_validation(build_dataloader(build_dataset(dict(ds)), ds), 1,
                                     save_img=True)
    want, got = jm.metric_results, pm.metric_results
    assert got_psnr == got["psnr"] and want_psnr == want["psnr"]
    assert np.isfinite([got["psnr"], got["ssim"]]).all()
    assert abs(got["psnr"] - want["psnr"]) <= 0.01, (got, want)
    assert abs(got["ssim"] - want["ssim"]) <= 1e-4, (got, want)
    # the written images: the same files, the same colours (1 LSB)
    names = sorted(os.path.relpath(f, tmp_path / "jax_vis")
                   for f in glob.glob(str(tmp_path / "jax_vis" / "*" / "*.png")))
    assert names == sorted(os.path.relpath(f, tmp_path / "port_vis")
                           for f in glob.glob(str(tmp_path / "port_vis" / "*" / "*.png")))
    assert len(names) == (4 if model_type == "ImageEnhancer" else 2)
    for name in names:
        a, b = (cv2.imread(str(tmp_path / d / name)).astype(int) for d in ("jax_vis", "port_vis"))
        assert np.abs(a - b).max() <= 1, name


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the refusal where there is no card")
def test_device_cuda_without_a_card_fails(lol, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parse_options(str(tmp_path), args_list=["--opt", _yaml(lol, tmp_path)])


def test_clis_import_no_jax():
    code = ("import sys, bem_tpu_torch.train, bem_tpu_torch.test, bem_tpu_torch.data; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'bem_tpu', "
            "'cv2', 'yaml', 'msgpack')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
