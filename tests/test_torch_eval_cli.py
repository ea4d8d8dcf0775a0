"""The port's eval CLI against bem_tpu's, end to end on the CPU.

Both ``main``s run on the tiny nets of tests/test_eval_cli.py (weights
saved by bem_tpu's ``save_params``, read by each side's own reader), with
``--deterministic`` and ``noise_level: 0``, on the same PNG files: the
full-reference path with ``--GT_mean --Monte_Carlo`` at 64x64 and NIQE at
128x128; the port's NIQE run with ``--save_candidates`` (every candidate
also copied to the host) against the run without, and NIQE at 64x64,
which the port refuses (no 96x96 block). Checked: the written images
within 1 LSB, PSNR within 1e-3 dB, SSIM within 1e-4, NIQE within 1e-3
relative, result.txt's lines, and the refusals of what the port leaves
out. Also: the port's eval, CLIP and LPIPS modules and chip_smoke.py
import none of jax, flax, bem_tpu, cv2, PIL, yaml, msgpack or
transformers. Selection among distinct candidates:
test_torch_eval_select.py.
"""

import os
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest

from bem_tpu.enhancement.eval import main as jax_main
from bem_tpu_torch.enhancement.eval import main

from test_eval_cli import CG_YML, IE_YML


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path here is thousands of small ops; next to the
    other workers of a parallel test run, intra-op threads only spin
    against each other (one file took 15x its time alone)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Inputs, targets, the tiny options (noise 0) and both nets' weights:
    seeded by the port, saved by bem_tpu's ``save_params``."""
    import torch

    from bem_tpu.utils.checkpoint import save_params
    from bem_tpu_torch.archs import build_network
    from bem_tpu_torch.convert import state_dict_to_flax

    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    for d in ("input", "target", "input128"):
        os.makedirs(root / d)
    for i in range(2):
        gt = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "target" / f"{i}.png"), gt)
        cv2.imwrite(str(root / "input" / f"{i}.png"), (gt * 0.3).astype(np.uint8))
        cv2.imwrite(str(root / "input128" / f"{i}.png"),
                    (rng.random((128, 128, 3)) * 80).astype(np.uint8))
    (root / "cg.yml").write_text(CG_YML.format().replace("noise_level: 0.1", "noise_level: 0"))
    (root / "ie.yml").write_text(IE_YML.format().replace("noise_level: 0.1", "noise_level: 0"))
    common = dict(type="Network", out_channels=3, n_feat=8, num_blocks=(1, 1), d_state=(1, 1),
                  ssm_ratio=1, mlp_ratio=2, use_pixelshuffle=True)
    for name, extra, seed in (("cg", dict(in_channels=3, bayesian=True), 0),
                              ("ie", dict(in_channels=6), 1)):
        net = build_network(dict(common, **extra), torch.Generator().manual_seed(seed))
        save_params(str(root / f"{name}.msgpack"), state_dict_to_flax(net))
    return root


def _args(root, out, inputs, extra):
    return ["--opt", str(root / "cg.yml"), "--cond_opt", str(root / "ie.yml"),
            "--weights", str(root / "cg.msgpack"), "--cond_weights", str(root / "ie.msgpack"),
            "--input_dir", str(root / inputs), "--result_dir", str(root / out),
            "--num_samples", "4", "--parallel_num", "2", "--deterministic"] + extra


def _both(root, name, inputs, extra):
    """Run bem_tpu's main and the port's on the same inputs; return both dicts."""
    want = jax_main(_args(root, f"{name}_jax", inputs, extra))
    got = main(_args(root, f"{name}_port", inputs, extra + ["--device", "cpu"]))
    for i in range(2):
        a = cv2.imread(str(root / f"{name}_jax" / "dataset" / f"{i}.png")).astype(int)
        b = cv2.imread(str(root / f"{name}_port" / "dataset" / f"{i}.png")).astype(int)
        assert np.abs(a - b).max() <= 1, f"{name} image {i}"
    return want, got


def _result_lines(path):
    return {k: float(v) for k, v in re.findall(r"(\w+): ([-\d.]+)", path.read_text())}


def test_full_reference_gt_mean_monte_carlo(env):
    want, got = _both(env, "ref", "input", ["--target_dir", str(env / "target"), "--GT_mean",
                                            "--Monte_Carlo"])
    assert got["psnr"] == pytest.approx(want["psnr"], abs=1e-3)
    assert got["ssim"] == pytest.approx(want["ssim"], abs=1e-4)
    assert got["selected"] == [0, 0] and len(got["scores"][0]) == 4
    lines_j = _result_lines(env / "ref_jax" / "dataset" / "result.txt")
    lines_p = _result_lines(env / "ref_port" / "dataset" / "result.txt")
    assert lines_p.keys() == lines_j.keys() >= {"Best_PSNR", "Best_SSIM", "MC_PSNR", "MC_SSIM"}
    for k, v in lines_j.items():
        assert lines_p[k] == pytest.approx(v, abs=1e-3 if "PSNR" in k else 2e-4), k


def test_niqe_selection(env):
    """NIQE selection against bem_tpu's on-device select; the port's run
    with --save_candidates (every candidate also copied to the host)
    against its run without, so against bem_tpu's too."""
    want, got = _both(env, "niqe", "input128", ["--no_ref", "niqe"])
    assert got["niqe"] == pytest.approx(want["niqe"], rel=1e-3)
    assert got["psnr"] is None and len(got["scores"][1]) == 4
    all_k = main(_args(env, "niqe_all_k", "input128", ["--no_ref", "niqe", "--save_candidates",
                                                      "--device", "cpu"]))
    assert all_k["niqe"] == pytest.approx(got["niqe"], rel=1e-6)
    np.testing.assert_allclose(all_k["scores"], got["scores"], rtol=1e-6)
    for i in range(2):
        a = cv2.imread(str(env / "niqe_all_k" / "dataset" / f"{i}.png"))
        b = cv2.imread(str(env / "niqe_port" / "dataset" / f"{i}.png"))
        np.testing.assert_array_equal(a, b)


def test_niqe_under_96_pixels_refused(env):
    """64x64 candidates hold no 96x96 NIQE block; the port says so (bem_tpu's
    host NIQE fails there inside numpy)."""
    with pytest.raises(ValueError, match="96x96 block"):
        main(_args(env, "small_port", "input", ["--no_ref", "niqe", "--device", "cpu"]))


def test_refusals(env):
    for extra, match in ((["--no_ref", "uiqm_uciqe"], "uiqm_uciqe"),
                         (["--shard_samples", "on"], "shard_samples on")):
        with pytest.raises(NotImplementedError, match=match):
            main(_args(env, "refused", "input", extra + ["--device", "cpu"]))
    with pytest.raises(ValueError, match="No input images"):
        main(_args(env, "refused", "missing", ["--device", "cpu"]))


def test_port_imports_nothing_it_must_not():
    code = ("import sys, bem_tpu_torch.enhancement.eval, bem_tpu_torch.enhancement.clip_iqa, "
            "bem_tpu_torch.enhancement.lpips, bem_tpu_torch.smoke, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'bem_tpu', "
            "'cv2', 'PIL', 'yaml', 'msgpack', 'transformers')]; assert not bad, bad")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
