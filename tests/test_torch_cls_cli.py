"""``python -m bem_tpu_torch.classification.train`` (``main``) on a tiny
ImageFolder tree on the CPU, a narrow VSSM (embed 16, depths (1, 1),
d_state 4, IMG_SIZE 32, 10 classes) from a ``--cfg`` file:

- train mode, one epoch of two steps (``TRAIN.WARMUP_EPOCHS 0``): finite
  loss, the parameters moved, step and data times recorded; with the
  default warm-up of 20 epochs the schedule refuses, as optax does;
- ``--eval``: the port's top-1 / top-5 equal bem_tpu's ``validate`` over
  bem_tpu's loader, with the port's seeded weights carried over by
  ``state_dict_to_flax`` (bem_tpu's model on its XLA backend);
- ``--throughput``: images/s > 0;
- the default device (``cuda``) raises at once without a card;
- this slice's modules import nothing of JAX, bem_tpu, cv2 or PyYAML.
"""

import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bem_tpu.classification.train as bem_train
from bem_tpu.classification.data import build_loader as bem_build_loader
from bem_tpu_torch.classification import build_model_from_config
from bem_tpu_torch.classification.train import main, parse_option
from bem_tpu_torch.convert import state_dict_to_flax

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

CFG = """MODEL:
  NUM_CLASSES: 10
  DROP_PATH_RATE: 0.0
  VSSM:
    EMBED_DIM: 16
    DEPTHS: [1, 1]
    SSM_D_STATE: 4
    SSM_RATIO: 1.0
DATA:
  IMG_SIZE: 32
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cls_cli")
    (root / "narrow.yaml").write_text(CFG)
    rng = np.random.default_rng(0)
    exts = (".png", ".jpg", ".bmp", ".JPEG")
    for split, n in (("train", 2), ("val", 2)):
        for c in range(10):
            d = root / "tree" / split / f"n{c:02d}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = 36 + 3 * c, 44 + 5 * i
                img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                                       (5, 5), 0)
                cv2.imwrite(str(d / f"{i}{exts[(c + i) % 4]}"), img)
    return ["--cfg", str(root / "narrow.yaml"), "--data-path", str(root / "tree"),
            "--batch-size", "8", "--device", "cpu"]


def test_train_mode(setup):
    args = setup + ["--opts", "TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0"]
    _, cfg = parse_option(args)
    before = {k: v.detach().clone() for k, v in build_model_from_config(
        cfg, torch.Generator().manual_seed(cfg.SEED)).named_parameters()}
    state = main(args)
    assert state.step == 2  # 20 images, batch 8, drop_last
    assert np.isfinite(float(state.logs["grad_norm"])) and state.logs["lr"] > 0
    assert len(state.timing["step_time"]) == len(state.timing["data_time"]) == 2
    moved = sum(not torch.equal(before[k], p.detach())
                for k, p in state.model.named_parameters())
    assert moved > len(before) // 2
    with pytest.raises(ValueError, match="decay_steps > warmup_steps"):
        main(setup + ["--opts", "TRAIN.EPOCHS", "1"])


def test_eval_mode_matches_bem_tpu(setup):
    t1, t5 = main(setup + ["--eval"])
    _, cfg = bem_train.parse_option([a for a in setup if a not in ("--device", "cpu")]
                                    + ["--eval"])
    _, _, _, loader_val, _ = bem_build_loader(cfg)
    model = build_model_from_config(parse_option(setup)[1], torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(model))
    example = np.zeros((1, 32, 32, 3), np.float32)
    _, _, eval_step = bem_train.make_trainer(bem_train.build_model_from_config(cfg), example,
                                             total_steps=10)
    want = bem_train.validate(params, eval_step, loader_val)
    assert (t1, t5) == pytest.approx(want, abs=1e-7)
    assert 0 <= t1 <= t5 <= 1 and t5 > 0


def test_throughput_mode(setup):
    assert main(setup + ["--throughput", "--batch-size", "2"]) > 0


def test_default_device_needs_a_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([a for a in setup if a not in ("--device", "cpu")] + ["--eval"])


def test_new_modules_import_nothing_they_must_not():
    code = ("import sys, bem_tpu_torch.classification.train, bem_tpu_torch.classification.data, "
            "bem_tpu_torch.data.degradations, bem_tpu_torch.data.realesrgan_dataset, "
            "bem_tpu_torch.data.realesrgan_paired_dataset, bem_tpu_torch.utils.diffjpeg, "
            "bem_tpu_torch.utils.img_process_util, bem_tpu_torch.utils.cv_ops, "
            "bem_tpu_torch.data.video_datasets, bem_tpu_torch.utils.flow_util, "
            "bem_tpu_torch.utils.webp_codec, bem_tpu_torch.utils.webp_tables, "
            "bem_tpu_torch.ops.legacy, bem_tpu_torch.archs.arch_util, "
            "bem_tpu_torch.enhancement.export, bem_tpu_torch.tools.export_onchip, "
            "bem_tpu_torch.tools.op_dispatch_ab, "
            "bem_tpu_torch.native, bem_tpu_torch.utils.histogram, bem_tpu_torch.utils.hog, "
            "bem_tpu_torch.utils.noise_cal, bem_tpu_torch.utils.matlab_functions, "
            "bem_tpu_torch.metrics.fid, bem_tpu_torch.parallel, bem_tpu_torch.parallel.mesh, "
            "bem_tpu_torch.parallel.context, bem_tpu_torch.parallel.spatial, "
            "bem_tpu_torch.utils.profiler, bem_tpu_torch.utils.plot_util, "
            "bem_tpu_torch.analysis.plot; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', "
            "'bem_tpu', 'cv2', 'yaml', 'PIL')]; assert not bad, bad")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
