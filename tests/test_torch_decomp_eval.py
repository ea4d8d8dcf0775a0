"""The eval CLI with the flagship as the image enhancer: bem_tpu's ``main``
against the port's on the CPU.

The IE options are test_eval_cli.py's tiny IE with ``network_g`` the
narrow flagship (DecompDualBranchDDWavelet, n_feat 8, blocks (1,1,1),
model4); its weights the port's seeded init with ``load_frozen``, saved
by bem_tpu's ``save_params`` and read by each side's own reader. The CG
is test_torch_eval_cli.py's tiny Bayesian net, its K=2 weight samples
a image injected into both CLIs as in test_torch_eval_select.py; two
128x128 inputs, ``--no_ref niqe``, noise 0. Checked per image: the
port's pick tops its own scores, apart from the other candidate by more
than twice the NIQE tolerance; the best image each side writes within 1
LSB; the mean NIQE within 1e-3 relative.
"""

import os

import numpy as np
import pytest
import torch

import bem_tpu.utils.img_util as jax_img_util
import bem_tpu_torch.enhancement.eval as port_eval
from bem_tpu.enhancement.eval import main as jax_main
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax

from test_eval_cli import IE_YML
from test_torch_decomp_archs import cfg
from test_torch_eval_cli import env, one_torch_thread  # noqa: F401  (fixtures)
from test_torch_eval_select import SCORE_TOL, _inject, _per_image, _record
from test_torch_cpu_setup import quick_compile  # noqa: F401  (module fixtures)

K, SEED, NIMG = 2, 4, 2
FLAGSHIP = ("{{type: DecompDualBranchDDWavelet, in_channels: 6, out_channels: 3, n_feat: 8, "
            "num_blocks: [1, 1, 1], d_state: [1, 1, 1], ssm_ratio: 1, mlp_ratio: 4, "
            "mlp_type: gdmlp, use_pixelshuffle: true, decomp_model: model4}}")


@pytest.fixture(scope="module")
def flagship_ie(env):  # noqa: F811
    from bem_tpu.utils.checkpoint import save_params

    text = IE_YML.format()
    head, _, rest = text.partition("network_g: ")
    tail = rest[rest.index("path:"):]
    (env / "flagship_ie.yml").write_text(
        (head + "network_g: " + FLAGSHIP.format() + "\n" + tail).replace(
            "noise_level: 0.1", "noise_level: 0"))
    net = build_network(cfg("DecompDualBranchDDWavelet"), torch.Generator().manual_seed(2))
    save_params(str(env / "flagship_ie.msgpack"), state_dict_to_flax(net.load_frozen()))
    return env


def _args(root, out):
    return ["--opt", str(root / "cg.yml"), "--cond_opt", str(root / "flagship_ie.yml"),
            "--weights", str(root / "cg.msgpack"),
            "--cond_weights", str(root / "flagship_ie.msgpack"),
            "--input_dir", str(root / "input128"), "--result_dir", str(root / out),
            "--num_samples", str(K), "--parallel_num", str(K), "--seed", str(SEED),
            "--no_ref", "niqe"]


def test_flagship_ie_eval_matches_bem_tpu(flagship_ie, monkeypatch):
    _inject(monkeypatch, K, NIMG, SEED)
    jw = _record(monkeypatch, jax_img_util, "imwrite", bgr=True)
    want = jax_main(_args(flagship_ie, "flagship_jax"))
    pw = _record(monkeypatch, port_eval, "imwrite", bgr=False)
    got = port_eval.main(_args(flagship_ie, "flagship_port") + ["--device", "cpu"])
    jimgs, pimgs = _per_image(jw), _per_image(pw)
    assert len(jimgs) == len(pimgs) == NIMG
    for i, ((jbest, _), (pbest, _)) in enumerate(zip(jimgs, pimgs)):
        scores = np.array(got["scores"][i])
        assert got["selected"][i] == int(np.argmax(scores))
        assert abs(scores[0] - scores[1]) > 2 * SCORE_TOL["niqe"], scores
        assert pbest.shape == (128, 128, 3)
        assert np.abs(pbest.astype(int) - jbest.astype(int)).max() <= 1, i
    assert got["niqe"] == pytest.approx(want["niqe"], rel=1e-3)
    assert os.path.exists(flagship_ie / "flagship_port" / "dataset" / "0.png")
