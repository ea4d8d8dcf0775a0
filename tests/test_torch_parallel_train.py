"""Data-parallel training: the port's trainers on 4 gloo ranks against
bem_tpu's one-device step (tests/test_parallel.py's options: n_feat 8,
blocks (1, 1), a global batch of 8, 8x8 with the condition at 2x2).

Each rank takes its slice of 2 images (``parallel.shard_batch``), the
gradients are averaged over the ranks before the clip and AdamW. Both
sides start from the port's seeded weights (converted for bem_tpu).

- One IE step: every parameter within bem_tpu's own bound for its
  8-way-sharded step against one device, 2e-5 relative + 2e-6.
- One CG step with the weight noise injected into both (bem_tpu's
  ``_bayes_weight`` reads it, as in test_torch_train.py): the same bound.
- The train CLI under ``--launcher pytorch`` on the 4 ranks.
- The draws bem_tpu makes once for the global batch: an IE step with
  mixup and condition noise on 4 ranks against the port's one-process
  step under the same seed (the noise drawn for the global batch and
  sliced, mixup's partner rows on the mirror rank): 2e-6; the logged
  losses are the global batch's.
"""

import copy
import glob
import os
import re
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bem_tpu.nn.layers as jlayers
from bem_tpu.models import build_model as jax_build_model
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.models import build_model
from bem_tpu_torch.parallel import spawn
from bem_tpu_torch.utils.img_util import imwrite

import torch_parallel_workers as workers
from test_train_pipeline import make_yaml
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

N = 4


def dp_opt(model_type):
    """tests/test_parallel.py's options, for either trainer."""
    return {
        "name": "dp", "model_type": model_type, "is_train": True, "manual_seed": 0,
        "condition": {"type": "mean", "scale_down": 4, "noise_level": 0.0},
        "network_g": {"type": "Network", "in_channels": 6 if model_type == "ImageEnhancer" else 3,
                      "out_channels": 3, "n_feat": 8, "num_blocks": [1, 1], "d_state": [1, 1],
                      "ssm_ratio": 1, "mlp_ratio": 2, "use_pixelshuffle": True},
        "datasets": {"train": {"mini_batch_sizes": [8]}},
        "path": {"experiments_root": "unused"},
        "train": {"total_iter": 2, "warmup_iter": -1, "max_grad_norm": 1,
                  "optim_g": {"type": "AdamW", "lr": 1e-3, "weight_decay": 0.0,
                              "betas": [0.9, 0.999]},
                  "mixing_augs": {"mixup": False},
                  "pixel_opt": {"type": "L1Loss", "loss_weight": 1, "reduction": "mean"}},
        "val": {},
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _port_net(opt):
    net_opt = dict(opt["network_g"])
    if opt["model_type"] == "ConditionGenerator":
        net_opt.update(bayesian=True, sigma_init=0.05)
    return build_network(net_opt, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    batch = {k: rng.random((8,) + s).astype(np.float32)
             for k, s in (("lq", (8, 8, 3)), ("gt", (8, 8, 3)), ("lq_down", (2, 2, 3)),
                          ("gt_down", (2, 2, 3)))}
    opts = {m: dp_opt(m) for m in ("ImageEnhancer", "ConditionGenerator")}
    cg = _port_net(opts["ConditionGenerator"])
    eps = {k: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
           for k, p in cg.named_parameters() if k.rpartition(".")[2].startswith("mu_")}
    mixed = dp_opt("ImageEnhancer")
    mixed["condition"]["noise_level"] = 0.1
    mixed["train"]["mixing_augs"] = {"mixup": True, "mixup_beta": 1.2}
    mixed_batch = dict(batch, lq=rng.random((8, 8, 8, 3)).astype(np.float32))
    lol = tmp_path_factory.mktemp("lol")
    for kind in ("input", "target"):
        os.makedirs(lol / "Train" / kind)
        os.makedirs(lol / "Test" / kind)
    for split, n in (("Train", 2 * N), ("Test", 1)):
        for i in range(n):
            gt = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
            imwrite(gt, str(lol / split / "target" / f"{i}.png"))
            imwrite((gt * 0.3).astype(np.uint8), str(lol / split / "input" / f"{i}.png"))
    tmp = tmp_path_factory.mktemp("cli")
    yml = tmp / "tiny.yml"
    yml.write_text(re.sub(r"    mim:\n(      .*\n)+", "", make_yaml(lol, tmp)))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    res = spawn(workers.train_steps, N, args=(opts, batch, eps, mixed, mixed_batch,
                                              (str(tmp), str(yml), port)))
    return batch, opts, eps, mixed, mixed_batch, res, tmp


def _bem_tpu_step(opt, batch):
    params0 = state_dict_to_flax(_port_net(opt))
    jm = jax_build_model(copy.deepcopy(opt))
    jm._init_variables = lambda rng, batch: {"params": params0}
    jm.init_state(batch, seed=0)
    jm.train_step(batch)
    return _flat(jm.state.params)


def _check(res, key, want, rtol, atol):
    for r, out in enumerate(res):
        got = _flat(out[key])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                       err_msg=f"rank {r} {key} {k}")


def test_ie_step_on_4_ranks_matches_bem_tpu(ranks):
    batch, opts, _, _, _, res, _ = ranks
    _check(res, "ie", _bem_tpu_step(opts["ImageEnhancer"], batch), 2e-5, 2e-6)


def test_cg_step_on_4_ranks_matches_bem_tpu(ranks, monkeypatch):
    batch, opts, eps, _, _, res, _ = ranks
    eps_tree = state_dict_to_flax(_port_net(opts["ConditionGenerator"]), eps)

    def bayes_weight(self, name, init_fn, shape, sigma_init):
        mu = self.param(f"mu_{name}", init_fn, shape)
        rho = self.param(f"rho_{name}", jlayers.inits.constant(
            jlayers.rho_from_sigma(sigma_init)), shape)
        if not self.has_rng("bayes"):
            return mu
        node = eps_tree
        for part in self.scope.path:
            node = node[part]
        return mu + jlayers.softplus_sigma(rho) * jnp.asarray(node[f"mu_{name}"])

    monkeypatch.setattr(jlayers._BayesParamMixin, "_bayes_weight", bayes_weight)
    _check(res, "cg", _bem_tpu_step(opts["ConditionGenerator"], batch), 2e-5, 2e-6)


def test_global_draws_match_one_process(ranks):
    _, _, _, mixed, mixed_batch, res, _ = ranks
    model = build_model(copy.deepcopy(mixed), device="cpu", net=_port_net(mixed))
    logs = model.train_step(mixed_batch)
    _check(res, "mixed", _flat(state_dict_to_flax(model.net)), 0, 2e-6)
    for out in res:  # the logged losses: the global batch's, on every rank
        for k in ("l_pix", "l_total", "grad_norm", "lr"):
            assert out["mixed_logs"][k] == pytest.approx(float(logs[k]), rel=1e-5), k


def test_train_cli_under_launcher_pytorch(ranks):
    """The train CLI under ``--launcher pytorch`` (tests/test_train_pipeline.py's
    tiny options without the mask, 2 images a rank a step, 2 iters): every
    rank is its own rank of a world of 4 and ends with the same parameters;
    rank 0 alone wrote the experiment's files and its one log."""
    res, tmp = ranks[5], ranks[6]
    assert [(r["cli_rank"], r["cli_world"], r["cli_step"]) for r in res] == [
        (r, N, 2) for r in range(N)]
    want = _flat(res[0]["cli_params"])
    for out in res[1:]:
        got = _flat(out["cli_params"])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    exp = tmp / "experiments" / "debug_tiny"
    assert len(glob.glob(str(exp / "train_*.log"))) == 1
    log = open(glob.glob(str(exp / "train_*.log"))[0]).read()
    assert "World size: 4" in log and "Batch size per gpu: 2" in log
    assert {"net_g_3.msgpack"} <= set(os.listdir(exp / "models"))
