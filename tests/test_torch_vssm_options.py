"""VSSM options, BackboneVSSM and the classifier's config: the port vs bem_tpu.

From the port's seeded weights carried to bem_tpu (``state_dict_to_flax``),
bem_tpu with scan_backend="pallas"; whole nets within 2e-5 of max(1,
|ref|):
- VSSM (embed 16, depths (1, 1), 32x32, B=2) with ``posembed``, SSM
  dropout (the same keep masks injected into both) and the v1 / v2 inits,
  on the cascade (v052dc) and the fused serving core (v05_noz):
  parameter trees equal to bem_tpu's init (names and shapes), the
  position embedding's trunc-normal scale, the logits;
- ``BackboneVSSM``: its parameter tree (the out-norms, no head and no
  position embedding even with ``posembed``) and its two feature maps;
- ``build_model_from_config`` on the settings the port used to refuse
  (SSM / MLP dropout, SSM_INIT v1 / v2, POSEMBED, forward types v052dc
  and m0): the same parameter tree as bem_tpu's model from that config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.classification.config import get_config as jax_get_config
from bem_tpu.classification.train import build_model_from_config as jax_build
from bem_tpu.nn.vssm import VSSM as JVSSM
from bem_tpu.nn.vssm import BackboneVSSM as JBackboneVSSM
from bem_tpu_torch.classification import build_model_from_config, get_config
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.nn import VSSM, BackboneVSSM, init

from test_torch_cascade import close, jparams
from test_torch_train import _flat
from test_torch_vss_options import feed_masks
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

NET_KW = dict(depths=(1, 1), dims=16, num_classes=5, ssm_d_state=4, drop_path_rate=0.0,
              patchembed_version="v2", downsample_version="v3", imgsize=32)


def images(seed):
    return np.random.default_rng(seed).random((2, 32, 32, 3)).astype(np.float32)


def _tree(jm, x):
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return {k: v.shape for k, v in _flat(jax.tree_util.tree_map(lambda s: np.zeros(s.shape),
                                                                 shapes)).items()}


@pytest.mark.parametrize("ssm_init,ftype", [("v1", "v052dc"), ("v2", "v05_noz")])
def test_vssm_posembed_dropout_inits(ssm_init, ftype, monkeypatch):
    kw = dict(NET_KW, posembed=True, ssm_drop_rate=0.2, ssm_init=ssm_init, forward_type=ftype)
    model = init.initialize(VSSM(**kw), torch.Generator().manual_seed(4))
    assert model.pos_embed.shape == (1, 16, 8, 8) and 0.01 < model.pos_embed.std() < 0.03
    x = images(11)
    jm = JVSSM(scan_backend="pallas", **kw)
    assert {k: v.shape for k, v in _flat(state_dict_to_flax(model)).items()} == _tree(jm, x)
    masks = {f"layer{i}_block0": model.get_submodule(f"layer{i}_block0").draw_masks(
        torch.zeros(2, 16 * 2 ** i, 8 // 2 ** i, 8 // 2 ** i), torch.Generator().manual_seed(i))
        for i in range(2)}
    feed_masks(monkeypatch, [masks[f"layer{i}_block0"]["ssm"].permute(0, 2, 3, 1).numpy()
                             for i in range(2)])
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v, rngs={"dropout": jax.random.PRNGKey(0)}))(
        jparams(model), jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x), masks=masks)
    close(got.numpy(), np.asarray(want), 2e-5)


def test_backbone_outputs_match():
    kw = dict(NET_KW, out_indices=(0, 1), posembed=True, forward_type="v052dc")
    kw.pop("num_classes")
    model = init.initialize(BackboneVSSM(**kw), torch.Generator().manual_seed(5))
    assert not hasattr(model, "pos_embed") and not hasattr(model, "head")
    x = images(12)
    jm = JBackboneVSSM(scan_backend="pallas", **kw)
    assert {k: v.shape for k, v in _flat(state_dict_to_flax(model)).items()} == _tree(jm, x)
    want = jax.jit(jm.apply)({"params": jparams(model)}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g.numpy(), np.asarray(w), 2e-5)


@pytest.mark.parametrize("opts", [["SSM_DROP_RATE", "0.1", "MLP_DROP_RATE", "0.1"],
                                  ["SSM_INIT", "v1", "POSEMBED", "true"],
                                  ["SSM_INIT", "v2", "SSM_FORWARDTYPE", "v052dc"],
                                  ["SSM_FORWARDTYPE", "m0_noz"]])
def test_config_settings_build_as_bem_tpu(opts):
    cfgs = []
    for get in (get_config, jax_get_config):
        c = get()
        v = c.MODEL.VSSM
        v.EMBED_DIM, v.DEPTHS, v.SSM_D_STATE = 16, [1, 1], 4
        c.DATA.IMG_SIZE, c.MODEL.NUM_CLASSES = 32, 5
        c.merge_from_list([f"MODEL.VSSM.{k}" if i % 2 == 0 else k for i, k in enumerate(opts)])
        cfgs.append(c)
    model = build_model_from_config(cfgs[0], torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in _flat(state_dict_to_flax(model)).items()} == _tree(
        jax_build(cfgs[1]), images(0))
