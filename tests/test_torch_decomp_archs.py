"""The Decomp family (the BEM flagship archs): the port vs bem_tpu.

- All six archs at n_feat 8, blocks (1,1,1), d_state 1, mlp_ratio 4,
  gdMlp, 16x24 inputs of 6 channels, fp32, with ``decomp_model`` model4
  (model1 for DecompDualBranch, the other decomposition form): the port's
  seeded init with ``load_frozen`` carried to bem_tpu by
  ``convert.state_dict_to_flax``, bem_tpu on its XLA scan backend
  (jitted; XLA's optimizations off, test_torch_cpu_setup.py): 1e-3, the tolerance
  of test_torch_network.py. bem_tpu's VSSLevels run channels-last with
  the stem and gdMlp as plain ops; the port runs its folded kernels'
  plain versions.
- The converter: the port's tree has bem_tpu's names and shapes (from
  ``jax.eval_shape`` of its init) and flax -> state_dict -> flax is the
  identity, the transposed convs, model2's ``conv1_kernel`` and the
  cross-fusion ``gate`` included.
- ``load_frozen`` puts the shipped checkpoint into ``decomp`` (the
  wavelet arch has no PostSmooth to take), and one ImageEnhancer train
  step leaves ``decomp`` bit-identical and moves the rest
  (tests/test_decomp_archs.py's check).
The flagship on bem_tpu's Pallas kernels: test_torch_decomp_pallas.py;
the eval CLI with the flagship as the IE: test_torch_decomp_eval.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.archs import build_network as jax_build
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from bem_tpu_torch.models import build_model
from bem_tpu_torch.qd import load_decomp_params

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

ARCHS = ("DecompSingleBranch", "DecompSingleBranchDD", "DecompDualBranch",
         "DecompDualBranch2", "DecompDualBranch2DD", "DecompDualBranchDDWavelet")
SMALL = dict(in_channels=6, out_channels=3, n_feat=8, num_blocks=(1, 1, 1), d_state=1,
             ssm_ratio=1, mlp_ratio=4, mlp_type="gdmlp", use_pixelshuffle=True)
B, H, W = 2, 16, 24


def cfg(arch):
    return dict(SMALL, type=arch,
                decomp_model="model1" if arch == "DecompDualBranch" else "model4")


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).random((B, H, W, 6)).astype(np.float32)


def _port(arch, seed=1):
    return build_network(cfg(arch), torch.Generator().manual_seed(seed)).load_frozen()


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_matches_bem_tpu(x, arch):
    m = _port(arch)
    with torch.no_grad():
        outs = m(torch.from_numpy(x))
    net = jax_build(dict(cfg(arch), scan_backend="xla"))
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(m))
    want = jax.jit(lambda p, v: net.apply({"params": p}, v))(params, jnp.asarray(x))
    assert len(outs) == len(want) == 2
    np.testing.assert_array_equal(outs[0].numpy(), np.asarray(want[0]))
    assert outs[-1].shape == (B, H, W, 3)
    np.testing.assert_allclose(outs[-1].numpy(), np.asarray(want[-1]), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_round_trip(x, arch):
    """The port's tree is bem_tpu's (names, shapes), and flax -> state_dict ->
    flax is the identity."""
    m = _port(arch)
    tree = state_dict_to_flax(m)
    shapes = jax.eval_shape(jax_build(dict(cfg(arch), scan_backend="xla")).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, H, W, 6)))["params"]
    ref = {"/".join(str(getattr(p, "key", p)) for p in path): tuple(v.shape)
           for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    flat = _flat(tree)
    assert {k: v.shape for k, v in flat.items()} == ref
    sd = flax_to_state_dict(tree)
    assert set(sd) == set(dict(m.named_parameters()))
    for k, p in m.named_parameters():
        np.testing.assert_array_equal(sd[k], p.detach().numpy(), err_msg=k)
    m2 = build_network(cfg(arch), torch.Generator().manual_seed(7))
    m2.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    back = _flat(state_dict_to_flax(m2))
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


def test_load_frozen_takes_the_checkpoint():
    """Every decomp parameter is the checkpoint's; the wavelet arch declares
    no PostSmooth, model4's other archs do."""
    ckpt = _flat(load_decomp_params("model4"))
    for arch, smooth in (("DecompDualBranchDDWavelet", False), ("DecompDualBranch2DD", True)):
        tree = _flat(state_dict_to_flax(_port(arch))["decomp"])
        assert any(k.startswith("smooth_q1") for k in tree) == smooth
        assert set(tree) == {k for k in ckpt if smooth or not k.startswith("smooth")}
        for k, a in tree.items():
            np.testing.assert_array_equal(a, ckpt[k], err_msg=k)


def test_train_step_keeps_decomp_frozen():
    """The trainer loads the frozen decomposition when it builds the net; two
    ImageEnhancer steps leave it bit-identical, move the branches, and
    AdamW's weight decay does not touch it."""
    opt = {"name": "t", "model_type": "ImageEnhancer", "is_train": True, "manual_seed": 0,
           "condition": {"type": "mean", "scale_down": 4, "noise_level": 0.1},
           "network_g": cfg("DecompDualBranchDDWavelet"),
           "train": {"total_iter": 4, "warmup_iter": -1, "max_grad_norm": 1,
                     "optim_g": {"type": "AdamW", "lr": 1e-3, "weight_decay": 1e-2,
                                 "betas": [0.9, 0.999]},
                     "mixing_augs": {"mixup": False},
                     "pixel_opt": {"type": "L1Loss", "loss_weight": 1, "reduction": "mean"}},
           "val": {}}
    model = build_model(opt, device="cpu")
    ckpt = _flat(load_decomp_params("model4"))
    tree = _flat(state_dict_to_flax(model.net)["decomp"])
    for k, a in tree.items():
        np.testing.assert_array_equal(a, ckpt[k], err_msg=k)
    before = {k: p.detach().clone() for k, p in model.params.items()}
    rng = np.random.default_rng(5)
    batch = {"lq": rng.random((2, 16, 16, 3), np.float32),
             "gt": rng.random((2, 16, 16, 3), np.float32),
             "gt_down": rng.random((2, 4, 4, 3), np.float32)}
    for _ in range(2):
        logs = model.train_step(batch)
    assert np.isfinite(float(logs["l_total"])) and float(logs["grad_norm"]) > 0
    frozen = [k for k in before if k.startswith("decomp.")]
    assert frozen and set(frozen) == model.optimizer.frozen
    for k in frozen:
        assert torch.equal(model.params[k], before[k]), k
    moved = [k for k in before if not k.startswith("decomp.")
             and not torch.equal(model.params[k], before[k])]
    assert len(moved) == len(before) - len(frozen)
