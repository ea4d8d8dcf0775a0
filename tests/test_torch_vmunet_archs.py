"""The VMUNet family (VMUNet, NaiveVMUNetTwoBranch, TunedModel,
FusedTunedModel): the port vs bem_tpu.

- The four archs at n_feat 8, blocks (1,1,1), 32x32, fp32, 6 input
  channels, ``last_act`` off and relu: the port's seeded init carried to
  bem_tpu by ``convert.state_dict_to_flax``, bem_tpu on its XLA scan
  backend: 1e-4. The port's tree has bem_tpu's names and shapes (from
  ``jax.eval_shape`` of its init).
- ``build_network`` takes each ``Options/TwoBranch_{1,2,3,4}.yml`` as
  shipped (full width, every key the files pass).
  TwoBranch_2 / _4 differ from _1 / _3 in their name alone, so the train
  steps of test_torch_vmunet_train.py cover all four files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.archs import build_network as jax_build
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.utils.options import parse

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

ARCHS = ("VMUNet", "NaiveVMUNetTwoBranch", "TunedModel", "FusedTunedModel")
SMALL = dict(in_channels=6, out_channels=3, n_feat=8, num_blocks=(1, 1, 1), d_state=[1, 1, 1],
             ssm_ratio=1, mlp_ratio=4, mlp_type="gdmlp", use_pixelshuffle=True, stage=1,
             drop_path=0.0, sam=False)
B, H, W = 2, 32, 32


def _flat_shapes(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): tuple(np.shape(a))
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).random((B, H, W, 6)).astype(np.float32)


@pytest.mark.parametrize("arch,last_act", [(a, None) for a in ARCHS] + [("TunedModel", "relu")])
def test_arch_matches_bem_tpu(x, arch, last_act):
    cfg = dict(SMALL, type=arch, last_act=last_act)
    m = build_network(cfg, torch.Generator().manual_seed(1))
    with torch.no_grad():
        outs = m(torch.from_numpy(x), torch.ones(B, H, W))
    net = jax_build(dict(cfg, scan_backend="xla"))
    tree = state_dict_to_flax(m)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 6)))["params"]
    assert _flat_shapes(tree) == _flat_shapes(shapes)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    want = jax.jit(lambda p, v: net.apply({"params": p}, v))(params, jnp.asarray(x))
    assert len(outs) == len(want) == 2
    np.testing.assert_array_equal(outs[0].numpy(), x)
    assert outs[-1].shape == (B, H, W, 3)
    np.testing.assert_allclose(outs[-1].numpy(), np.asarray(want[-1]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_option_files_build(n):
    opt = parse(f"Options/TwoBranch_{n}.yml", is_train=True)
    net = build_network(opt["network_g"])
    assert type(net).__name__ == ("TunedModel" if n <= 2 else "FusedTunedModel")
    assert net.n_feat == 40 and net.num_blocks == (2, 2, 2)
    assert hasattr(net, "fusion") and hasattr(net, "bottleneck_se2")
    assert hasattr(net, "cross_fusion_12") == (n > 2)


@pytest.mark.parametrize("n", [2, 4])
def test_option_files_differ_in_name_alone(n):
    a = parse(f"Options/TwoBranch_{n - 1}.yml", is_train=True)
    b = parse(f"Options/TwoBranch_{n}.yml", is_train=True)
    assert a["name"] != b["name"]
    strip = lambda o: {k: v for k, v in o.items() if k not in ("name", "path")}
    assert strip(a) == strip(b)
