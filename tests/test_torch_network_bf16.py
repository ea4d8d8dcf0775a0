"""The bf16 serving stream at a level of C >= 128: the port vs bem_tpu.

bem_tpu runs the VSSBlocks of ``dim >= 128`` in NHWC
(bem_tpu/archs/unet_arch.py:142-151): there its stem is unfused (LN, then
in_proj, depthwise 3x3 and SiLU as separate ops) and its gdMlp is three
bf16 convs, each rounding its output to bf16 (bem_tpu/nn/vss.py:96-102).
The port runs its fused stem and gdMlp kernels at every level, so its
bf16 rounding points there differ. These tests measure by how much:

- a bf16 ``Network`` (n_feat 32, blocks (1,1,1): levels 32 / 64 / 128,
  fp32 params, 32x32) against bem_tpu's with ``scan_backend="pallas"``
  in interpret mode, whose ``stream_cf`` / ``blk_layout`` gates key on
  that backend (unet_arch.py:257-264), so the C=128 level takes the NHWC
  route;
- one ``BasicBlock`` at the serving bottleneck's C=160 and at C=128, the
  block alone, through bem_tpu's channel-first plumbing with the NHWC
  block layout that ``blk_layout`` picks there.

Weights: the port's seeded init carried to bem_tpu by
``convert.state_dict_to_flax``. Tolerance: 2e-2 of the output's largest
entry (the port's bf16 rule, smoke.TOL); every case's outputs are of
order 1. The CPU's XLA runtime has no bf16 x bf16 = f32 dot, which
bem_tpu's bf16 DualUpSample fold asks for (arch_util.py:175,
unet_arch.py:191); the fixture runs such an einsum on its operands cast to
fp32, the same products (exact in fp32) summed in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.archs import build_network as jax_build
from bem_tpu.archs.unet_arch import BasicBlock as JaxBasicBlock
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.archs.unet_arch import BasicBlock
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.nn import init

TOL = 2e-2
CFG = dict(type="Network", in_channels=3, out_channels=3, n_feat=32, num_blocks=(1, 1, 1),
           d_state=1, ssm_ratio=1, mlp_ratio=4, mlp_type="gdmlp", use_pixelshuffle=True,
           bayesian=False)


@pytest.fixture(autouse=True, scope="module")
def _bf16_einsum():
    """bf16 einsums with an fp32 result run on fp32 casts of their operands;
    the jitted interpret-mode traces are dropped when the module ends."""
    orig = jnp.einsum

    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32 and any(
                getattr(o, "dtype", None) == jnp.bfloat16 for o in ops):
            ops = [o.astype(jnp.float32) for o in ops]
        return orig(spec, *ops, preferred_element_type=preferred_element_type, **kw)

    jnp.einsum = einsum
    yield
    jnp.einsum = orig
    jax.clear_caches()


def _close(got: torch.Tensor, want: np.ndarray):
    got = got.float().numpy()
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert scale >= 0.5, scale  # outputs of order 1
    assert err <= TOL * scale, (err, scale)


def test_network_bf16_matches_bem_tpu():
    """The whole bf16 Network, one level at C=128: output within 2e-2 of
    its largest entry (measured 5.9e-3 of 1.02: one bf16 ulp at the
    output's scale)."""
    model = build_network(CFG, torch.Generator().manual_seed(3))
    x = np.random.default_rng(0).random((1, 32, 32, 3)).astype(np.float32)
    net = jax_build(dict(CFG, scan_backend="pallas"))
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(model))
    want = jax.jit(lambda p, x: net.apply({"params": p}, x)[-1])(
        params, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(torch.bfloat16))[-1]
    assert got.dtype == torch.bfloat16 and got.shape == (1, 32, 32, 3)
    _close(got, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dim,hw", [(160, (8, 12)), (128, (10, 8))])
def test_wide_block_bf16_matches_nhwc_route(dim, hw):
    """One VSSBlock at C >= 128 on the bf16 stream: the port's fused stem
    and gdMlp against bem_tpu's NHWC route (unfused stem, three bf16 gdMlp
    convs), the block's input a bf16 map of order 1 (measured 0.03125 of
    4.7 at both widths: one bf16 ulp at the output's scale)."""
    H, W = hw
    block = init.initialize(BasicBlock(dim, 1), torch.Generator().manual_seed(dim))
    x = np.random.default_rng(dim).standard_normal((2, dim, H, W)).astype(np.float32)
    jb = JaxBasicBlock(dim=dim, num_blocks=1, scan_backend="pallas", layout="NCHW",
                       block_layout="NHWC")
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(block))
    want = jax.jit(lambda p, x: jb.apply({"params": p}, x))(params, jnp.asarray(x, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = block(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)))
