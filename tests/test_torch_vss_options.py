"""VSSBlock and VSSM options: the port vs bem_tpu.

From the port's seeded weights carried to bem_tpu (``state_dict_to_flax``),
bem_tpu with scan_backend="pallas"; fp32 within 1e-5 of max(1, |ref|) per
block, 2e-5 for whole nets; gradients against jax.vjp within 1e-4 of each
leaf's largest entry:
- the windowed block (``grid_size`` 4 on a 6x7 map, so it pads bottom and
  right), ``post_norm``, both together, on the v05_noz core and on v2;
- ``use_checkpoint``: the same outputs and gradients with and without it,
  with fixed dropout and drop-path masks, and against bem_tpu's remat block;
- ``mlp_drop_rate`` accepted and ignored;
- the BEM block (gdMlp, folded into the kernels) with SSM dropout: its
  residual leaves the tail kernel, against bem_tpu's channel-first block
  with the same mask;
- (test_torch_vssm_options.py) VSSM with ``posembed``, SSM dropout and the
  v1 / v2 inits, ``BackboneVSSM``, and the classifier's config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.nn.vss import VSSBlock as JVSSBlock
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.nn import VSSBlock, init

from test_torch_cascade import close, grads_close, jparams, nhwc
from test_torch_train import _flat
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

BLOCK_KW = dict(ssm_d_state=4, ssm_ratio=2.0, mlp_ratio=2.0, mlp_type="mlp")


def port_block(seed=0, **kw):
    return init.initialize(VSSBlock(8, **dict(BLOCK_KW, **kw)), torch.Generator().manual_seed(seed))


def jax_block(**kw):
    return JVSSBlock(hidden_dim=8, scan_backend="pallas", **dict(BLOCK_KW, **kw))


def block_input(B=2, H=6, W=7, seed=3):
    return np.random.default_rng(seed).standard_normal((B, 8, H, W)).astype(np.float32)


def feed_masks(monkeypatch, masks):
    """bem_tpu's bernoulli draws return ``masks`` (channels-last numpy), in order."""
    queue = list(masks)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(queue.pop(0)).reshape(shape))


BLOCK_CASES = {
    "grid 4 pads": dict(grid_size=4, forward_type="v05_noz"),
    "post_norm": dict(post_norm=True, forward_type="v05_noz"),
    "grid post_norm v2": dict(grid_size=4, post_norm=True, forward_type="v2"),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_option_matches(case):
    kw = BLOCK_CASES[case]
    block = port_block(**kw)
    assert not block.fold
    x = block_input()
    want = jax.jit(jax_block(**kw).apply)({"params": jparams(block)}, jnp.asarray(nhwc(x)))
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    close(nhwc(got.numpy()), np.asarray(want), 1e-5)


def _masks(block, x, seed):
    """Fixed keep masks for the block's dropout and drop-paths."""
    return block.draw_masks(torch.from_numpy(x), torch.Generator().manual_seed(seed))


def _grads(block, x, masks, cot):
    xt = torch.from_numpy(x).requires_grad_()
    out = block(xt, masks=masks)
    params = [p for _, p in block.named_parameters()]
    g = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [xt] + params)
    names = [k for k, _ in block.named_parameters()]
    return out.detach(), {"x": nhwc(g[0].numpy()),
                          **_flat(state_dict_to_flax(block, dict(zip(names, g[1:]))))}


def test_use_checkpoint_same_outputs_and_grads(monkeypatch):
    kw = dict(grid_size=4, forward_type="v2", ssm_drop_rate=0.2, drop_path=0.3)
    x = block_input(seed=4)
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    plain = port_block(seed=1, **kw)
    ckpt = port_block(seed=1, use_checkpoint=True, **kw)
    masks = _masks(plain, x, 6)
    assert set(masks) == {"ssm", "path", "path2"} and masks["ssm"].shape == (2 * 2 * 2, 8, 4, 4)
    out_p, g_p = _grads(plain, x, masks, cot)
    out_c, g_c = _grads(ckpt, x, masks, cot)
    assert torch.equal(out_p, out_c)
    grads_close(g_c, g_p, 1e-6)
    # bem_tpu's remat block, its three bernoulli draws fed the same masks
    feed_masks(monkeypatch, [masks["ssm"].permute(0, 2, 3, 1).numpy(), masks["path"].numpy(),
                             masks["path2"].numpy()])
    jm = jax_block(use_checkpoint=True, **kw)
    rngs = {"dropout": jax.random.PRNGKey(0)}

    def fwd_bwd(p, v, c):
        out, vjp = jax.vjp(lambda p, v: jm.apply({"params": p}, v, rngs=rngs), p, v)
        return out, vjp(c)

    want, (jg_params, jg_x) = jax.jit(fwd_bwd)(jparams(plain), jnp.asarray(nhwc(x)),
                                               jnp.asarray(nhwc(cot)))
    close(nhwc(out_c.numpy()), np.asarray(want), 1e-5)
    grads_close(g_c, {"x": np.asarray(jg_x), **_flat(jg_params)})


def test_mlp_drop_rate_accepted_and_ignored():
    x = torch.from_numpy(block_input(seed=7))
    gen = lambda: torch.Generator().manual_seed(8)  # noqa: E731
    with torch.no_grad():
        a = port_block(seed=2, forward_type="v2")(x, gen())
        b = port_block(seed=2, forward_type="v2", mlp_drop_rate=0.5)(x, gen())
    assert torch.equal(a, b)


def test_folded_block_with_ssm_dropout(monkeypatch):
    kw = dict(ssm_d_state=1, ssm_ratio=1.0, mlp_ratio=2.0, mlp_type="gdmlp",
              forward_type="v05_noz", ssm_drop_rate=0.25)
    block = init.initialize(VSSBlock(8, **kw), torch.Generator().manual_seed(3))
    assert block.fold
    x = block_input(H=8, W=8, seed=9)
    keep = np.random.default_rng(10).random(x.shape) >= 0.25
    feed_masks(monkeypatch, [keep])
    jm = JVSSBlock(hidden_dim=8, scan_backend="pallas", layout="NCHW", **kw)
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v, rngs={"dropout": jax.random.PRNGKey(0)}))(
        jparams(block), jnp.asarray(x))
    with torch.no_grad():
        got = block(torch.from_numpy(x), masks={"ssm": torch.from_numpy(keep)})
        plain = block(torch.from_numpy(x))
    close(got.numpy(), np.asarray(want), 1e-5)
    assert not torch.allclose(got, plain)
