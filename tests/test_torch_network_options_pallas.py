"""The ``Network`` options against bem_tpu's Pallas kernels (interpret
mode), and through a reference checkpoint.

- Every option at once (conv down / up sampling, a Bayesian FFNv02, SAM,
  relu last, drop-path with an injected keep mask), n_feat 8, blocks
  (1,1,1), 16x16, fp32: bem_tpu's blocks then take the NHWC route (no
  stream_cf, the unfused stem, the fused scan core and tail), the port's
  the same kernels' plain versions; within 2e-5 of max(1, |ref|)
  (measured 1e-6 to 5e-6 per option alone).
- One bf16 BasicBlock (C=16, an Mlp and a SAM) against bem_tpu's NHWC
  route, within 2e-2 of the output's largest entry.
- A reference-layout ``.pth`` of a Bayesian ``use_pixelshuffle: false``
  net: the port's converter gives bem_tpu's tree, and the loaded net runs
  as its source and as bem_tpu's converted net.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.archs import build_network as jax_build
from bem_tpu.archs import convert_network as jconv
from bem_tpu.archs.unet_arch import BasicBlock as JaxBasicBlock
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.archs.convert_network import convert_network_checkpoint
from bem_tpu_torch.archs.unet_arch import BasicBlock
from bem_tpu_torch.convert import load_flax_params, state_dict_to_flax
from bem_tpu_torch.nn import init
from bem_tpu_torch.smoke import reference_state, write_reference_checkpoint

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)
from test_torch_network_options import BASE, COMBINED, _check, _close, _flat, _x


def test_all_options_match_bem_tpu_pallas(monkeypatch):
    _check(COMBINED, "pallas", monkeypatch)


@pytest.fixture
def bf16_einsum():
    """bf16 einsums with an fp32 result run on fp32 casts of their operands
    (the CPU's XLA runtime has no bf16 x bf16 = f32 dot)."""
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


def test_bf16_block_matches_nhwc_route(bf16_einsum):
    """A bf16 BasicBlock with an Mlp and a SAM (C=16, 8x12), the port's
    channel-first block against bem_tpu's NHWC route (Pallas, interpret
    mode): within 2e-2 of the output's largest entry."""
    dim = 16
    block = init.initialize(BasicBlock(dim, 1, mlp_type="mlp", sam=True),
                            torch.Generator().manual_seed(dim))
    x = np.random.default_rng(dim).standard_normal((2, 8, 12, dim)).astype(np.float32)
    jb = JaxBasicBlock(dim=dim, num_blocks=1, mlp_type="mlp", sam=True, scan_backend="pallas")
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(block))
    want = jax.jit(lambda p, x: jb.apply({"params": p}, x))(params, jnp.asarray(x, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(want).max() >= 0.5
    _close(got.float().permute(0, 2, 3, 1).numpy(), want, 2e-2)


def test_reference_pth_without_pixel_shuffle(tmp_path):
    """A reference-layout ``ckpt.pth`` of a Bayesian ``use_pixelshuffle:
    false`` net: the port's converter gives bem_tpu's tree, and the net it
    loads runs as the source net and as bem_tpu's converted net."""
    cfg = dict(BASE, use_pixelshuffle=False, bayesian=True)
    src = build_network(cfg, torch.Generator().manual_seed(11))
    path = write_reference_checkpoint(str(tmp_path / "ckpt.pth"), src)
    tree = convert_network_checkpoint(path, num_blocks=(1, 1, 1), use_pixelshuffle=False)
    want_tree = jconv.convert_network_state(reference_state(state_dict_to_flax(src)),
                                            num_blocks=(1, 1, 1), use_pixelshuffle=False)
    assert _flat(tree) == _flat(want_tree)
    model = load_flax_params(build_network(cfg, torch.Generator().manual_seed(12)), tree)
    x = _x(3)
    with torch.no_grad():
        got = model(torch.from_numpy(x))[-1].numpy()
        assert np.array_equal(got, src(torch.from_numpy(x))[-1].numpy())
    net = jax_build(dict(cfg, scan_backend="xla"))
    want = jax.jit(lambda p, x: net.apply({"params": p}, x)[-1])(
        jax.tree_util.tree_map(jnp.asarray, want_tree), jnp.asarray(x))
    _close(got, np.asarray(want))
