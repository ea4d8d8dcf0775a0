"""Slice parity: the port's ``Network`` vs bem_tpu's, same weights.

A small Network (n_feat 8, blocks (1,1,1), 32x48, fp32) built by bem_tpu,
its params loaded into the port, run against bem_tpu with the XLA scan
backend and with the Pallas kernels (interpret mode). Tolerance 1e-3, the
VSSBlock tolerance of test_ss2d_seq_tail.py. Also: a Bayesian weight
sample drawn by the port equals bem_tpu run on the same sample, and the
port's init draws from bem_tpu's distributions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from bem_tpu.archs import build_network as jax_build
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import (flax_to_state_dict, load_flax_params,
                                   state_dict_to_flax)
from bem_tpu_torch.nn import sample_bayes

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

CFG = dict(type="Network", in_channels=3, out_channels=3, n_feat=8,
           num_blocks=(1, 1, 1), d_state=1, ssm_ratio=1, mlp_ratio=4,
           mlp_type="gdmlp", use_pixelshuffle=True, bayesian=True)
B, H, W = 2, 32, 48


@pytest.fixture(scope="module")
def nets():
    x = np.random.default_rng(0).random((B, H, W, 3)).astype(np.float32)
    v = jax.jit(jax_build(dict(CFG, scan_backend="xla")).init)(
        jax.random.PRNGKey(0), jnp.asarray(x))
    return x, v, load_flax_params(build_network(CFG), jax.tree_util.tree_map(np.asarray, v))


def _apply(backend, variables, x):
    net = jax_build(dict(CFG, scan_backend=backend))
    return np.asarray(jax.jit(lambda v, x: net.apply(v, x)[-1])(variables, jnp.asarray(x)))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_network_matches_jax(nets, backend):
    x, v, m = nets
    y_ref = _apply(backend, v, x)
    with torch.no_grad():
        outs = m(torch.from_numpy(x))
    assert len(outs) == 2 and torch.equal(outs[0], torch.from_numpy(x))
    np.testing.assert_allclose(outs[-1].numpy(), y_ref, rtol=1e-3, atol=1e-3)


def test_bayesian_sample_matches_jax(nets):
    """The port draws one weight sample; bem_tpu run deterministically on
    the same sample (mu := the sampled weights) gives the same output."""
    x, v, m = nets
    sample = sample_bayes(m, torch.Generator().manual_seed(1))
    assert sample and all(k.rpartition(".")[2].startswith("mu_") for k in sample)
    with torch.no_grad():
        y = functional_call(m, sample, (torch.from_numpy(x),))[-1]
        y_mu = m(torch.from_numpy(x))[-1]
    y_ref = _apply("xla", {"params": state_dict_to_flax(m, sample)}, x)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-3, atol=1e-3)
    assert (y - y_mu).abs().max() > 1e-4


def test_init_matches_jax_distributions(nets):
    """Every parameter of the port's seeded init is drawn from the same
    distribution as bem_tpu's: equal constants, and for random leaves of
    256+ values, means and spreads within sampling noise."""
    _, v, _ = nets
    ref = dict(load_flax_params(build_network(CFG), v).named_parameters())
    port = dict(build_network(CFG, torch.Generator().manual_seed(3)).named_parameters())
    assert set(ref) == set(port)
    for name, p in port.items():
        r = ref[name].detach().double()
        p = p.detach().double()
        assert p.shape == r.shape, name
        if (r == r.flatten()[0]).all():  # a constant init
            assert torch.allclose(p, r, atol=1e-6), name
        elif r.numel() >= 256:
            assert abs(p.mean() - r.mean()) < 4 * r.std() / r.numel() ** 0.5 + 1e-6, name
            assert abs(p.std() / r.std() - 1) < 0.25, name
            assert p.abs().max() <= r.abs().max() * 1.5 + 1e-6, name


def test_converter_round_trip(nets):
    """flax -> state_dict -> flax is the identity on every leaf."""
    _, v, m = nets
    flat = _flat(v["params"])
    assert len(flax_to_state_dict(v)) == len(flat) == len(dict(m.named_parameters()))
    back = _flat(state_dict_to_flax(m))
    assert set(back) == set(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
